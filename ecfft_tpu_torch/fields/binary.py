"""GF(2^m) as a host field object over python ints.

A jax-free copy of ``ecfft_tpu/fields/binary.py`` (every class and
function has its original's source, tested): a polynomial-basis GF(2^m)
whose elements are python ints (bit i the coefficient of x^i) modulo an
irreducible degree-m polynomial, with the trace and the quadratic solver
the even-characteristic curve layer (``ec/binary.py``) needs. The
reference declares an even-characteristic good curve
(reference/src/ec.rs:28-35) but never instantiates a binary field; this
module does, host-side only.
"""

from __future__ import annotations

from dataclasses import dataclass

from ecfft_tpu_torch.errors import CurveError


def _clmul(a: int, b: int) -> int:
    """Carry-less product of two GF(2)[x] polynomials."""
    r = 0
    while b:
        if b & 1:
            r ^= a
        a <<= 1
        b >>= 1
    return r


def _poly_degree(a: int) -> int:
    return a.bit_length() - 1


def _poly_divmod(a: int, b: int) -> tuple[int, int]:
    """GF(2)[x] division: a = q·b + r with deg r < deg b."""
    db = _poly_degree(b)
    q = 0
    while a.bit_length() - 1 >= db and a:
        shift = a.bit_length() - 1 - db
        q ^= 1 << shift
        a ^= b << shift
    return q, a


def is_irreducible(poly: int) -> bool:
    """Rabin's test over GF(2): x^(2^m) ≡ x (mod f) and
    gcd(x^(2^(m/q)) − x, f) = 1 for every prime divisor q of m."""
    m = _poly_degree(poly)
    if m <= 0:
        return False

    def xpow2k(k: int) -> int:
        # x^(2^k) mod poly by repeated squaring of x
        t = 0b10
        for _ in range(k):
            t = _poly_divmod(_clmul(t, t), poly)[1]
        return t

    if xpow2k(m) != 0b10:
        return False
    q, factors = m, []
    d = 2
    while d * d <= q:
        if q % d == 0:
            factors.append(d)
            while q % d == 0:
                q //= d
        d += 1
    if q > 1:
        factors.append(q)
    for f in factors:
        g = _poly_gcd(xpow2k(m // f) ^ 0b10, poly)
        if g != 1:
            return False
    return True


def _poly_gcd(a: int, b: int) -> int:
    while b:
        a, b = b, _poly_divmod(a, b)[1]
    return a


@dataclass(frozen=True)
class F2m:
    """GF(2^m) in polynomial basis mod an irreducible ``modulus``.

    Characteristic 2 — ``is_odd(F2m(...))`` is False, selecting the
    even-characteristic curve paths (utils.rs:350-352 analogue).
    """

    m: int
    modulus: int

    def __post_init__(self):
        if _poly_degree(self.modulus) != self.m:
            raise ValueError("modulus degree must equal m")
        if not is_irreducible(self.modulus):
            raise ValueError("modulus polynomial is not irreducible")

    # characteristic and order
    @property
    def characteristic(self) -> int:
        return 2

    @property
    def order(self) -> int:
        return 1 << self.m

    def validate(self, a: int) -> int:
        if not 0 <= a < self.order:
            raise ValueError("element out of range")
        return a

    # ------------------------------------------------------------ ops
    def add(self, a: int, b: int) -> int:
        return a ^ b

    sub = add  # char 2: subtraction IS addition

    def neg(self, a: int) -> int:
        return a

    def mul(self, a: int, b: int) -> int:
        return _poly_divmod(_clmul(a, b), self.modulus)[1]

    def square(self, a: int) -> int:
        return self.mul(a, a)

    def pow(self, a: int, e: int) -> int:
        r, acc = 1, a
        while e:
            if e & 1:
                r = self.mul(r, acc)
            acc = self.mul(acc, acc)
            e >>= 1
        return r

    def inv(self, a: int) -> int:
        if a == 0:
            raise ZeroDivisionError("inverse of 0 in GF(2^m)")
        # a^(2^m − 2)
        return self.pow(a, self.order - 2)

    def batch_inv(self, vals: list[int]) -> list[int]:
        """Montgomery's trick over GF(2^m) (zeros stay zero) — the same
        duck-typed surface as fields.host.FpHost.batch_inv."""
        from ecfft_tpu_torch.fields.host import batch_inv_field

        return batch_inv_field(self, vals)

    def sqrt(self, a: int) -> int:
        """Every element has a unique square root in char 2 (Frobenius is
        a bijection): sqrt(a) = a^(2^(m−1))."""
        for _ in range(self.m - 1):
            a = self.mul(a, a)
        return a

    # --------------------------------------------------- quadratics
    def trace(self, a: int) -> int:
        """Absolute trace Tr(a) = Σ a^(2^i) ∈ {0, 1}."""
        t, acc = 0, a
        for _ in range(self.m):
            t ^= acc
            acc = self.mul(acc, acc)
        return t

    def solve_quadratic(self, c: int) -> int | None:
        """A root z of z² + z = c, or None (solvable iff Tr(c) = 0).

        Odd m: the half-trace Σ_{i even} c^(2^i). Even m: search a basis
        element δ with Tr(δ)=1 and fold (still O(m) field squarings)."""
        if self.trace(c) != 0:
            return None
        if self.m % 2 == 1:
            z, acc = 0, c
            for i in range(self.m):
                if i % 2 == 0:
                    z ^= acc
                acc = self.mul(acc, acc)
            return z
        # even m: z = Σ_{i} (Σ_{j<i} c^(2^j)) δ^(2^i) for Tr(δ) = 1
        delta = next(d for d in range(1, self.order) if self.trace(d) == 1)
        z = 0
        partial = 0
        acc_c, acc_d = c, delta
        for _ in range(self.m):
            z ^= self.mul(partial, acc_d)
            partial ^= acc_c
            acc_c = self.mul(acc_c, acc_c)
            acc_d = self.mul(acc_d, acc_d)
        if self.add(self.square(z), z) != c:  # pragma: no cover
            raise CurveError("quadratic solver failed")
        return z


# A convenient default: GF(2^9), x^9 + x^4 + 1 (an irreducible trinomial;
# odd m keeps the half-trace quadratic solver simple)
GF512 = F2m(9, (1 << 9) | (1 << 4) | 1)
