"""Schoof point counting for short Weierstrass curves y² = x³ + Ax + B.

A jax-free copy of ``ecfft_tpu/schoof.py`` (every class and function has
its original's source, tested), with the capability of the reference's
examples/schoofs.rs: the Frobenius trace t mod ℓ for enough small primes
ℓ (incremental CRT until ∏ℓ > 4√p), by endomorphism arithmetic in the
quotient ring F[x]/(ψ_ℓ) with the curve relation substituted implicitly;
an uninvertible denominator reveals a factor of ψ_ℓ and the trace is
recomputed modulo it. ℓ = 2 is the parity test gcd(x^p − x, x³ + Ax + B).

``cardinality`` runs on python ints (practical up to about 64-bit
fields); ``cardinality_native`` takes each trace from the native engine
(``native.schoof_trace_native``) and counts 2^61-scale primes in seconds.
"""

from __future__ import annotations

import math

from ecfft_tpu_torch.ec.curve import ShortWeierstrass
from ecfft_tpu_torch.utils import poly as P

SMALL_PRIMES = [
    2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41, 43, 47, 53, 59, 61,
    67, 71, 73, 79, 83, 89, 97, 101, 103, 107, 109, 113, 127, 131, 137,
    139, 149, 151, 157, 163, 167, 173, 179, 181, 191, 193, 197, 199,
]


class Uninvertable(Exception):
    """A denominator shared a factor with the modulus; carries the gcd."""

    def __init__(self, g):
        super().__init__("uninvertable element; modulus factor found")
        self.g = g


class QuotientRing:
    """F[x] / (modulus), with invert-or-reveal-factor semantics
    (schoofs.rs:276-333)."""

    def __init__(self, modulus: list, p: int):
        self.modulus = modulus
        self.p = p

    def reduce(self, f):
        return P.div_rem(f, self.modulus, self.p)

    def mul(self, f, g):
        return self.reduce(P.mul(f, g, self.p))

    def pow(self, f, e: int):
        return P.pow_mod(f, e, self.modulus, self.p)

    def inv(self, f):
        s, _, g = P.xgcd(f, self.modulus, self.p)
        if P.degree(g) != 0:
            raise Uninvertable(g)
        # g is a (monic) unit: s·f ≡ g, so f⁻¹ = s/g
        return self.reduce(s)

    def div(self, f, g):
        return self.mul(f, self.inv(g))


def division_polynomials(curve: ShortWeierstrass, n_max: int):
    """x-only division polynomials with the parity convention:
    odd n: ψ_n = f_n(x); even n: ψ_n = y·f_n(x). Uses the standard
    recurrences with every y² replaced by F = x³ + Ax + B
    (cf. schoofs.rs:370-431)."""
    p = curve.p
    A, B = curve.a % p, curve.b % p
    F = [B, A, 0, 1]
    FF = P.mul(F, F, p)
    f = {0: [], 1: [1], 2: [2]}
    # ψ3 = 3x⁴ + 6Ax² + 12Bx − A²
    f[3] = P.trim([(-A * A) % p, 12 * B % p, 6 * A % p, 0, 3])
    # ψ4 = y·4·(x⁶ + 5Ax⁴ + 20Bx³ − 5A²x² − 4ABx − 8B² − A³)
    f[4] = P.trim([
        4 * (-8 * B * B - A ** 3) % p,
        4 * (-4 * A * B) % p,
        4 * (-5 * A * A) % p,
        4 * 20 * B % p,
        4 * 5 * A % p,
        0,
        4,
    ])

    def get(n: int):
        if n in f:
            return f[n]
        m = n // 2
        if n % 2 == 1:
            # ψ_{2m+1} = ψ_{m+2}·ψ_m³ − ψ_{m−1}·ψ_{m+1}³
            a = P.mul(get(m + 2), P.mul(get(m), P.mul(get(m), get(m), p), p), p)
            b = P.mul(get(m - 1), P.mul(get(m + 1),
                                        P.mul(get(m + 1), get(m + 1), p), p), p)
            if m % 2 == 1:
                # ψ_m odd ⇒ ψ_{m+2} odd, ψ_{m±1} even: the even cube
                # carries y³ = y·F ⇒ multiply b-term by F... both terms
                # must end x-only: a has y⁰, b has y⁴ → F²
                res = P.sub(a, P.mul(b, FF, p), p)
            else:
                res = P.sub(P.mul(a, FF, p), b, p)
            f[n] = res
        else:
            # ψ_{2m} = (ψ_m / 2y)·(ψ_{m+2}·ψ_{m−1}² − ψ_{m−2}·ψ_{m+1}²)
            a = P.mul(get(m + 2), P.mul(get(m - 1), get(m - 1), p), p)
            b = P.mul(get(m - 2), P.mul(get(m + 1), get(m + 1), p), p)
            inner = P.sub(a, b, p)
            res = P.mul(get(m), inner, p)
            res = P.scale(res, pow(2, -1, p), p)
            f[n] = res
        return f[n]

    for i in range(n_max + 1):
        get(i)
    return f


class Endo:
    """Endomorphism (a(x), y·b(x)) in F[x]/ψ (schoofs.rs:142-273).

    ``None`` represents the zero endomorphism (point at infinity).
    """

    __slots__ = ("a", "b")

    def __init__(self, a, b):
        self.a = a
        self.b = b


def endo_add(ring: QuotientRing, F, e1: Endo | None, e2: Endo | None):
    """Chord/tangent addition with y-implicit slopes.

    Distinct-x: λ = y·c with c = (b2 − b1)/(a2 − a1);
    tangent: λ = y·c with c = (3a² + A)/(2·F·b) (1/y = y/F);
    x₃ = F·c² − x₁ − x₂, b₃ = c·(a₁ − a₃) − b₁.
    """
    p = ring.p
    if e1 is None:
        return e2
    if e2 is None:
        return e1
    if e1.a == e2.a:
        if P.sub(e1.b, P.sub([], e2.b, p), p) == []:
            # b1 == -b2 → opposite points → infinity
            return None
        if e1.b == e2.b:
            # tangent case: c = ψ'(x)... numerator 3a²+A evaluated in ring
            three_a2 = ring.reduce(
                P.add(P.scale(ring.mul(e1.a, e1.a), 3, p),
                      [F[1]], p)
            )
            den = ring.reduce(P.scale(ring.mul(F, e1.b), 2, p))
            c = ring.div(three_a2, den)
        else:
            return None
    else:
        num = P.sub(e2.b, e1.b, p)
        den = P.sub(e2.a, e1.a, p)
        c = ring.div(ring.reduce(num), ring.reduce(den))
    cc = ring.mul(c, c)
    x3 = P.sub(ring.mul(cc, F), P.add(e1.a, e2.a, p), p)
    x3 = ring.reduce(x3)
    b3 = P.sub(ring.mul(c, P.sub(e1.a, x3, p)), e1.b, p)
    return Endo(x3, ring.reduce(b3))


def endo_scalar_mul(ring: QuotientRing, F, e: Endo | None, k: int):
    res = None
    acc = e
    while k:
        if k & 1:
            res = endo_add(ring, F, res, acc)
        acc = endo_add(ring, F, acc, acc)
        k >>= 1
    return res


def endo_eq(e1: Endo | None, e2: Endo | None) -> bool:
    if e1 is None or e2 is None:
        return e1 is None and e2 is None
    return e1.a == e2.a and e1.b == e2.b


def has_even_order(curve: ShortWeierstrass) -> bool:
    """ℓ=2: x³+Ax+B has a root ⇔ rational 2-torsion ⇔ even order
    (schoofs.rs:345-366)."""
    p = curve.p
    cubic = curve.x3_ax_b()
    xp = P.pow_mod([0, 1], p, cubic, p)
    g = P.gcd(cubic, P.sub(xp, [0, 1], p), p)
    return P.degree(g) != 0


def frobenius_trace_mod_l(curve: ShortWeierstrass, ell: int, psi) -> int:
    """t mod ℓ via π² + [p mod ℓ] = [t]·π in F[x]/ψ_ℓ
    (schoofs.rs:76-138), with Uninvertable recursion onto discovered
    modulus factors."""
    p = curve.p
    F = [curve.b % p, curve.a % p, 0, 1]
    modulus = psi
    while True:
        try:
            ring = QuotientRing(modulus, p)
            # π = (x^p, y·F^((p−1)/2))
            pi = Endo(ring.pow([0, 1], p), ring.pow(F, (p - 1) // 2))
            # π² via Frobenius powering of the components
            pi2 = Endo(ring.pow(pi.a, p),
                       ring.mul(pi.b, ring.pow(pi.b, p)))
            # components must live IN the ring: for a degree-1 modulus the
            # raw (x, y·1) would compare unequal to its reduced form and
            # send endo_add down the wrong branch
            identity = Endo(ring.reduce([0, 1]), ring.reduce([1]))
            q_endo = endo_scalar_mul(ring, F, identity, p % ell)
            lhs = endo_add(ring, F, pi2, q_endo)
            if lhs is None:
                return 0
            rhs = None
            for j in range(1, ell):
                rhs = endo_add(ring, F, rhs, pi)
                if rhs is not None and endo_eq(lhs, rhs):
                    return j
            raise ArithmeticError(
                f"no trace found mod {ell} (should be unreachable)"
            )
        except Uninvertable as u:
            # restart with the smaller modulus factor (schoofs.rs:115-128)
            modulus = u.g


def cardinality(curve: ShortWeierstrass) -> int:
    """#E(F_p) by incremental CRT over small primes until ∏ℓ > 4√p
    (schoofs.rs:30-71)."""
    p = curve.p
    bound = 4 * math.isqrt(p) + 4
    t_mod, m = 0, 1
    prime_iter = iter(SMALL_PRIMES)
    while m <= bound:
        ell = next(prime_iter)
        if p % ell == 0:
            continue
        if ell == 2:
            t_ell = 0 if has_even_order(curve) else 1
        else:
            psi = division_polynomials(curve, ell)[ell]
            t_ell = frobenius_trace_mod_l(curve, ell, psi)
        # CRT accumulate
        g, inv_m = 1, pow(m, -1, ell)
        t_mod = (t_mod + m * ((t_ell - t_mod) * inv_m % ell)) % (m * ell)
        m *= ell
    # |t| ≤ 2√p: center the residue
    if t_mod > m // 2:
        t_mod -= m
    return p + 1 - t_mod


def cardinality_native(curve: ShortWeierstrass) -> int:
    """#E(F_p) with the per-ℓ Frobenius traces computed by the native
    C++ engine (4×64 Montgomery — native/ecfft_native.cpp
    ``ecn_schoof_trace``) and the big-integer CRT kept in Python
    (schoofs.rs:55-62). This pushes Schoof well past the pure-python
    path's ~64-bit practicality ceiling: a fresh 2^61-scale prime counts
    in seconds. 256-bit primes need ℓ up to ~130 (ψ_ℓ degree ~8400,
    schoolbook O(deg²) ring mults) — reachable but hours-scale; the
    reference's own example is m31-only and admits a wrong answer there
    (schoofs.rs:29)."""
    from ecfft_tpu_torch.native import schoof_trace_native

    p = curve.p
    bound = 4 * math.isqrt(p) + 4
    t_mod, m = 0, 1
    prime_iter = iter(SMALL_PRIMES)
    while m <= bound:
        ell = next(prime_iter)
        if p % ell == 0:
            continue
        t_ell = schoof_trace_native(p, curve.a, curve.b, ell)
        inv_m = pow(m, -1, ell)
        t_mod = (t_mod + m * ((t_ell - t_mod) * inv_m % ell)) % (m * ell)
        m *= ell
    if t_mod > m // 2:
        t_mod -= m
    return p + 1 - t_mod
