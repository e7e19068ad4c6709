"""Host-side prime-field arithmetic over python ints.

A jax-free copy of ``ecfft_tpu/fields/host.py``: inverse, Legendre symbol,
quadratic-residue test and square root mod p, the batch inversions, and
``FpHost``, the prime field as a field object with the same duck-typed
interface as :class:`ecfft_tpu_torch.fields.binary.F2m`, which the host
oracle (``host/fftree.py``) threads through its eight algorithms. Each
class and function has the same source as its original (tested).
"""

from __future__ import annotations


def inv_mod(a: int, p: int) -> int:
    """Modular inverse via python's builtin extended Euclid."""
    a %= p
    if a == 0:
        raise ZeroDivisionError("inverse of zero")
    return pow(a, -1, p)


def legendre(a: int, p: int) -> int:
    """Legendre symbol (a/p) in {-1, 0, 1} for odd prime p."""
    a %= p
    if a == 0:
        return 0
    ls = pow(a, (p - 1) // 2, p)
    return -1 if ls == p - 1 else 1


def is_qr(a: int, p: int) -> bool:
    """True iff ``a`` is a quadratic residue mod odd prime p (0 counts)."""
    return legendre(a, p) >= 0


def sqrt_mod(a: int, p: int) -> int | None:
    """Square root mod odd prime p via Tonelli–Shanks.

    Returns one of the two roots, or None if ``a`` is a non-residue.
    Mirrors the role of arkworks ``Field::sqrt`` used throughout the
    reference (e.g. reference/src/ec.rs:42-50,
    reference/src/find_curve.rs:27-55).
    """
    a %= p
    if a == 0:
        return 0
    if legendre(a, p) != 1:
        return None
    if p % 4 == 3:
        return pow(a, (p + 1) // 4, p)
    # Tonelli–Shanks
    q, s = p - 1, 0
    while q % 2 == 0:
        q //= 2
        s += 1
    # find a non-residue z
    z = 2
    while legendre(z, p) != -1:
        z += 1
    m = s
    c = pow(z, q, p)
    t = pow(a, q, p)
    r = pow(a, (q + 1) // 2, p)
    while t != 1:
        # find least i, 0 < i < m, with t^(2^i) == 1
        i = 0
        t2 = t
        while t2 != 1:
            t2 = t2 * t2 % p
            i += 1
        b = pow(c, 1 << (m - i - 1), p)
        m = i
        c = b * b % p
        t = t * c % p
        r = r * b % p
    return r


class FpHost:
    """Prime field F_p as a *field object* with the same duck-typed
    interface as :class:`ecfft_tpu_torch.fields.binary.F2m` (add/sub/neg/mul/
    square/pow/inv/batch_inv/characteristic/order).

    The reference's FFTree is generic over any arkworks ``Field``
    (reference/src/fftree.rs:42, ec.rs:498); the host oracle
    (ecfft_tpu/host/fftree.py) threads one of these objects through all
    eight algorithms so the same code runs over F_p AND GF(2^m)."""

    __slots__ = ("p",)

    def __init__(self, p: int):
        self.p = p

    @property
    def characteristic(self) -> int:
        return self.p

    @property
    def order(self) -> int:
        return self.p

    def add(self, a: int, b: int) -> int:
        return (a + b) % self.p

    def sub(self, a: int, b: int) -> int:
        return (a - b) % self.p

    def neg(self, a: int) -> int:
        return -a % self.p

    def mul(self, a: int, b: int) -> int:
        return a * b % self.p

    def square(self, a: int) -> int:
        return a * a % self.p

    def pow(self, a: int, e: int) -> int:
        return pow(a, e, self.p)

    def inv(self, a: int) -> int:
        return inv_mod(a, self.p)

    def batch_inv(self, vals: list[int]) -> list[int]:
        return batch_inv_mod(vals, self.p)

    def __eq__(self, other) -> bool:
        return isinstance(other, FpHost) and other.p == self.p

    def __hash__(self) -> int:
        return hash(("FpHost", self.p))

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"FpHost({self.p:#x})"


def batch_inv_field(F, vals: list[int]) -> list[int]:
    """Montgomery's batch-inversion trick over any field object (used by
    field objects that don't special-case it; zeros stay zero)."""
    n = len(vals)
    prefix = [1] * (n + 1)
    for i, v in enumerate(vals):
        prefix[i + 1] = F.mul(prefix[i], v if v != 0 else 1)
    acc = F.inv(prefix[n])
    out = [0] * n
    for i in range(n - 1, -1, -1):
        v = vals[i]
        if v != 0:
            out[i] = F.mul(acc, prefix[i])
            acc = F.mul(acc, v)
    return out


def batch_inv_mod(vals: list[int], p: int) -> list[int]:
    """Montgomery's batch-inversion trick (1 inversion + 3n muls).

    Host analogue of ``ark_ff::batch_inversion`` used by the reference at
    reference/src/fftree.rs:330-333,409-410,236. Zero entries are
    left as zero (matching arkworks semantics).
    """
    n = len(vals)
    prefix = [1] * (n + 1)
    for i, v in enumerate(vals):
        prefix[i + 1] = prefix[i] * (v if v != 0 else 1) % p
    acc = inv_mod(prefix[n], p)
    out = [0] * n
    for i in range(n - 1, -1, -1):
        v = vals[i]
        if v == 0:
            out[i] = 0
        else:
            out[i] = acc * prefix[i] % p
            acc = acc * v % p
    return out
