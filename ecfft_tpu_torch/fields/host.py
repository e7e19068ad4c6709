"""Host-side exact prime-field arithmetic over python ints.

A jax-free copy of the functions of ``ecfft_tpu/fields/host.py`` that the
curve layer needs: inverse, Legendre symbol and square root mod p. Each
has the same source as its original (tested).
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


def sqrt_mod(a: int, p: int) -> int | None:
    """Square root mod odd prime p via Tonelli–Shanks.

    Returns one of the two roots, or None if ``a`` is a non-residue.
    Mirrors the role of arkworks ``Field::sqrt`` used throughout the
    reference (e.g. /root/reference/src/ec.rs:42-50,
    /root/reference/src/find_curve.rs:27-55).
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
