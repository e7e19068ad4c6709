"""FIND_CURVE: search for good curves with large cyclic 2-Sylow subgroups.

A jax-free copy of ``ecfft_tpu/find_curve.py`` (every function here has
its original's source, tested): the ECFFT Part II curve search over F_p
with the point-halving 2-Sylow machinery of Miret–Moreno–Rio–Valls
("Determining the 2-Sylow subgroup of an elliptic curve over a finite
field", Math. Comp. 74, 2005). ``fields.registry.field_from_curve_search``
falls back on it where the native engine's search is not available.

Curves are y² = x·(x² + a·x + B) with B = b² (the odd-characteristic
GoodCurve form). The search samples (a, B) and measures the 2-adicity n of
the cyclic 2-Sylow by repeated point halving; a hit with n ≥ k yields the
subgroup generator directly. The general (non-cyclic) 2-Sylow walk and
even characteristic raise NotImplementedError, as in the original.
"""

from __future__ import annotations

import random

from ecfft_tpu_torch.ec.curve import GoodCurve, Point
from ecfft_tpu_torch.fields.host import sqrt_mod


def double_point_x(px: int, a: int, bb: int, p: int) -> int | None:
    """x(2P) from x(P) on y² = x(x² + ax + B), or None if 2P = ∞
    (find_curve.rs:11-19)."""
    pxpx = px * px % p
    pypy = px * (pxpx + a * px + bb) % p
    if pypy == 0:
        return None
    num = (pxpx - bb) % p
    return num * num % p * pow(4 * pypy % p, -1, p) % p


def quad_roots(a: int, b: int, c: int, p: int) -> tuple[int, int] | None:
    """Roots of a·x² + b·x + c over F_p (odd), or None
    (find_curve.rs:35-44)."""
    disc = (b * b - 4 * a * c) % p
    s = sqrt_mod(disc, p)
    if s is None:
        return None
    inv2a = pow(2 * a % p, -1, p)
    return ((-b + s) * inv2a % p, (-b - s) * inv2a % p)


def fi_roots(i: int, qx: int, a: int, bb: int, p: int) -> tuple[int, int] | None:
    """Roots of the halving polynomials f_{1,ξ} / f_{2,ξ} for x(Q) = ξ
    (find_curve.rs:49-56)."""
    assert i in (1, 2)
    delta = (qx * qx + a * qx + bb) % p
    ds = sqrt_mod(delta, p)
    if ds is None:
        return None
    sign = -1 if i == 1 else 1
    x_coeff = (-(2 * qx + sign * 2 * ds)) % p
    return quad_roots(1, x_coeff, bb, p)


def half_point_x(qx: int, a: int, bb: int, p: int) -> int | None:
    """x(P) with 2P = Q, if a rational half point exists
    (find_curve.rs:25-31)."""
    roots = fi_roots(1, qx, a, bb, p) or fi_roots(2, qx, a, bb, p)
    if roots is None:
        return None
    for x in roots:
        if sqrt_mod(x * (x * x + a * x + bb) % p, p) is not None:
            return x
    return None


def cyclic_two_sylow_subgroup(a: int, bb: int, p: int) -> tuple[int, int | None]:
    """(n, x) with Sylow₂(E) ≅ Z/2ⁿZ generated by a point with the given
    x-coordinate; (0, None) when the 2-Sylow is trivial or non-cyclic
    (find_curve.rs:190-218).

    Cyclicity gate: B a QR and discriminant a² − 4B a non-residue. The
    order-4 x-coordinate is ±b by Lemma 3; halving then climbs the
    2-Sylow one level per step.
    """
    disc = (a * a - 4 * bb) % p
    assert disc != 0
    b = sqrt_mod(bb, p)
    if b is None or sqrt_mod(disc, p) is not None:
        return 0, None
    if sqrt_mod((a + 2 * b) % p, p) is not None:
        p4_x = b
    elif sqrt_mod((a - 2 * b) % p, p) is not None:
        p4_x = (-b) % p
    else:
        raise AssertionError("unreachable: cyclic case must have order-4 point")
    if double_point_x(p4_x, a, bb, p) is None:
        return 1, 0
    k = 2
    acc = p4_x
    while True:
        nxt = half_point_x(acc, a, bb, p)
        if nxt is None:
            return k, acc
        k += 1
        acc = nxt


def find_two_sylow_subgroup(a: int, bb: int, p: int):
    """General (possibly non-cyclic) 2-Sylow determination.

    The reference left this unfinished (find_curve.rs:65-178, two
    todo!()s); kept as an explicit capability boundary.
    """
    raise NotImplementedError(
        "non-cyclic 2-Sylow walk is unfinished in the reference "
        "(find_curve.rs:148,151); only the cyclic case is supported"
    )


def find_curve(p: int, k: int, rng: random.Random | None = None
               ) -> tuple[int, Point]:
    """Search for a GoodCurve point of order 2ⁿ with n ≥ k
    (find_curve.rs:224-246). Returns (n, generator point).

    Odd characteristic only — the reference's even-char branch is todo!()
    (find_curve.rs:244).
    """
    if p % 2 == 0:
        raise NotImplementedError(
            "even-characteristic find_curve is todo!() in the reference "
            "(find_curve.rs:244)"
        )
    rng = rng or random.Random()
    k = max(k, 2)
    while True:
        a = rng.randrange(p)
        bb = rng.randrange(p)
        if bb == 0 or (a * a - 4 * bb) % p == 0:
            continue
        n, x = cyclic_two_sylow_subgroup(a, bb, p)
        if n >= k:
            yy = x * (x * x + a * x + bb) % p
            y = sqrt_mod(yy, p)
            assert y is not None
            curve = GoodCurve.new_odd(a, bb, p)
            return n, Point(x, y, curve)
