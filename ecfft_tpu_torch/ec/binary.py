"""The even-characteristic good curve over GF(2^m).

A jax-free copy of ``ecfft_tpu/ec/binary.py`` (every class and function
has its original's source, tested): the reference's ``GoodCurve::Even``
and its closed-form 2-isogeny (reference/src/ec.rs:28-35,47-52,63-73),

    E_B:  y² + x·y = x³ + B·x,  B = b²       (a1=1, a4=B, others 0)
    good point  (b, b)
    good_isogeny: codomain E_{B'} with B' = b
        r = (x² + B)/x,  g = (B + b·x)/x,  h = (x² + B)/x²

with the group law over an abstract field object, the chain walk of
good isogenies for a generator of order 2^k, and the enumeration of a
small curve's points. ``host.fftree.build_host_fftree_even`` builds a
tree on it.
"""

from __future__ import annotations

from dataclasses import dataclass

from ecfft_tpu_torch.errors import CurveError
from ecfft_tpu_torch.fields.binary import F2m


def is_odd(field_or_char) -> bool:
    """Characteristic parity dispatch (utils.rs:350-352): True for prime
    fields F_p (p odd — p = 2 would BE the binary field), False for
    GF(2^m)."""
    if isinstance(field_or_char, F2m):
        return False
    char = int(field_or_char)
    return char % 2 == 1


@dataclass(frozen=True)
class RationalMapB:
    """num(x)/den(x) over GF(2^m), coefficients low-degree-first
    (utils.rs:367-390, instantiated for the binary field)."""

    numerator: tuple
    denominator: tuple
    field: F2m

    def __call__(self, x: int) -> int | None:
        F = self.field

        def ev(coeffs):
            acc = 0
            for c in reversed(coeffs):
                acc = F.add(F.mul(acc, x), c)
            return acc

        den = ev(self.denominator)
        if den == 0:
            return None
        return F.mul(ev(self.numerator), F.inv(den))

    @staticmethod
    def zero(field: F2m) -> "RationalMapB":
        return RationalMapB((), (1,), field)


@dataclass(frozen=True)
class GoodCurveEven:
    """E_B: y² + x·y = x³ + B·x with B = b² (ec.rs:30-32).

    Non-singularity is exactly B ≠ 0 (Δ = B² in char 2), matching the
    reference's single assert (ec.rs:49)."""

    field: F2m
    b: int

    @staticmethod
    def new_even(field: F2m, bb: int) -> "GoodCurveEven":
        """ec.rs:47-52: b = sqrt(B) — always exists in char 2 (Frobenius
        is a bijection), so unlike the odd case there is no residuosity
        gate and good chains never stall."""
        if bb == 0:
            raise CurveError("singular curve: B must be nonzero (ec.rs:49)")
        return GoodCurveEven(field, field.sqrt(bb))

    # Weierstrass coefficients (ec.rs:142-173, Even arm)
    def a1(self) -> int:
        return 1

    def a2(self) -> int:
        return 0

    def a3(self) -> int:
        return 0

    def a4(self) -> int:
        return self.field.square(self.b)

    def a6(self) -> int:
        return 0

    def contains(self, x: int, y: int) -> bool:
        F = self.field
        lhs = F.add(F.square(y), F.mul(x, y))
        rhs = F.add(F.mul(F.square(x), x), F.mul(self.a4(), x))
        return lhs == rhs

    def good_point(self) -> "PointB":
        """(b, b) (ec.rs:56)."""
        return PointB(self.b, self.b, self)

    def good_isogeny(self) -> "IsogenyB":
        """The even closed-form 2-isogeny (ec.rs:63-73): kernel
        {O, (0,0)}, codomain E_{B'} with B' = b."""
        F = self.field
        b = self.b
        bb = F.square(b)
        codomain = GoodCurveEven.new_even(F, b)
        r = RationalMapB((bb, 0, 1), (0, 1), F)
        g = RationalMapB((bb, b), (0, 1), F)
        h = RationalMapB((bb, 0, 1), (0, 0, 1), F)
        return IsogenyB(self, codomain, r, g, h)


@dataclass(frozen=True)
class IsogenyB:
    """φ(x, y) = (r(x), g(x) + h(x)·y) (ec.rs:314-359)."""

    domain: GoodCurveEven
    codomain: GoodCurveEven
    r: RationalMapB
    g: RationalMapB
    h: RationalMapB

    def map(self, pt: "PointB") -> "PointB":
        if pt.is_zero():
            return PointB.zero()
        rx = self.r(pt.x)
        gx = self.g(pt.x)
        hx = self.h(pt.x)
        if rx is None or gx is None or hx is None:
            return PointB.zero()
        F = self.domain.field
        return PointB(rx, F.add(gx, F.mul(hx, pt.y)), self.codomain)


class PointB:
    """Affine point over GF(2^m); ``curve is None`` = infinity.

    Same full Silverman III.2.3 law as ec/curve.py::Point
    (ec.rs:376-424), with field ops routed through the curve's F2m."""

    __slots__ = ("x", "y", "curve")

    def __init__(self, x: int, y: int, curve: GoodCurveEven | None):
        self.x = x
        self.y = y
        self.curve = curve

    @staticmethod
    def zero() -> "PointB":
        return PointB(0, 0, None)

    def is_zero(self) -> bool:
        return self.curve is None

    def __eq__(self, other) -> bool:
        if self.is_zero() and other.is_zero():
            return True
        if self.is_zero() or other.is_zero():
            return False
        return (self.curve == other.curve and self.x == other.x
                and self.y == other.y)

    def __neg__(self) -> "PointB":
        """−(x, y) = (x, −y − a1·x − a3) = (x, y + x) here (ec.rs:449-464)."""
        if self.is_zero():
            return self
        c = self.curve
        F = c.field
        return PointB(self.x, F.add(F.add(F.neg(self.y),
                                          F.mul(c.a1(), self.x)), c.a3()), c)

    def __add__(self, rhs: "PointB") -> "PointB":
        if self.is_zero():
            return rhs
        if rhs.is_zero():
            return self
        if self.curve != rhs.curve:
            raise ValueError("points belong to different curves")
        c = self.curve
        F = c.field
        a1, a2, a3, a4, a6 = c.a1(), c.a2(), c.a3(), c.a4(), c.a6()
        x1, y1, x2, y2 = self.x, self.y, rhs.x, rhs.y
        add, mul = F.add, F.mul

        def smul(k: int, z: int) -> int:  # small-int multiple via field add
            acc = 0
            for _ in range(k):
                acc = add(acc, z)
            return acc

        if x1 == x2 and add(add(add(y1, y2), mul(a1, x2)), a3) == 0:
            return PointB.zero()
        if x1 == x2:
            den_v = add(add(smul(2, y1), mul(a1, x1)), a3)
            den = F.inv(den_v)
            lam = mul(
                add(add(add(smul(3, F.square(x1)), smul(2, mul(a2, x1))),
                        a4), F.neg(mul(a1, y1))),
                den,
            )
            nu = mul(
                add(add(add(F.neg(mul(F.square(x1), x1)), mul(a4, x1)),
                        smul(2, a6)), F.neg(mul(a3, y1))),
                den,
            )
        else:
            den = F.inv(add(x2, F.neg(x1)))
            lam = mul(add(y2, F.neg(y1)), den)
            nu = mul(add(mul(y1, x2), F.neg(mul(y2, x1))), den)
        x3 = add(add(add(add(F.square(lam), mul(a1, lam)), F.neg(a2)),
                     F.neg(x1)), F.neg(x2))
        y3 = add(add(F.neg(mul(add(lam, a1), x3)), F.neg(nu)), F.neg(a3))
        return PointB(x3, y3, c)

    def double(self) -> "PointB":
        return self + self

    def __mul__(self, k: int) -> "PointB":
        res = PointB.zero()
        acc = self
        while k:
            if k & 1:
                res = res + acc
            acc = acc + acc
            k >>= 1
        return res

    def __repr__(self) -> str:
        if self.is_zero():
            return "PointB(∞)"
        return f"PointB({self.x:#x}, {self.y:#x})"


def find_isogeny_chain_even(generator: PointB) -> list[IsogenyB]:
    """Chain of k good even isogenies for a generator of order 2^k
    (ec.rs:177-189, Even arm): adicity must drop by exactly one per step.
    Char-2 chains never stall — sqrt always exists (cf. the odd-char
    relabeling workaround in ec/curve.py::find_isogeny_chain)."""
    from ecfft_tpu_torch.ec.curve import two_adicity

    k = two_adicity(generator)
    if k is None:
        raise CurveError("generator is not a point of order 2^k")
    chain = []
    g = generator
    for i in range(k):
        iso = g.curve.good_isogeny()
        g_next = iso.map(g)
        if two_adicity(g_next) != k - i - 1:
            raise CurveError(
                "good isogeny failed to halve the generator's order "
                "(ec.rs:184)"
            )
        chain.append(iso)
        g = g_next
    return chain


def curve_points(curve: GoodCurveEven) -> list[PointB]:
    """All affine points of E_B (enumeration tooling for small fields):
    for x ≠ 0 substitute y = x·z to get z² + z = x + B/x² ... precisely
    z² + z = (x³ + Bx)/x², solvable iff its trace vanishes; x = 0 gives
    the 2-torsion point (0, 0)."""
    F = curve.field
    B = curve.a4()
    pts = [PointB(0, 0, curve)]
    for x in range(1, F.order):
        rhs = F.add(F.mul(F.square(x), x), F.mul(B, x))
        c = F.mul(rhs, F.inv(F.square(x)))
        z = F.solve_quadratic(c)
        if z is None:
            continue
        y = F.mul(x, z)
        pts.append(PointB(x, y, curve))
        pts.append(PointB(x, F.add(y, x), curve))  # the conjugate root
    return pts
