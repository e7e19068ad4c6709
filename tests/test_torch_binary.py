"""The port's binary-field path (``ecfft_tpu_torch.fields.binary``,
``ecfft_tpu_torch.ec.binary`` and ``host.fftree.build_host_fftree_even``),
jax-free copies of the JAX package's, held to it on the same numpy-seeded
inputs: GF(2^m) arithmetic, the even-characteristic isogeny chain, and the
GF(2^9) tree at n = 16 through all eight algorithms, with ENTER against
naive evaluation and the EXIT round trip. Tolerance: none (exact)."""

import numpy as np
import pytest

from ecfft_tpu.ec import binary as jecb
from ecfft_tpu.fields import binary as jfb
from ecfft_tpu.host import fftree as jhost
from ecfft_tpu_torch.ec import binary as tecb
from ecfft_tpu_torch.fields import binary as tfb
from ecfft_tpu_torch.host import fftree as thost

S0, S1 = thost.S0, thost.S1
N = 16


def _fields():
    """(port field, JAX field) pairs: GF(2^9) and two more moduli."""
    out = [(tfb.GF512, jfb.GF512)]
    for m, poly in ((8, 0b100011011), (13, (1 << 13) | 0b11011)):
        out.append((tfb.F2m(m, poly), jfb.F2m(m, poly)))
    return out


@pytest.mark.parametrize("fi", range(3))
@pytest.mark.parametrize("op", ["add", "sub", "mul", "square", "pow", "inv",
                                "sqrt", "trace", "solve_quadratic",
                                "batch_inv"])
def test_field_ops_match_the_jax_package(fi, op):
    tf, jf = _fields()[fi]
    rng = np.random.RandomState(11 + fi)
    xs = [int(v) for v in rng.randint(0, tf.order, size=64)]
    ys = [int(v) for v in rng.randint(1, tf.order, size=64)]
    if op == "batch_inv":
        assert tf.batch_inv(xs) == jf.batch_inv(xs)
        return
    for x, y in zip(xs, ys):
        if op in ("add", "sub", "mul"):
            args = (x, y)
        elif op == "pow":
            args = (x, y * 7 + 3)
        elif op == "inv":
            args = (y,)
        else:
            args = (x,)
        got = getattr(tf, op)(*args)
        assert got == getattr(jf, op)(*args), (op, args)
    if op == "inv":
        assert all(tf.mul(y, tf.inv(y)) == 1 for y in ys)


def test_field_construction_and_irreducibility():
    for poly in range(2, 1 << 9):
        assert tfb.is_irreducible(poly) == jfb.is_irreducible(poly)
    with pytest.raises(ValueError):
        tfb.F2m(9, (1 << 9) | 1)  # x^9 + 1 = (x + 1)(...)
    with pytest.raises(ValueError):
        tfb.F2m(8, tfb.GF512.modulus)
    assert not tecb.is_odd(tfb.GF512) and tecb.is_odd(7)


def _maps(maps):
    return [(r.numerator, r.denominator, r.field.m, r.field.modulus)
            for r in maps]


def test_isogeny_chain_matches_the_jax_package():
    tc = tecb.GoodCurveEven.new_even(tfb.GF512, 2)
    jc = jecb.GoodCurveEven.new_even(jfb.GF512, 2)
    tg, jg = tecb.PointB(7, 466, tc), jecb.PointB(7, 466, jc)
    assert tc.contains(7, 466)
    tchain = tecb.find_isogeny_chain_even(tg)
    jchain = jecb.find_isogeny_chain_even(jg)
    assert len(tchain) == len(jchain) == 9
    for t, j in zip(tchain, jchain):
        assert _maps([t.r, t.g, t.h]) == _maps([j.r, j.g, j.h])
        assert (t.domain.b, t.codomain.b) == (j.domain.b, j.codomain.b)
    tp = [(q.x, q.y) for q in tecb.curve_points(tc)]
    assert tp == [(q.x, q.y) for q in jecb.curve_points(jc)]
    assert len(tp) + 1 == 512  # the affine points and O: #E = 2^9


@pytest.fixture(scope="module")
def trees():
    tt = thost.build_host_fftree_even(tfb.GF512, N)
    jt = jhost.build_host_fftree_even(jfb.GF512, N)
    assert tt is not None and jt is not None
    return tt, jt


def test_even_tree_build_matches_the_jax_package(trees):
    tt, jt = trees
    assert tt.f_layers == jt.f_layers
    assert _maps(tt.rational_maps) == _maps(jt.rational_maps)
    for name in ("recombine_layers", "decompose_layers", "xnn_s", "z0_s1",
                 "z1_s0", "z0z0_rem_xnn_s", "z1z1_rem_xnn_s"):
        assert getattr(tt, name) == getattr(jt, name), name


def _naive(F, coeffs, x):
    acc = 0
    for c in reversed(coeffs):
        acc = F.add(F.mul(acc, x), c)
    return acc


CASES = ["enter", "exit", "extend-S0", "extend-S1", "mextend-S0",
         "mextend-S1", "degree", "redc-z0", "redc-z1", "mod", "vanish"]


@pytest.mark.parametrize("case", CASES)
def test_even_tree_algorithms_match_the_jax_package(trees, case):
    tt, jt = trees
    F = tt.F
    rng = np.random.RandomState(17)
    full = [int(v) for v in rng.randint(0, F.order, size=N)]
    half = full[: N // 2]
    method, args = {
        "enter": ("enter", (full,)),
        "exit": ("exit", (full,)),
        "extend-S0": ("extend", (half, S0)),
        "extend-S1": ("extend", (half, S1)),
        "mextend-S0": ("mextend", (half, S0)),
        "mextend-S1": ("mextend", (half, S1)),
        "degree": ("degree", (tt.enter(half + [0] * (N // 2)),)),
        "redc-z0": ("redc_z0", (full, tt.xnn_s)),
        "redc-z1": ("redc_z1", (full, tt.xnn_s)),
        "mod": ("modular_reduce", (full, tt.xnn_s, tt.z0z0_rem_xnn_s)),
        "vanish": ("vanish", (half,)),
    }[case]
    got = getattr(tt, method)(*args)
    assert got == getattr(jt, method)(*args)
    if case == "enter":
        assert got == [_naive(F, full, x) for x in tt.eval_domain()]
    if case == "exit":
        assert tt.enter(got) == full
    if case == "degree":
        assert got < N // 2
    if case == "vanish":  # Z(x) = prod (x - a_i) over the whole domain
        dom = tt.eval_domain()
        want = []
        for x in dom:
            acc = 1
            for a in half:
                acc = F.mul(acc, F.sub(x, a))
            want.append(acc)
        assert got == want
