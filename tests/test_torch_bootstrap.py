"""The port's device bootstrap, ``FFTree.build(field, n, device=...)``, on
the CPU: its tables against the JAX package's bootstrap (M31, n = 16) and
the native engine's (M31 n = 256, secp256k1 n = 32, 2^256 − 1053 n = 16,
a 3-limb CIOS prime n = 16, the one-limb fold prime 64513 n = 64), every
table of every size and each ``mats`` plane, bit for bit; the 2-to-1
check of each rational map; None past the curve's two-adicity; a refusal
where no card is. Also the field ops it runs: the plain versions of
``fields.device`` and the kernel dispatch of ``ops.step`` (on the CPU,
the kernels' plain versions) against the JAX package's field ops and
Python ints. The arithmetic is exact: no tolerance."""

import os
import random
import sys

import numpy as np
import pytest
import torch

from ecfft_tpu.fftree import FFTree as JFFTree
from ecfft_tpu.fields import device as jfd
from ecfft_tpu.fields import registry as jreg
from ecfft_tpu_torch import fftree as tfftree
from ecfft_tpu_torch.errors import TreeConstructionError
from ecfft_tpu_torch.fftree import FFTree, build_fftree_native
from ecfft_tpu_torch.fields import device as fd
from ecfft_tpu_torch.fields.registry import (FIELDS, register_field,
                                             spec_for_prime)
from ecfft_tpu_torch.ops import step

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_general_fields import register  # noqa: E402

GENERAL = register(jreg)
# 64513 = 2^16 − 1023 on a curve FIND_CURVE found (2-adicity 10; the
# host's isogeny chain builds trees up to n = 64 on it)
FOLD1 = register_field("gp_fold1", 64513, 17298, 51821, (48076, 63964),
                       (37303, 46450), 10)


def _assert_same_tables(got, want):
    """Every table of every size, and each plane of every ``mats`` depth,
    equal bit for bit (``want``'s values as numpy or tensors)."""
    assert sorted(got) == sorted(want)
    for m, t in want.items():
        assert sorted(got[m]) == sorted(t), m
        for name, v in t.items():
            if name == "mats":
                assert len(got[m][name]) == len(v), (m, name)
                for d, (gq, wq) in enumerate(zip(got[m][name], v)):
                    for pi, (g, w) in enumerate(zip(gq, wq)):
                        np.testing.assert_array_equal(
                            g.numpy(), np.asarray(w).astype(np.int32),
                            err_msg=f"size {m} mats[{d}][{pi}]")
            else:
                assert got[m][name].dtype == torch.int32
                np.testing.assert_array_equal(
                    got[m][name].numpy(), np.asarray(v).astype(np.int32),
                    err_msg=f"size {m} {name}")


def test_bootstrap_matches_the_jax_bootstrap():
    tree = FFTree.build("m31", 16, device="cpu")
    jt = JFFTree.build("m31", 16)
    _assert_same_tables(tree.tables, jt.tables)
    assert tree.f_layers == jt.f_layers
    assert tree.device == torch.device("cpu")


@pytest.mark.parametrize("field,n", [
    ("m31", 256), ("secp256k1", 32), ("gp_band", 16), ("gp_cios3", 16),
    ("gp_fold1", 64)])
def test_bootstrap_matches_the_native_engine(field, n):
    tree = FFTree.build(field, n, device="cpu")
    native = build_fftree_native(field, n, device="cpu")
    _assert_same_tables(tree.tables, native.tables)
    assert tree.f_layers == native.f_layers
    # the tree works as a native-built one: the pool, the schedules and
    # the unscheduled forms (from the bootstrap's own EXTEND tables)
    x = tree.encode([[random.Random(n).randrange(tree.spec.p)
                      for _ in range(n)]])
    evals = native.enter(x)
    assert torch.equal(tree.enter(x), evals)
    assert torch.equal(tree.enter_unscheduled(x), evals)


def test_bootstrap_refuses_a_map_that_is_not_two_to_one(monkeypatch):
    leaves, maps = tfftree.build_domain(FIELDS["m31"], 16)
    swapped = [leaves[1], leaves[0], *leaves[2:]]
    monkeypatch.setattr(tfftree, "build_domain",
                        lambda spec, n: (swapped, maps))
    with pytest.raises(TreeConstructionError, match="rational map 0"):
        FFTree.build("m31", 16, device="cpu")


def test_bootstrap_returns_none_past_the_two_adicity():
    assert FFTree.build("secp256k1", 1 << 36, device="cpu") is None
    assert FFTree.build("m31", 1 << 32, device="cpu") is None
    assert FFTree.build("gp_fold1", 1 << 11, device="cpu") is None


def test_bootstrap_and_field_refusals():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            FFTree.build("m31", 16)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            FFTree.from_domain_layers("m31", [[1, 2]], [])
    with pytest.raises(NotImplementedError, match="fold"):
        FFTree.build(spec_for_prime(40961), 16, device="cpu")


# ------------------------------------------------------------ field ops

FIELD_OPS = ["secp256k1", "m31", "gp_band", "gp_cios3", "gp_m61"]


def _values(spec, rng, k):
    p = spec.p
    edge = [0, 1, 2, p - 1, p - 2, (p - 1) // 2]
    return edge + [rng.randrange(p) for _ in range(k - len(edge))]


@pytest.mark.parametrize("name", ["m31", "secp256k1"])
def test_field_ops_match_the_jax_package(name):
    """add, sub, neg, eq, square, pow_int (a short exponent), the fused
    muladd2 and (M31) mat2_apply of the plain versions and of the kernel
    dispatch, against the JAX package's ops on the same limbs."""
    spec, jspec = FIELDS[name], jreg.FIELDS[name]
    rng = random.Random(name)
    a, b = _values(spec, rng, 12), _values(spec, rng, 12)[::-1]
    ta, tb = fd.encode(spec, a), fd.encode(spec, b)
    ja, jb = (jfd.encode(jspec, v) for v in (a, b))

    def same(got, want):
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(want).astype(np.int32))

    same(fd.add(spec, ta, tb), jfd.add(jspec, ja, jb))
    same(fd.sub(spec, ta, tb), jfd.sub(jspec, ja, jb))
    same(fd.neg(spec, ta), jfd.neg(jspec, ja))
    assert fd.eq(spec, ta, tb).tolist() == np.asarray(
        jfd.eq(jspec, ja, jb)).tolist()
    for square, pow_int, muladd2 in (
            (fd.square, fd.pow_int, fd.muladd2),
            (step.square, step.pow_int, step.fused_muladd2)):
        same(square(spec, ta), jfd.square(jspec, ja))
        same(pow_int(spec, ta, 11), jfd.pow_int(jspec, ja, 11))
        same(muladd2(spec, ta, tb, tb, ta),
             jfd.muladd2(jspec, ja, jb, jb, ja))
    if name == "m31":
        m = torch.stack([torch.stack([ta, tb], -2),
                         torch.stack([tb, ta], -2)], -3)
        want = jfd.mat2_apply(jspec, m.numpy().astype(np.uint32), ja, jb)
        for mat2 in (fd.mat2_apply, step.mat2_apply):
            for got, w in zip(mat2(spec, m, ta, tb), want):
                same(got, w)


@pytest.mark.parametrize("name", FIELD_OPS)
def test_field_ops_match_python_ints(name):
    """Every op, plain and on the kernel dispatch, against Python ints:
    the fold form at 4 and 16 limbs (its band too), M31, and the CIOS
    form (Montgomery residents: the dispatch cancels the kernels' R⁻¹);
    inv maps 0 to 0; pow_int long and short."""
    spec = FIELDS[name]
    p = spec.p
    rng = random.Random(name)
    a, b = _values(spec, rng, 10), _values(spec, rng, 10)[::-1]
    ta, tb = fd.encode(spec, a), fd.encode(spec, b)

    def ints(t):
        return [int(v) for v in fd.decode(spec, t)]

    assert ints(fd.add(spec, ta, tb)) == [(v + w) % p for v, w in zip(a, b)]
    assert ints(fd.sub(spec, ta, tb)) == [(v - w) % p for v, w in zip(a, b)]
    assert ints(fd.neg(spec, ta)) == [-v % p for v in a]
    assert fd.eq(spec, ta, ta).all() and not fd.eq(spec, ta, tb).all()
    m = torch.stack([torch.stack([ta, tb], -2), torch.stack([tb, tb], -2)],
                    -3)
    e = (1 << 70) + 12345
    for mod in (fd, step):
        assert ints(mod.mul(spec, ta, tb)) == [v * w % p
                                               for v, w in zip(a, b)]
        assert ints(mod.square(spec, ta)) == [v * v % p for v in a]
        for k in (0, 1, 11, e):
            assert ints(mod.pow_int(spec, ta, k)) == [pow(v, k, p)
                                                      for v in a]
        assert ints(mod.inv(spec, ta)) == [pow(v, p - 2, p) for v in a]
        r0, r1 = mod.mat2_apply(spec, m, ta, tb)
        assert ints(r0) == [(v * v + w * w) % p for v, w in zip(a, b)]
        assert ints(r1) == [(w * v + w * w) % p for v, w in zip(a, b)]
    for muladd2 in (fd.muladd2, step.fused_muladd2):
        assert ints(muladd2(spec, ta, tb, tb, ta)) == [
            2 * v * w % p for v, w in zip(a, b)]


@pytest.mark.parametrize("name", ["gp_fold1", "secp256k1", "gp_cios3"])
def test_kernel_dispatch_counts_no_plain_product_on_the_cpu(name):
    """On the CPU the dispatch runs the kernels' plain versions through
    the wrappers, which count no launch; the result is the canonical
    product whatever the form (a CIOS form's R⁻¹ cancelled)."""
    spec = FIELDS[name]
    rng = random.Random(3)
    a, b = _values(spec, rng, 8), _values(spec, rng, 8)
    before = {w.__name__: sum(w.launches.values())
              for w in step.STEP_WRAPPERS}
    got = step.mul_windows(spec, fd.encode(spec, a).unsqueeze(-1),
                           fd.encode(spec, b).unsqueeze(-1))
    assert [int(v) for v in fd.decode(spec, got.squeeze(-1))] == [
        v * w % spec.p for v, w in zip(a, b)]
    rows = step.to_resident(spec, fd.encode(spec, a))
    got = step.mul2_window(spec, rows, rows, fd.encode(spec, b)[..., None],
                           fd.encode(spec, b)[..., None])
    assert [int(v) for v in fd.decode(spec, got.squeeze(-1))] == [
        2 * v * w % spec.p for v, w in zip(a, b)]
    assert before == {w.__name__: sum(w.launches.values())
                      for w in step.STEP_WRAPPERS}
