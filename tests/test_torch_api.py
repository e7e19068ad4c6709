"""The port's public surface against the JAX package's: the names it
exports (``S0``, ``S1``, ``build_fftree``), ``eval_domain`` on both fields
(the facade's and the native engine's), ``prepare(())``, the fields a
tree takes (every odd prime of 2 to 16 limbs, on the card and the CPU;
a prime of one 16-bit limb without a fold refused at construction,
naming the cause),
and DEGREE's decode of a one-limb accumulator. Needs no card: building a
tree touches no device."""

import numpy as np
import pytest
import torch

import ecfft_tpu
import ecfft_tpu_torch as ec
from ecfft_tpu.native import build_fftree_native as jbuild
from ecfft_tpu_torch import FFTree
from ecfft_tpu_torch.fields import device as fd
from ecfft_tpu_torch.fields.registry import spec_for_prime
from ecfft_tpu_torch.native import NativeFFTree
from ecfft_tpu_torch.ops import step


def test_exports_match_the_jax_package():
    for name in ("S0", "S1", "build_fftree"):
        assert name in ec.__all__ and name in ecfft_tpu.__all__
    assert (ec.S0, ec.S1) == (ecfft_tpu.S0, ecfft_tpu.S1) == (0, 1)
    tree = ec.build_fftree("m31", 16, device="cpu")
    assert isinstance(tree, FFTree) and tree.n == 16
    assert tree.device.type == "cpu"
    assert ec.build_fftree("m31", 16).device.type == "cuda"
    assert ec.build_fftree("m31", 1 << 29, device="cpu") is None


@pytest.mark.parametrize("field", ["secp256k1", "m31"])
def test_eval_domain_matches_jax(field):
    jt = jbuild(field, 16)
    tt = ec.build_fftree(field, 16, device="cpu")
    nt = NativeFFTree(field, 16)
    for size in (None, 16, 4, 2):
        want = [int(v) for v in jt.eval_domain(size)]
        assert [int(v) for v in tt.eval_domain(size)] == want
        assert nt.eval_domain(size) == want
    assert len(want) == 2


def test_prepare_with_no_sizes_builds_size_n():
    tree = ec.build_fftree("m31", 32, device="cpu")
    assert tree.prepare(()) is tree
    assert {("enter", 32), ("exit", 32)} <= set(tree._scheds)
    tree = ec.build_fftree("m31", 32, device="cpu")
    assert tree.pool_offsets and not tree._scheds  # the pool alone
    tree.prepare((8,))
    assert set(tree._scheds) == {("enter", 8), ("exit", 8)}


M61 = spec_for_prime((1 << 61) - 1)          # 4 limbs, fold-friendly
WIDE_FOLD = spec_for_prime((1 << 256) - 1053)  # 16 limbs, fold digit 1053
CIOS = spec_for_prime(  # no pseudo-Mersenne fold
    0x0800000000000011000000000000000000000000000000000000000000000001)
ONE_LIMB = spec_for_prime(40961)  # one 16-bit limb, no fold
ONE_LIMB_FOLD = spec_for_prime(65521)  # one 16-bit limb, F = 15


@pytest.mark.parametrize("spec,form", [
    (M61, "fold4"), (WIDE_FOLD, "fold16"), (CIOS, "cios16"),
    (ONE_LIMB, None), (ONE_LIMB_FOLD, "fold1")],
    ids=["m61", "wide-fold", "cios", "one-limb", "one-limb-fold"])
def test_unsupported_field_is_refused_for_the_card(spec, form):
    """Every odd prime of 2 to 16 limbs, and every one of one 16-bit limb
    with a pseudo-Mersenne fold, has a form of the kernels: a tree takes
    it on the card (the default device) and on the CPU, where its product
    computes (canonical, whether the residents are canonical or
    Montgomery). Only a prime of one 16-bit limb without a fold is
    refused, naming the cause, on every device."""
    if form is None:
        for make in (lambda: FFTree(spec, 16, {}),
                     lambda: FFTree(spec, 16, {}, device="cuda"),
                     lambda: FFTree(spec, 16, {}, device="cpu"),
                     lambda: ec.build_fftree_native(spec, 16)):
            with pytest.raises(NotImplementedError, match="one 16-bit limb"):
                make()
        return
    assert FFTree(spec, 16, {}).device.type == "cuda"
    assert FFTree(spec, 16, {}, device="cuda").spec is spec
    assert FFTree(spec, 16, {}, device="cpu").device.type == "cpu"
    assert step.kernel_form(spec) == form
    a = [0, 1, spec.p - 1, spec.p // 3, spec.r % spec.p]
    b = [spec.p - 1, 5, spec.p - 2, spec.p // 7, spec.r % spec.p]
    got = fd.decode(spec, fd.mul(spec, fd.encode(spec, a),
                                 fd.encode(spec, b)))
    assert list(got) == [x * y % spec.p for x, y in zip(a, b)]


def test_the_card_takes_m31_and_secp256k1():
    for field in ("m31", "secp256k1"):
        assert FFTree(field, 16, {}, device="cuda").spec.name == field


def test_degree_decodes_a_one_limb_accumulator():
    """DEGREE over M31, whose accumulator is one 32-bit limb (there is no
    second limb to read): every degree below 64 in one batch, and the
    one-point case."""
    n = 64
    tree = ec.build_fftree("m31", n, device="cpu")
    nt = NativeFFTree("m31", n)
    rng = np.random.RandomState(2)
    degs = list(range(n))
    cs = [[int(rng.randint(1, tree.spec.p)) if i <= d else 0
           for i in range(n)] for d in degs]
    ev = tree.encode([nt.enter(c) for c in cs])
    got = tree.degree(ev)
    assert got.dtype == torch.int32 and got.tolist() == degs
    one = tree.degree(tree.encode([[5], [0]]))
    assert one.tolist() == [0, 0]
