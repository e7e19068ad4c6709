"""All eight FFTree algorithms over the general prime on the CPU, on both
executors, against the native engine, bit for bit (tolerance: 0 differing
limbs): the CIOS form at 16 limbs (the STARK prime) and at an odd limb
count (3), where every resident is in Montgomery form, so the modulus
tables of the general REDC and MOD, VANISH's points and DEGREE's
accumulator all ride the state in that form. n = 64 (EXTEND, MEXTEND and
VANISH on 32 points; the general modulus on 16); the unrolled executor at
TW = 8, where these sizes emit every fused form. Imports no JAX."""

import ctypes
import os
import sys

import numpy as np
import pytest
import torch

from ecfft_tpu_torch import S0, S1, build_fftree_native
from ecfft_tpu_torch import native
from ecfft_tpu_torch.ops import unrolled as tur

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_general_fields import register  # noqa: E402

N = 64
EXECUTORS = ["scan", "unrolled"]
FIELDS = ["gp_stark", "gp_cios3"]
ALGORITHMS = ["enter-exit", "extend", "mextend", "degree", "redc_z0",
              "redc_z1", "modular_reduce", "vanish", "general-redc_z0",
              "general-redc_z1", "general-modular_reduce"]


@pytest.fixture(scope="module")
def trees():
    """Per field, a native-built port tree per executor (a tree keeps its
    unrolled analysis) and the native engine."""
    specs = register()
    return {name: ({ex: build_fftree_native(name, N, device="cpu")
                    for ex in EXECUTORS},
                   native.NativeFFTree(specs[name], N)) for name in FIELDS}


def _redc_native(nt, evals, a, moiety):
    """The engine's REDC by Z0 (moiety 0) or Z1 (1) with modulus table a."""
    out = ctypes.create_string_buffer(32 * len(evals))
    native.lib().ecn_redc(nt._h, native._pack(evals), native._pack(a),
                          len(evals), moiety, out)
    return native._unpack(out.raw)


@pytest.mark.parametrize("ex", EXECUTORS)
@pytest.mark.parametrize("alg", ALGORITHMS)
@pytest.mark.parametrize("name", FIELDS)
def test_algorithm_matches_native(trees, monkeypatch, name, alg, ex):
    if ex == "unrolled":
        monkeypatch.setenv("ECFFT_EXECUTOR", "unrolled")
        monkeypatch.setattr(tur, "TW", 8)
    else:
        monkeypatch.delenv("ECFFT_EXECUTOR", raising=False)
    by_ex, nt = trees[name]
    tree = by_ex[ex]
    p = tree.spec.p
    rng = np.random.RandomState(sum(map(ord, alg + name)))
    m = N // 2 if alg in ("extend", "mextend", "vanish") else N
    if alg.startswith("general"):
        m = 16

    def draw(k, lo=0):
        return [lo + int.from_bytes(rng.bytes(40), "little") % (p - lo)
                for _ in range(k)]

    x = [draw(m) for _ in range(2)]
    X = tree.encode(x)

    def ints(t):
        return [int(v) for v in tree.decode(t)]

    if alg == "enter-exit":
        ev = tree.enter(X)
        assert [ints(e) for e in ev] == [nt.enter(v) for v in x]
        assert torch.equal(tree.exit(ev), X)
        return
    if alg in ("extend", "mextend"):
        for mo in (S0, S1):
            got = getattr(tree, alg)(X, mo)
            assert [ints(g) for g in got] == [getattr(nt, alg)(v, mo)
                                              for v in x]
        return
    if alg == "degree":
        degs = [0, 1, N // 2, N - 1]
        cs = [[draw(1, 1)[0] if i <= d else 0 for i in range(N)]
              for d in degs]
        ev = tree.encode([nt.enter(c) for c in cs])
        assert tree.degree(ev).tolist() == degs
        return
    if alg == "vanish":
        got = tree.vanish(X)
        assert tuple(got.shape) == (2, 2 * m, tree.spec.num_limbs)
        assert [ints(g) for g in got] == [nt.vanish(v) for v in x]
        return
    if alg.startswith("general"):
        a, c = draw(m, 1), draw(m)
        A_, C_ = tree.encode(a), tree.encode(c)
    else:
        a, c = nt.table(m, "xnn_s"), nt.table(m, "z0z0_rem_xnn_s")
    method = alg.split("-")[-1]
    if method == "modular_reduce":
        got = (tree.modular_reduce(X, A_, C_) if alg.startswith("general")
               else tree.modular_reduce(X))
        want = [nt.modular_reduce(v, a, c) for v in x]
    else:
        moiety = int(method[-1])
        got = (getattr(tree, method)(X, A_) if alg.startswith("general")
               else getattr(tree, method)(X))
        want = [_redc_native(nt, v, a, moiety) for v in x]
    assert [ints(g) for g in got] == want
