"""MOD by a modulus table given at run time on a secp256k1 tree at
n = 256, on the CPU on both executors, against the native engine and
the canonical MOD by the tree's own X^(n/2) (the same a and c as tables):
the general-modulus schedule's Fermat chain of about 500 OP_MUL steps over
a 256-point window (the JAX package's ``tests/test_scheduled_secp.py``
holds its own the same way). Inputs from a numpy seed; tolerance: none."""

import numpy as np
import pytest

from ecfft_tpu_torch import build_fftree_native
from ecfft_tpu_torch.native import NativeFFTree
from ecfft_tpu_torch.ops import unrolled as tur

N = 256


@pytest.fixture(scope="module")
def trees():
    return ({ex: build_fftree_native("secp256k1", N, device="cpu")
             for ex in ("scan", "unrolled")}, NativeFFTree("secp256k1", N))


@pytest.mark.parametrize("ex", ["scan", "unrolled"])
def test_general_modulus_mod_n256_matches_native(trees, monkeypatch, ex):
    if ex == "unrolled":
        monkeypatch.setenv("ECFFT_EXECUTOR", "unrolled")
        monkeypatch.setattr(tur, "TW", 8)
    tree, nt = trees[0][ex], trees[1]
    rng = np.random.RandomState(24)
    w = rng.randint(0, 1 << 16, size=(N, 16))
    vals = [sum(int(x) << (16 * i) for i, x in enumerate(row)) % tree.spec.p
            for row in w]
    enc = tree.encode([vals])
    a, c = tree.tables[N]["xnn_s"], tree.tables[N]["z0z0_rem_xnn_s"]
    got = tree.modular_reduce(enc, a, c)
    want = nt.modular_reduce(vals, [int(v) for v in tree.decode(a)],
                             [int(v) for v in tree.decode(c)])
    assert [int(v) for v in tree.decode(got[0])] == want
    assert (got == tree.modular_reduce(enc)).all()
