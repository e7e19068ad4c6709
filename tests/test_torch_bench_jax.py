"""The port's main bench against the JAX package at secp256k1, n = 64,
B = 3, on the CPU: the tree file that ``ecfft_tpu.serialize_native`` wrote
is the tree the bench loads, and the bench's first-call ENTER equals the
JAX package's ENTER on the same gate inputs (tolerance: 0 differing
limbs). One JAX scan compile."""

import jax.numpy as jnp
import numpy as np
import pytest

import ecfft_tpu_torch.bench as bench
from ecfft_tpu.native import build_fftree_native
from ecfft_tpu.serialize_native import save_tables_npz
from ecfft_tpu_torch import FFTree, fftree

FIELD, N, BATCH = "secp256k1", 64, 3


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The JAX tree saved where the bench reads its cache, then one bench
    run on the CPU with the native builder taken away; returns the JAX
    tree, the tree the bench ran and its first call's (input, output)."""
    tmp = tmp_path_factory.mktemp("bench")
    jt = build_fftree_native(FIELD, N)
    save_tables_npz(jt, str(tmp / f".bench_tree_{FIELD}_{N}.npz"))
    calls = []
    enter = FFTree.enter

    def spy(self, x):
        out = enter(self, x)
        calls.append((self, x.clone(), out.clone()))
        return out

    def no_build(*a, **k):
        raise AssertionError("the bench built a tree it should have loaded")

    with pytest.MonkeyPatch.context() as mp:
        for k, v in (("ECFFT_BENCH_DEVICE", "cpu"), ("ECFFT_BENCH_N", N),
                     ("ECFFT_BENCH_BATCH", BATCH), ("ECFFT_BENCH_REPS", 1),
                     ("ECFFT_BENCH_FIELD", FIELD)):
            mp.setenv(k, str(v))
        mp.delenv("ECFFT_EXECUTOR", raising=False)
        mp.setattr(bench, "CACHE_DIR", str(tmp))
        mp.setattr(FFTree, "enter", spy)
        mp.setattr(fftree, "build_fftree_native", no_build)
        bench.main()
    return jt, calls[0]


def test_the_bench_loads_the_jax_packages_tree_file(run):
    jt, (tree, _, _) = run
    assert tree.n == N and tree.spec.name == FIELD
    assert sorted(tree.tables) == sorted(jt.tables)
    for m, t in jt.tables.items():
        for name, v in t.items():
            if name == "ext":
                continue
            got = tree.tables[m][name]
            if name == "mats":
                assert len(got) == len(v)
                for gq, wq in zip(got, v):
                    for g, w in zip(gq, wq):
                        np.testing.assert_array_equal(
                            g.numpy().astype(np.uint32), np.asarray(w))
            else:
                np.testing.assert_array_equal(
                    got.numpy().astype(np.uint32), np.asarray(v))


def test_the_first_call_equals_the_jax_enter(run):
    jt, (_, coeffs, out) = run
    want = np.asarray(jt.enter(jnp.asarray(coeffs.numpy().astype(np.uint32))))
    got = out.numpy().astype(np.uint32)
    assert int((got != want).sum()) == 0
