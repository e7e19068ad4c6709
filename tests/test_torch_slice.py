"""The port's ENTER/EXIT slice on the CPU, held bit-exact against the JAX
package on the same tree: the coefficient pool and its offsets, the
ENTER/EXIT schedules, the executor's index synthesis, and the transforms
themselves at secp256k1 n = 256, B = 4 (against the JAX FFTree, the native
engine, and as an EXIT∘ENTER round trip). Tolerance: 0 differing limbs.

The JAX reference outputs are computed once per module."""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecfft_tpu.native import NativeFFTree, build_fftree_native
from ecfft_tpu.ops import schedule as jsch
from ecfft_tpu_torch import FFTree
from ecfft_tpu_torch import build_fftree_native as build_port_tree
from ecfft_tpu_torch.convert import tables_from_numpy
from ecfft_tpu_torch.errors import SizeError
from ecfft_tpu_torch.ops import emit
from ecfft_tpu_torch.ops import schedule as tsch

FIELD, N, BATCH = "secp256k1", 256, 4


@pytest.fixture(scope="module")
def trees():
    """The JAX tree and the port's tree on the same tables, plus a
    numpy-seeded batch of coefficients and the JAX outputs."""
    jt = build_fftree_native(FIELD, N)
    np_tables = {
        m: {k: ([tuple(np.asarray(a) for a in q) for q in v]
                if k == "mats" else np.asarray(v)) for k, v in t.items()}
        for m, t in jt.tables.items()}
    tt = FFTree(FIELD, N, tables_from_numpy(np_tables), device="cpu")
    rng = np.random.RandomState(7)
    top = jt.spec.to_limbs(jt.spec.p)[-1]
    coeffs = rng.randint(0, 1 << 16, size=(BATCH, N, 16)).astype(np.uint32)
    coeffs[..., -1] = rng.randint(0, top, size=(BATCH, N))
    evals = np.asarray(jt.enter(jnp.asarray(coeffs)))
    back = np.asarray(jt.exit(jnp.asarray(evals)))
    return jt, tt, coeffs, evals, back


def test_trees_default_to_the_card():
    """A tree lives on the card unless the caller names another device;
    building one touches no device, so this needs no card."""
    assert FFTree(FIELD, N, {}).device.type == "cuda"
    assert build_port_tree(FIELD, 16).device.type == "cuda"


def test_pool_and_offsets_match_jax(trees):
    jt, tt, *_ = trees
    tt.prepare(())
    assert tt.pool_offsets == jt.pool_offsets
    assert "unscaled" not in tt.pool_offsets
    np.testing.assert_array_equal(tt._pool.numpy().astype(np.uint32),
                                  np.asarray(jt._pool))


@pytest.mark.parametrize("alg", ["enter", "exit"])
def test_schedules_match_jax(trees, alg):
    jt, tt, *_ = trees
    emitter = {"enter": jsch.enter_schedule, "exit": jsch.exit_schedule}
    ref = emitter[alg](jt, N)
    got = getattr(emit, f"{alg}_schedule")(tt.pool_offsets, N)
    assert (got.W, got.A, got.bs_max) == (ref.W, ref.A, ref.bs_max)
    assert len(got.xs) == len(ref.xs) == 6
    for g, r in zip(got.xs, ref.xs):
        np.testing.assert_array_equal(g, np.asarray(r))


@pytest.mark.parametrize("alg", ["enter", "exit"])
def test_index_synthesis_matches_numpy_formula(trees, alg):
    """The executor's torch synthesis equals the builder's numpy formula
    (which the builder verified against every emitted row) on every
    formula column of every step, over each step's window."""
    _, tt, *_ = trees
    s = getattr(emit, f"{alg}_schedule")(tt.pool_offsets, N)
    ops, starts, colp, _, rid, _ = s.xs
    q = torch.arange(s.A)
    for t in range(len(ops)):
        for ci in range(4):
            if rid[t, ci] >= 0:
                continue
            full = emit._synth_np(colp[t, ci], s.W)
            win = full[starts[t]:starts[t] + s.A]
            got = tsch._synth(colp[t, ci], q + int(starts[t]))
            np.testing.assert_array_equal(got.numpy(), win)


def test_enter_matches_jax_and_native(trees):
    jt, tt, coeffs, evals, _ = trees
    got = tt.enter(torch.from_numpy(coeffs.astype(np.int32)))
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), evals)
    nt = NativeFFTree(FIELD, N)
    spec = jt.spec
    for b in range(BATCH):
        ints = [spec.from_limbs(limbs) for limbs in coeffs[b]]
        assert list(tt.decode(got[b])) == nt.enter(ints), b


def test_batch_chunks_give_the_same_result(trees, monkeypatch):
    """Where the card's memory holds fewer lanes than the batch, the
    executor runs the batch in chunks: here 3 + 1 lanes."""
    _, tt, coeffs, evals, _ = trees
    monkeypatch.setattr(tsch, "_lanes_per_chunk", lambda *a: 3)
    got = tt.enter(torch.from_numpy(coeffs.astype(np.int32)))
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), evals)


def _card_memory(monkeypatch, free: int):
    """Make the executor's budget read ``free`` bytes free on a card."""
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda device=None: (free, 80 << 30))
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda device=None: 0)
    monkeypatch.setattr(torch.cuda, "memory_allocated",
                        lambda device=None: 0)


@pytest.mark.parametrize("free", ["6GB", "3GB", "buffers-only"])
def test_chunk_budget_at_the_main_path_shapes(monkeypatch, free):
    """ENTER at n = 2^16, B = 256 (W 131200, A 65536, 32768 D-engine
    rows): 6 GB free runs the batch whole, 3 GB chunks it within the
    budget, and a budget that holds two lanes' state and gather temps
    and the output but no step temporaries is refused."""
    sched = types.SimpleNamespace(W=131200, A=65536, bs_max=32768)
    L, B, m = 16, 256, 1 << 16
    per_lane, fixed = tsch._chunk_bytes(sched, L, B, m)
    dev = torch.device("cuda", 0)
    if free == "buffers-only":
        _card_memory(monkeypatch, B * m * L * 4 + 2 * per_lane)
        with pytest.raises(SizeError):
            tsch._lanes_per_chunk(sched, L, B, m, dev)
        return
    budget = int(free[:-2]) * 10**9
    _card_memory(monkeypatch, budget)
    lanes = tsch._lanes_per_chunk(sched, L, B, m, dev)
    assert fixed + lanes * per_lane <= budget
    if free == "6GB":
        assert lanes == B
    else:
        assert 1 <= lanes < B


def test_exit_matches_jax_and_round_trips(trees):
    jt, tt, coeffs, evals, back = trees
    got = tt.exit(torch.from_numpy(evals.astype(np.int32)))
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), back)
    np.testing.assert_array_equal(back, coeffs)
    nt = NativeFFTree(FIELD, N)
    ints = [jt.spec.from_limbs(limbs) for limbs in evals[0]]
    assert list(tt.decode(got[0])) == nt.exit(ints)


def test_subtree_sizes_and_size_checks(trees):
    """A size-N tree serves smaller power-of-two sizes (here 64, with a
    leading batch shape; the native engine's subtree is the reference)
    and rejects the rest."""
    jt, tt, coeffs, *_ = trees
    small = coeffs[:2, :64].reshape(2, 1, 64, 16)
    got = tt.enter(torch.from_numpy(small.astype(np.int32)))
    assert got.shape == small.shape
    nt = NativeFFTree(FIELD, N)
    for b in range(2):
        ints = [jt.spec.from_limbs(limbs) for limbs in small[b, 0]]
        assert list(tt.decode(got[b, 0])) == nt.enter(ints), b
    for m in (48, 2 * N):
        with pytest.raises(SizeError):
            tt.enter(torch.zeros((1, m, 16), dtype=torch.int32))
    with pytest.raises(ValueError):
        tt.enter(torch.zeros((1, 64, 16), dtype=torch.int64))
