"""The EXTEND emitter's exact 2-mul fallback (``ops/emit.py::_emit_extend``
when the pool flags ``unscaled``, for a field with a zero Lemma-3.2
diagonal entry), forced on trees that do not need it in both packages: an
M31 tree at n = 64 and a secp256k1 tree at n = 32.

- ENTER, EXIT, EXTEND, MEXTEND and MOD schedules equal the JAX package's
  (``ecfft_tpu/ops/schedule.py::_emit_extend``) array for array;
- ENTER on both executors equals the native engine, and EXIT goes back;
- EXTEND (onto S0 and S1) and MOD equal the unscheduled forms, which read
  the matrices directly.

Inputs from a numpy seed, B = 2; tolerance: none (exact)."""

import types
from unittest import mock

import numpy as np
import pytest
import torch

from ecfft_tpu.native import build_fftree_native as jbuild
from ecfft_tpu.ops import schedule as jsch
from ecfft_tpu_torch import build_fftree_native
from ecfft_tpu_torch.native import NativeFFTree
from ecfft_tpu_torch.ops import emit
from ecfft_tpu_torch.ops import unrolled as tur

S0, S1 = emit.S0, emit.S1
TREES = {"m31": 64, "secp256k1": 32}
EXECUTORS = ["scan", "unrolled"]


def _jax_offsets(field, n):
    """The JAX package's pool offsets for its native-built tree, from its
    own ``build_pool`` with the pool's array (one jitted computation,
    which these checks do not read) left unbuilt."""
    with mock.patch.object(jsch, "_build_pool_arrays",
                           lambda *a: None), \
            mock.patch.object(jsch, "_host_batch_inv", lambda *a: None):
        return jsch.build_pool(jbuild(field, n))[1]


def _forced(tree):
    tree._ensure_pool()
    assert not tree._pool_off.get("unscaled", False)
    tree._pool_off["unscaled"] = True
    return tree


@pytest.fixture(scope="module")
def trees():
    """field → ({executor: port tree}, the JAX emitters' tree argument,
    native engine), each with the fallback forced before any schedule is
    emitted."""
    out = {}
    for field, n in TREES.items():
        port = {ex: _forced(build_fftree_native(field, n, device="cpu"))
                for ex in EXECUTORS}
        joff = _jax_offsets(field, n)
        assert joff == {k: v for k, v in port["scan"].pool_offsets.items()
                        if k != "unscaled"}
        joff["unscaled"] = True
        out[field] = (port, types.SimpleNamespace(pool_offsets=joff),
                      NativeFFTree(field, n))
    return out


@pytest.fixture
def executor(request, monkeypatch):
    ex = request.getfixturevalue("ex")
    if ex == "unrolled":
        monkeypatch.setenv("ECFFT_EXECUTOR", "unrolled")
        monkeypatch.setattr(tur, "TW", 8)


def _schedules(n):
    """name → (emitter, its arguments after the offsets)."""
    return {"enter": ("enter_schedule", (n,)),
            "exit": ("exit_schedule", (n,)),
            "extend-S0": ("extend_schedule", (n // 2, S0)),
            "extend-S1": ("extend_schedule", (n // 2, S1)),
            "mextend-S1": ("extend_schedule", (n // 2, S1, True)),
            "mod": ("mod_schedule", (n,))}


@pytest.mark.parametrize("name", list(_schedules(4)))
@pytest.mark.parametrize("field", list(TREES))
def test_unscaled_schedules_match_jax(trees, field, name):
    port, jt, _ = trees[field]
    fn, args = _schedules(TREES[field])[name]
    got = getattr(emit, fn)(port["scan"].pool_offsets, *args)
    ref = getattr(jsch, fn)(jt, *args)
    assert (got.W, got.A, got.bs_max) == (ref.W, ref.A, ref.bs_max)
    for g, r in zip(got.xs, ref.xs):
        np.testing.assert_array_equal(g, np.asarray(r))
    # the fallback's exact 2-mul steps, and no running-diagonal micro-op
    ops, dp = got.xs[0], got.xs[3]
    assert (ops == emit.OP_AFFINE).any()
    assert not dp[ops == emit.OP_AFFINE, emit.DP_DOP].any()


def _vals(spec, rng, *shape):
    w = rng.randint(0, 1 << 16, size=(*shape, 16))
    flat = [sum(int(x) << (16 * i) for i, x in enumerate(row)) % spec.p
            for row in w.reshape(-1, 16)]
    return np.array(flat, dtype=object).reshape(shape).tolist()


@pytest.mark.parametrize("ex", EXECUTORS)
@pytest.mark.parametrize("field", list(TREES))
def test_unscaled_enter_matches_native(trees, executor, field, ex):
    port, _, nt = trees[field]
    tree, n = port[ex], TREES[field]
    x = _vals(tree.spec, np.random.RandomState(5), 2, n)
    out = tree.enter(tree.encode(x))
    for b in range(2):
        assert [int(v) for v in tree.decode(out[b])] == nt.enter(x[b])
    assert torch.equal(tree.exit(out), tree.encode(x))


@pytest.mark.parametrize("ex", EXECUTORS)
@pytest.mark.parametrize("field", list(TREES))
def test_unscaled_extend_and_mod_match_unscheduled(trees, executor, field,
                                                   ex):
    port, _, _ = trees[field]
    tree, n = port[ex], TREES[field]
    rng = np.random.RandomState(6)
    half = tree.encode(_vals(tree.spec, rng, 2, n // 2))
    for moiety in (S0, S1):
        assert torch.equal(tree.extend(half, moiety),
                           tree.extend_unscheduled(half, moiety))
    assert torch.equal(tree.mextend(half, S1),
                       tree.mextend_unscheduled(half, S1))
    full = tree.encode(_vals(tree.spec, rng, 2, n))
    a, c = tree.tables[n]["xnn_s"], tree.tables[n]["z0z0_rem_xnn_s"]
    assert torch.equal(tree.modular_reduce(full),
                       tree.modular_reduce_unscheduled(full, a, c))
