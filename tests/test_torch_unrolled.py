"""The port's unrolled executor (ecfft_tpu_torch/ops/unrolled.py) and its
kernels' plain versions on the CPU, held bit-exact against the JAX
package: the out-of-place steps against ``pallas_muladd1/2`` and the
fused levels against ``_fused_bf1``/``_fused_bf2``/``_fused_cascade``, all
in interpret mode; the fusion analysis against the JAX package's on the
same schedules; ENTER/EXIT through the executor against the JAX tree's
(scan executor) outputs and the native engine. Tolerance: 0 differing
limbs (the arithmetic is exact).

The fused levels run at a tile width TW of 8 rows (patched in both
packages), where the smallest schedules already emit every fused form.
The JAX reference outputs are computed once per module."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecfft_tpu.fields.registry import FIELDS as JFIELDS
from ecfft_tpu.native import NativeFFTree, build_fftree_native
from ecfft_tpu.ops import schedule as jsch
from ecfft_tpu.ops import unrolled as jur
from ecfft_tpu.ops.pallas_step import pallas_muladd1, pallas_muladd2
from ecfft_tpu_torch import FFTree
from ecfft_tpu_torch.convert import tables_from_numpy
from ecfft_tpu_torch.fields import device as fd
from ecfft_tpu_torch.fields.registry import FIELDS
from ecfft_tpu_torch.ops import emit, step
from ecfft_tpu_torch.ops import schedule as tsch
from ecfft_tpu_torch.ops import unrolled as tur

SPEC, JSPEC = FIELDS["secp256k1"], JFIELDS["secp256k1"]
P = SPEC.p
L = SPEC.num_limbs
EDGE = [0, 1, P - 1, P - 2, P // 2, 2**16, 2**255 % P, (P - 1) // 2]
FIELD, N, BATCH = "secp256k1", 64, 4


def _ints(rng, shape, edge: bool = False):
    """Canonical field values as python ints: edge values cycled, or
    numpy-drawn 16-bit limbs with a top limb below p's."""
    if edge:
        flat = [EDGE[i % len(EDGE)] for i in range(int(np.prod(shape)))]
        return np.asarray(flat, dtype=object).reshape(shape)
    limbs = rng.randint(0, 1 << 16, size=(*shape, L)).astype(np.int64)
    limbs[..., -1] = rng.randint(0, SPEC.to_limbs(P)[-1], size=shape)
    return fd.decode(SPEC, limbs)


def _layout(vals):
    """(rows, B) ints → (rows, L, B) int32 tensor."""
    return fd.encode(SPEC, vals).permute(0, 2, 1).contiguous()


def _u32(t):
    return t.numpy().astype(np.uint32)


def _j(t):
    return jnp.asarray(_u32(t))


@pytest.fixture
def tw8(monkeypatch):
    """TW = 8 rows in both packages, with the JAX executor's caches
    cleared before and after (their keys do not hold TW)."""
    monkeypatch.setattr(jur, "TW", 8)
    monkeypatch.setattr(tur, "TW", 8)
    jur._META_CACHE.clear()
    jur._SEG_CACHE.clear()
    yield
    jur._META_CACHE.clear()
    jur._SEG_CACHE.clear()


# ------------------------------------------------ out-of-place steps


@pytest.mark.parametrize("kind,edge", [(k, e) for k in ("muladd1", "muladd2")
                                       for e in (False, True)],
                         ids=["muladd1-random", "muladd1-edge",
                              "muladd2-random", "muladd2-edge"])
def test_muladd_matches_pallas_and_ints(kind, edge):
    W, B = 32, 4
    rng = np.random.RandomState(13)
    x1_i, x2_i = _ints(rng, (W, B), edge), _ints(rng, (W, B), edge)
    ca_i, cb_i = _ints(rng, (W,), edge), _ints(rng, (W,), edge)
    if edge:  # pair every edge coefficient with every edge value
        x2_i = x2_i[::-1].copy()
        cb_i = np.roll(cb_i, 3)
    x1, x2 = _layout(x1_i), _layout(x2_i)
    ca, cb = fd.encode(SPEC, ca_i), fd.encode(SPEC, cb_i)
    launches = [dict(w.launches) for w in step.STEP_WRAPPERS]
    got = torch.zeros_like(x2)
    if kind == "muladd1":
        step.muladd1(SPEC, cb, x1, x2, got, 0)
        ref = pallas_muladd1(JSPEC, _j(cb), _j(x1), _j(x2), True)
    else:
        step.muladd2(SPEC, ca, cb, x1, x2, got, 0)
        ref = pallas_muladd2(JSPEC, _j(ca), _j(cb), _j(x1), _j(x2), True)
    np.testing.assert_array_equal(_u32(got), np.asarray(ref))
    dec = fd.decode(SPEC, got.permute(0, 2, 1))
    for w in range(W):
        for b in range(B):
            a = ca_i[w] if kind == "muladd2" else 1
            assert dec[w, b] == (a * x1_i[w, b] + cb_i[w] * x2_i[w, b]) % P
    assert [dict(w.launches) for w in step.STEP_WRAPPERS] == launches


def test_muladd_takes_a_view_of_the_state_and_rejects_bad_operands():
    rng = np.random.RandomState(3)
    state = _layout(_ints(rng, (48, 2)))
    x2 = _layout(_ints(rng, (16, 2)))
    c = fd.encode(SPEC, _ints(rng, (16,)))
    got = torch.empty_like(x2)
    step.muladd1(SPEC, c, state[16:32], x2, got, 0)
    want = step._muladd1_cols(SPEC, c.unsqueeze(-1), state[16:32], x2)
    assert torch.equal(got, want.int())
    with pytest.raises(ValueError):
        step.muladd1(SPEC, c[:8], state[16:32], x2, got, 0)
    with pytest.raises(TypeError):
        step.muladd1(SPEC, c, state[16:32].long(), x2, got, 0)
    with pytest.raises(ValueError):
        step.muladd2(SPEC, c, c, state[16:32].transpose(0, 2), x2, got, 0)


# ------------------------------------------------------ fused levels


def _state_and_rows(rng, W, B, k, A, spec=SPEC):
    if spec is SPEC:
        state = _layout(_ints(rng, (W, B)))
        rows = [fd.encode(SPEC, _ints(rng, (A,))) for _ in range(k)]
        return state, rows
    # M31: one 32-bit limb, p − 1 in the first rows of the window's half
    def vals(*shape):
        x = rng.randint(0, spec.p, size=(*shape, 1))
        x[:2] = spec.p - 1
        return torch.from_numpy(x.astype(np.int32))
    return (vals(W, B).permute(0, 2, 1).contiguous(),
            [vals(A) for _ in range(k)])


@pytest.mark.parametrize("form", ["bf1-ht1", "bf1-ht2", "bf2-ht2",
                                  "cascade", "bf1-ht2-m31", "bf2-ht1-m31",
                                  "cascade-m31"])
def test_fused_levels_match_pallas(tw8, form):
    """Pair levels at half = TW and 2·TW (the 2-mul form at 2·TW, where
    the partner tile is two tiles away) with a non-zero window start, and
    a cascade of mixed kinds (two kind-1 levels, so the A rows pair by
    their own counter); rows outside the window stay as they were. The
    "-m31" forms run the same over M31, where the JAX kernels take their
    M31 tile functions."""
    rng = np.random.RandomState(17)
    B = 4
    spec, jspec = ((FIELDS["m31"], JFIELDS["m31"]) if form.endswith("-m31")
                   else (SPEC, JSPEC))
    form = form.removesuffix("-m31")
    launches = [dict(w.launches) for w in tur.FUSED_WRAPPERS]
    if form == "cascade":
        W, A, start = 32, 16, 8
        halves, kinds = (4, 1, 2), (1, 0, 1)
        state, rows = _state_and_rows(rng, W, B, 5, A, spec)
        cw, aw = torch.stack(rows[:3]), torch.stack(rows[3:])
        got = state.clone()
        tur.fused_cascade(spec, got, cw, aw, start, halves, kinds)
        ref = jur._fused_cascade(jspec, _j(state), _j(cw), _j(aw), start,
                                 halves, kinds, B, True)
    else:
        half = 8 * int(form[-1])
        W, A, start = 2 * half + 4 * half, 2 * half, 2 * half
        state, (c1, c2) = _state_and_rows(rng, W, B, 2, A, spec)
        got = state.clone()
        if form.startswith("bf1"):
            tur.fused_bf1(spec, got, c1, start, half)
            ref = jur._fused_bf1(jspec, _j(state), _j(c1), start, half, A,
                                 B, True)
        else:
            tur.fused_bf2(spec, got, c1, c2, start, half)
            ref = jur._fused_bf2(jspec, _j(state), _j(c1), _j(c2), start,
                                 half, A, B, True)
    np.testing.assert_array_equal(_u32(got), np.asarray(ref))
    assert torch.equal(got[:start], state[:start])
    assert torch.equal(got[start + A:], state[start + A:])
    assert not torch.equal(got[start:start + A], state[start:start + A])
    assert [dict(w.launches) for w in tur.FUSED_WRAPPERS] == launches


def test_fused_levels_reject_broken_pairings(tw8):
    rng = np.random.RandomState(5)
    state, (c,) = _state_and_rows(rng, 64, 2, 1, 16)
    for start, half in ((4, 8), (8, 8), (16, 12), (0, 4)):
        with pytest.raises(ValueError):  # unaligned, start % 2h, h % TW, h
            tur.fused_bf1(SPEC, state, c, start, half)
    cw = torch.stack([c, c])
    for halves, aw in (((4, 8), cw[:1]), ((4, 3), cw[:1]), ((4, 2), cw)):
        with pytest.raises(ValueError):  # h ≥ TW, TW % 2h, awins' rows
            tur.fused_cascade(SPEC, state, cw, aw, 16, halves, (0, 0))


# ------------------------------------------------------ the analysis


@pytest.mark.parametrize("n,tw", [(1024, 128), (64, 8)])
def test_fusable_lists_match_jax(monkeypatch, n, tw):
    """The port's analysis of its ENTER/EXIT schedules equals the JAX
    package's ``_meta(s).fusable`` on the same schedules."""
    monkeypatch.setattr(jur, "TW", tw)
    monkeypatch.setattr(tur, "TW", tw)
    off = _pool_offsets(n)
    try:
        for alg in ("enter", "exit"):
            s = getattr(emit, f"{alg}_schedule")(off, n)
            jur._META_CACHE.clear()
            want = jur._meta(jsch.Schedule(s.W, s.A, s.bs_max, s.xs)).fusable
            got = tur._SchedMeta(s).fusable
            assert got == want, alg
            assert any(h >= tw for h in got) and any(0 < h < tw for h in got)
    finally:
        jur._META_CACHE.clear()


def _pool_offsets(n):
    """The pool offsets of a size-n tree (the schedules' only input)."""
    from ecfft_tpu_torch.native import build_tree_native

    tables = tables_from_numpy(build_tree_native(FIELD, n)[0])
    return tsch.build_pool(SPEC, tables)[1]


# --------------------------------------------------------- the slice


@pytest.fixture(scope="module")
def trees():
    """The JAX tree and the port's tree on the same tables, a numpy-seeded
    batch, and the JAX tree's ENTER/EXIT outputs (scan executor)."""
    jt = build_fftree_native(FIELD, N)
    np_tables = {
        m: {k: ([tuple(np.asarray(a) for a in q) for q in v]
                if k == "mats" else np.asarray(v)) for k, v in t.items()}
        for m, t in jt.tables.items()}
    rng = np.random.RandomState(23)
    top = JSPEC.to_limbs(JSPEC.p)[-1]
    coeffs = rng.randint(0, 1 << 16, size=(BATCH, N, L)).astype(np.uint32)
    coeffs[..., -1] = rng.randint(0, top, size=(BATCH, N))
    evals = np.asarray(jt.enter(jnp.asarray(coeffs)))
    back = np.asarray(jt.exit(jnp.asarray(evals)))
    return np_tables, coeffs, evals, back


@pytest.fixture
def spies(monkeypatch):
    """Counts of the calls to each kernel wrapper the executor reaches,
    and the levels of each cascade."""
    calls = {"levels": []}
    for mod, name in ((step, "muladd1"), (step, "muladd2"),
                      (tur, "fused_bf1"), (tur, "fused_bf2"),
                      (tur, "fused_cascade")):
        fn = getattr(mod, name)

        def spy(*a, _fn=fn, _name=name):
            calls[_name] = calls.get(_name, 0) + 1
            if _name == "fused_cascade":
                calls["levels"].append(len(a[5]))
            return _fn(*a)
        monkeypatch.setattr(mod, name, spy)
    return calls


@pytest.mark.parametrize("runs", ["whole", "split"])
def test_unrolled_enter_exit_match_jax_and_native(trees, tw8, spies,
                                                  monkeypatch, runs):
    """ENTER and EXIT of a B = 2 batch through ``run_unrolled`` equal the
    JAX tree's outputs and the native engine's, with every fused form and
    both generic steps run; so does ``FFTree`` with ``ECFFT_EXECUTOR``.
    "split" caps the levels per cascade at 2, so long runs split and the
    kind-1 rows pair across the pieces."""
    np_tables, coeffs, evals, back = trees
    max_levels = 2 if runs == "split" else tur.MAX_LEVELS
    tree = FFTree(FIELD, N, tables_from_numpy(np_tables), device="cpu")
    monkeypatch.setenv("ECFFT_EXECUTOR", "unrolled")
    tree.prepare()

    def run(alg, batch):
        s, bank, meta = tree._schedule(alg, N)
        assert meta is not None and any(meta.fusable)
        return tur.run_unrolled(SPEC, tree._pool, s, bank, batch, 2 * N, N,
                                meta, max_levels)

    x = torch.from_numpy(coeffs[:2].astype(np.int32))
    got = run("enter", x)
    np.testing.assert_array_equal(_u32(got), evals[:2])
    out = run("exit", torch.from_numpy(evals[:2].astype(np.int32)))
    np.testing.assert_array_equal(_u32(out), back[:2])
    np.testing.assert_array_equal(back, coeffs)
    nt = NativeFFTree(FIELD, N)
    ints = [JSPEC.from_limbs(limbs) for limbs in coeffs[1]]
    assert list(tree.decode(got[1])) == nt.enter(ints)
    for name in ("muladd1", "muladd2", "fused_bf1", "fused_bf2",
                 "fused_cascade"):
        assert spies.get(name, 0) > 0, (name, spies)
    longest = max(spies["levels"])
    assert longest == 2 if runs == "split" else longest > 2
    assert torch.equal(tree.enter(x), got)
    assert torch.equal(tree.exit(got), out)


def test_unrolled_batch_chunks_give_the_same_result(trees, tw8,
                                                    monkeypatch):
    """A batch of 4 run as chunks of 3 + 1 lanes."""
    np_tables, coeffs, evals, _ = trees
    monkeypatch.setenv("ECFFT_EXECUTOR", "unrolled")
    monkeypatch.setattr(tsch, "_lanes_per_chunk", lambda *a: 3)
    chunks, to_state = [], tsch.to_state
    monkeypatch.setattr(tsch, "to_state", lambda b, *a: (
        chunks.append(b.shape[0]), to_state(b, *a))[1])
    tree = FFTree(FIELD, N, tables_from_numpy(np_tables), device="cpu")
    got = tree.enter(torch.from_numpy(coeffs.astype(np.int32)))
    assert chunks == [3, 1]
    np.testing.assert_array_equal(_u32(got), evals)


@pytest.mark.parametrize("kind", ["muladd1", "muladd2"])
def test_muladd_writes_the_window_of_a_state(kind):
    """Into a state the generic steps write its rows [start, start + A)
    and nothing else, equal to what they write into a new window; x1 may
    be that very window (OP_AFF1S), but no other view of the state, and x2
    none at all."""
    rng = np.random.RandomState(29)
    W, A, start, B = 48, 16, 24, 3
    state = _layout(_ints(rng, (W, B)))
    x2 = _layout(_ints(rng, (A, B)))
    rows = [fd.encode(SPEC, _ints(rng, (A,)))
            for _ in range(1 if kind == "muladd1" else 2)]
    wrapper = getattr(step, kind)
    other = _layout(_ints(rng, (A, B)))
    for own in (True, False):
        new = torch.empty_like(x2)
        wrapper(SPEC, *rows, state[start:start + A] if own else other, x2,
                new, 0)
        want = state.clone()
        want[start:start + A] = new
        got = state.clone()
        wrapper(SPEC, *rows, got[start:start + A] if own else other, x2,
                got, start)
        assert torch.equal(got, want)
    for x1, x2_ in ((state[start + 1:start + A + 1], x2),
                    (state[start:start + A], state[:A]),
                    (x2, state[start:start + A])):
        with pytest.raises(ValueError):
            wrapper(SPEC, *rows, x1, x2_, state, start)
    with pytest.raises(ValueError):  # the window leaves the state
        wrapper(SPEC, *rows, x2, x2.clone(), state, W - A + 1)
