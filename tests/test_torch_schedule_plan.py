"""The scan executor's step plan (``ops.schedule.StepPlan``) on the CPU.

The plan holds what a schedule's steps read besides the state: each
column's clamped index row and the D-engine's coefficient rows, made once
per schedule and device. Held here, at n = 16, B = 2, over secp256k1
("fold16"), M31 and a prime with Montgomery residents ("gp_cios3"):

- the planned loop (first call: the plan made; second: the kept plan
  read) equals the native engine for ENTER, EXIT, DEGREE, EXTEND, REDC
  and MOD, and the general-modulus REDC and MOD (their OP_MUL chains),
  on the same numpy-seeded inputs, and the JAX package on every one of
  them over M31 and on ENTER and the general MOD over the other two
  (each JAX method over 16 limbs, or 3 in Montgomery form, compiles for
  10–30 s on the CPU: ``tests/test_torch_algorithms.py`` and
  ``tests/test_torch_general_prime*.py`` hold the rest against it);
- each step of the plan gathers what the unplanned loop gathered (the
  index rows through ``col_row`` and the clamp, the coefficients through
  ``_d_engine`` and ``coeff_rows``), row for row;
- a second call on a tree makes no index row and runs no D-engine;
- a never-active column keeps no row of its own;
- the chunk budget counts the plan as held, and the call record notes
  the kept plan.

Tolerance: none, the arithmetic is exact (0 differing limbs).
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecfft_tpu.fields import registry as jreg
from ecfft_tpu.native import build_fftree_native as jbuild
from ecfft_tpu_torch import build_fftree_native as tbuild
from ecfft_tpu_torch.fields import device as fd
from ecfft_tpu_torch.fields import registry as treg
from ecfft_tpu_torch.native import NativeFFTree
from ecfft_tpu_torch.ops import emit
from ecfft_tpu_torch.ops import schedule as tsch
from ecfft_tpu_torch.utils import profiling

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_general_fields import register  # noqa: E402

N, B = 16, 2
FIELDS = ("secp256k1", "m31", "gp_cios3")
S1 = emit.S1

# case → (method, points, extra arguments, sizes of the modulus tables,
# the schedule's key)
CASES = {
    "enter": ("enter", N, (), (), ("enter", N)),
    "exit": ("exit", N, (), (), ("exit", N)),
    "degree": ("degree", N, (), (), ("degree", N)),
    "extend": ("extend", N // 2, (S1,), (), ("extend", N // 2, S1)),
    "redc_z0": ("redc_z0", N, (), (), ("redc", N)),
    "modular_reduce": ("modular_reduce", N, (), (), ("mod", N)),
    "general-redc_z0": ("redc_z0", N // 2, (), (N // 2,),
                        ("gredc", N // 2, emit.S0)),
    "general-modular_reduce": ("modular_reduce", N // 2, (), (N // 2,) * 2,
                               ("gmod", N // 2)),
}
DEGREES = [0, N - 1, 5]


@pytest.fixture(scope="module", autouse=True)
def fields():
    register(jreg)


_TREES, _JAX, _NATIVE = {}, {}, {}


def tree(name):
    """One port tree a field for the module: the second call of a case
    reads the plan its first call made."""
    if name not in _TREES:
        _TREES[name] = tbuild(treg.FIELDS[name], N, device="cpu")
    return _TREES[name]


def jax_tree(name):
    if name not in _JAX:
        _JAX[name] = jbuild(jreg.FIELDS[name], N)
    return _JAX[name]


def native(name):
    if name not in _NATIVE:
        _NATIVE[name] = NativeFFTree(treg.FIELDS[name], N)
    return _NATIVE[name]


def _ints(spec, t):
    return [[int(v) for v in fd.decode(spec, row)] for row in t]


def inputs(name, case):
    """(batch, modulus tables) as python ints, numpy-seeded; nonzero
    modulus entries (a's even entries are inverted)."""
    method, m, _, extras, _ = CASES[case]
    spec = treg.FIELDS[name]
    rng = np.random.RandomState(sum(map(ord, name + case)))

    def draw(k):
        return [1 + int.from_bytes(rng.bytes(40), "little") % (spec.p - 1)
                for _ in range(k)]

    if method == "degree":
        nt = native(name)
        batch = [nt.enter([draw(1)[0] if i <= d else 0 for i in range(m)])
                 for d in DEGREES]
    else:
        batch = [draw(m) for _ in range(B)]
    return batch, [draw(k) for k in extras]


def native_answer(name, case, batch, tabs):
    method, _, args, _, _ = CASES[case]
    nt = native(name)
    if method == "degree":
        return [nt.degree(v) for v in batch]
    if method in ("enter", "exit"):
        return [getattr(nt, method)(v) for v in batch]
    if method == "extend":
        return [nt.extend(v, *args) for v in batch]
    m = len(batch[0])
    a, c = tabs if len(tabs) == 2 else (tabs or [None])[0:1] + [None]
    if a is None:
        a, c = nt.table(m, "xnn_s"), nt.table(m, "z0z0_rem_xnn_s")
    if method == "redc_z0":
        return [nt.redc_z0(v, a) for v in batch]
    return [nt.modular_reduce(v, a, c) for v in batch]


# the cases held against the JAX package as well, by field
JAX_CASES = {"m31": tuple(CASES), "secp256k1": ("enter",
                                                "general-modular_reduce"),
             "gp_cios3": ("enter", "general-modular_reduce")}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("name", FIELDS)
def test_planned_loop_matches_jax_and_native(monkeypatch, name, case):
    """The call that makes the plan and the call that reads it equal the
    native engine, and the JAX package's method (``JAX_CASES``)."""
    monkeypatch.delenv("ECFFT_EXECUTOR", raising=False)
    method, _, args, _, key = CASES[case]
    spec, t = treg.FIELDS[name], tree(name)
    batch, tabs = inputs(name, case)
    x = fd.encode(spec, batch, "cpu")
    ts = [fd.encode(spec, tab, "cpu") for tab in tabs]
    outs = [getattr(t, method)(x, *args, *ts) for _ in range(2)]
    assert key in t._scheds
    plans = [p for p in t._graphs.plans.values()
             if p.pins[0] is t._schedule(*key)[0]]
    assert len(plans) == 1 and plans[0].kept
    want = None
    if case in JAX_CASES[name]:
        want = np.asarray(getattr(jax_tree(name), method)(
            jnp.asarray(x.numpy().astype(np.uint32)), *args,
            *(jnp.asarray(u.numpy().astype(np.uint32)) for u in ts)))
    ref = native_answer(name, case, batch, tabs)
    for got in outs:
        if want is not None:
            np.testing.assert_array_equal(got.numpy().astype(want.dtype),
                                          want)
        if method == "degree":
            assert got.tolist() == ref == DEGREES
        else:
            assert _ints(spec, got) == ref


@pytest.mark.parametrize("case", ["enter", "exit", "degree", "extend",
                                  "general-modular_reduce"])
@pytest.mark.parametrize("name", ["secp256k1", "gp_cios3"])
def test_each_step_reads_what_the_unplanned_loop_computed(name, case):
    """Step by step, the plan's gathers of the pool, its table and a
    state give the rows of the unplanned loop: the index rows of
    ``col_row`` clamped to the state, and the coefficients of
    ``coeff_rows`` over the running D-engine."""
    t = tree(name)
    sched, bank, _ = t._schedule(*CASES[case][4])
    pool, spec = t._pool, t.spec
    plan = tsch.StepPlan(spec, pool, sched, bank)
    ops, starts, _, dp, _, _ = sched.xs
    W, A, bsx = sched.W, sched.A, max(sched.bs_max, 1)
    q = torch.arange(A)
    # a state whose row r holds r in its first limb
    state = torch.zeros((W, spec.num_limbs, 1), dtype=torch.int32)
    state[:, 0, 0] = torch.arange(W)
    srcs = (state, plan.pool, plan.table)
    D = torch.zeros((bsx, spec.num_limbs), dtype=torch.int32)
    iD = torch.zeros_like(D)
    assert len(plan.steps) == len(ops)
    for k, (op, start, cols) in enumerate(plan.steps):
        assert (op, start) == (int(ops[k]), int(starts[k]))
        p = q + start
        CA, CB, D, iD = tsch._d_engine(spec, pool, dp[k], D, iD, op)
        reads, coeffs = tsch._READS[op]
        assert [ci for ci in range(4) if cols[ci] is not None] == \
            sorted(reads + coeffs)
        for ci in reads:
            src, row = cols[ci]
            want = tsch.col_row(sched, bank, k, ci, p).clamp(0, W - 1)
            assert src == tsch._STATE and row.dtype == torch.int32
            assert torch.equal(state.index_select(0, row),
                               state.index_select(0, want)), (k, ci)
        for ci in coeffs:
            src, row = cols[ci]
            scratch, pad = (CA, pool[1:2]) if ci == 0 else (CB, pool[0:1])
            want = tsch.coeff_rows(pool, tsch.col_row(sched, bank, k, ci, p),
                                   scratch, pad, bsx)
            assert src == (tsch._POOL if scratch is None else tsch._TABLE)
            assert torch.equal(srcs[src].index_select(0, row), want), (k, ci)


def test_a_second_call_makes_no_index_row_and_runs_no_d_engine(monkeypatch):
    """ENTER and EXIT on a fresh tree count the synthesised index rows and
    the D-engine's steps at their first calls, and none at the second:
    those read the kept plans."""
    counts = {"synth": 0, "d_engine": 0}
    synth, d_engine = tsch._synth, tsch._d_engine

    def counted(name, fn):
        def run(*a):
            counts[name] += 1
            return fn(*a)
        return run

    monkeypatch.setattr(tsch, "_synth", counted("synth", synth))
    monkeypatch.setattr(tsch, "_d_engine", counted("d_engine", d_engine))
    monkeypatch.delenv("ECFFT_EXECUTOR", raising=False)
    t = tbuild(treg.FIELDS["m31"], N, device="cpu")
    x = fd.encode(t.spec, [list(range(1, N + 1))] * B, "cpu")
    first = t.exit(t.enter(x))
    made = dict(counts)
    assert made["synth"] > 0
    assert made["d_engine"] == sum(len(t._schedule(a, N)[0].xs[0])
                                   for a in ("enter", "exit"))
    again = t.exit(t.enter(x))
    assert counts == made and torch.equal(first, again) and \
        torch.equal(first, x)
    assert len(t._graphs.plans) == 2


@pytest.mark.parametrize("alg", ["enter", "exit", "degree"])
def test_a_never_active_column_keeps_no_row(alg):
    """A column whose span is ≤ 0 reads the plan's window (a slice of one
    ``arange``) or a constant row that every column of that constant
    shares; the rows of active columns are the plan's own."""
    t = tree("m31")
    sched, bank, _ = t._schedule(alg, N)
    plan = tsch.StepPlan(t.spec, t._pool, sched, bank)
    _, _, colp, _, rid, _ = sched.xs
    window = plan.window.untyped_storage().data_ptr()
    consts, seen = {}, 0
    for k, (op, start, cols) in enumerate(plan.steps):
        for ci, col in enumerate(cols):
            if col is None or rid[k, ci] >= 0 or \
                    colp[k, ci, emit.CP_SPAN] > 0:
                continue
            seen += 1
            ptr = col[1].untyped_storage().data_ptr()
            if colp[k, ci, emit.CP_DK]:
                value = int(col[1][0])
                assert bool((col[1] == value).all())
                assert consts.setdefault(value, ptr) == ptr
            else:
                assert ptr == window
                assert torch.equal(col[1].long(),
                                   torch.arange(start, start + sched.A))
    assert seen > 0


def test_the_chunk_budget_counts_the_plan_as_held(monkeypatch):
    """The plan is made before the budget, so a card's allocator holds its
    bytes: of F bytes free beside it the lanes take what the output, two
    coefficient windows and the margin leave, with the plan not counted
    again and none of the per-step temporaries it replaced (which the
    unrolled loop, making its own, still counts)."""
    t = tree("secp256k1")
    sched, bank, _ = t._schedule("enter", N)
    plan = tsch.step_plan(t.spec, t._pool, sched, bank, t._graphs)
    L, m, A, bsx, batch = 16, 2 * N, sched.A, sched.bs_max, 8
    per_lane, fixed = tsch._chunk_bytes(sched, L, batch, m)
    assert fixed == batch * m * L * 4 + 2 * A * L * 4 + tsch._ALLOC_MARGIN
    _, unplanned = tsch._chunk_bytes(sched, L, batch, m, planned=False)
    assert unplanned - fixed == 2 * A * L * 4 + 32 * A * 8 + 16 * bsx * L * 4
    free = fixed + 3 * per_lane + per_lane // 2
    held = plan.nbytes
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda device=None: (free, 80 << 30))
    monkeypatch.setattr(torch.cuda, "memory_reserved",
                        lambda device=None: held)
    monkeypatch.setattr(torch.cuda, "memory_allocated",
                        lambda device=None: held)
    dev = torch.device("cuda", 0)
    assert tsch._lanes_per_chunk(sched, L, batch, m, dev) == 3
    unplanned_lanes = (free - unplanned) // per_lane
    assert 1 <= unplanned_lanes < 3
    assert tsch._lanes_per_chunk(sched, L, batch, m, dev,
                                 planned=False) == unplanned_lanes


@pytest.mark.parametrize("executor", ["scan", "unrolled"])
def test_the_executors_budget_as_planned_or_not(monkeypatch, executor):
    """The scan loop reads a plan, so its budget leaves out the per-step
    temporaries; the unrolled loop makes them, so its budget counts
    them."""
    if executor == "unrolled":
        monkeypatch.setenv("ECFFT_EXECUTOR", "unrolled")
    else:
        monkeypatch.delenv("ECFFT_EXECUTOR", raising=False)
    asked = []
    monkeypatch.setattr(tsch, "_lanes_per_chunk",
                        lambda *a: asked.append(a[-1]) or a[2])
    t = tbuild(treg.FIELDS["m31"], N, device="cpu")
    t.enter(fd.encode(t.spec, [list(range(N))] * B, "cpu"))
    assert asked == [executor == "scan"]


def test_the_call_record_notes_the_kept_plan(monkeypatch):
    """The chunks of a tree's calls note the kept plan and its bytes; a
    run of the schedule without an owner's cache makes a plan for the call
    alone, which it does not note as kept; the unrolled loop reads none."""
    monkeypatch.delenv("ECFFT_EXECUTOR", raising=False)
    t = tbuild(treg.FIELDS["secp256k1"], N, device="cpu")
    x = fd.encode(t.spec, [list(range(N))] * B, "cpu")
    out = [t.enter(x) for _ in range(2)]
    (plan,) = t._graphs.plans.values()
    recs = profiling.recorded()[-2:]
    assert [(c.plan, c.plan_bytes) for r in recs for c in r.chunks] == \
        [(True, plan.nbytes)] * 2
    assert plan.nbytes >= plan.table.numel() * 4 > 0
    assert [n for n, *_ in recs[0].spans].index("ecfft.plan") < \
        [n for n, *_ in recs[0].spans].index("ecfft.chunk")
    assert "ecfft.plan" not in [n for n, *_ in recs[1].spans]
    sched, bank, _ = t._schedule("enter", N)
    with profiling.call("enter", N, x):
        alone = tsch.run_schedule(t.spec, t._pool, sched, bank, x, 2 * N, N)
    assert torch.equal(alone, out[0])
    assert [(c.plan, c.plan_bytes)
            for c in profiling.recorded()[-1].chunks] == [(False, 0)]
    monkeypatch.setenv("ECFFT_EXECUTOR", "unrolled")
    assert torch.equal(t.enter(x), out[0])
    assert [(c.plan, c.plan_bytes)
            for c in profiling.recorded()[-1].chunks] == [(False, 0)]
