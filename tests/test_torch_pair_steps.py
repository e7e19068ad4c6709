"""The scan executor's pair steps on the CPU.

A self-read step (OP_AFF1S*) or a two-product step (OP_AFFINE*) whose x2
index row reads, at each window row q, the partner row q XOR h or row q
itself (and whose x1 row, for the latter, is the window itself) touches
only the rows of its own pairs {q, q XOR h}: the step plan marks it with
its h (``ops.schedule.pair_h``) where the field's kernels have the pair
form, and the loop runs it through ``step.aff1s_pair_ip`` /
``step.aff2g_pair_ip``, which read x2 in place instead of gathering it.
Held here:

- which steps the plan marks over secp256k1 ("fold16"), gp_cios3
  ("cios3") and bn254_fq ("cios16") at n = 16 and 1024 for ENTER and
  EXIT: every self-read step, ENTER's two-product steps, no OP_AFF1*
  step, and each mark's h against the rule; none over M31, whose kernels
  have no pair form; a row altered in one position is not marked;
- the pair wrappers' plain versions against the gathered wrappers on the
  same windows, h in {1, 2, A/2}, with and without an index row;
- ENTER, EXIT, EXTEND, DEGREE, REDC and MOD through the planned loop,
  pair steps taken, against the native engine;
- the call record keeps a chunk's pair launches apart from its step
  launches.

Tolerance: none, the arithmetic is exact (0 differing limbs).
"""

import collections
import os
import random
import sys

import pytest
import torch

from ecfft_tpu_torch import build_fftree_native
from ecfft_tpu_torch.fields import device as fd
from ecfft_tpu_torch.fields.registry import FIELDS
from ecfft_tpu_torch.native import NativeFFTree
from ecfft_tpu_torch.ops import emit, graphs, step
from ecfft_tpu_torch.ops import schedule as tsch
from ecfft_tpu_torch.utils import profiling

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_general_fields import register  # noqa: E402

SELF_READ = (emit.OP_AFF1S, emit.OP_AFF1S_C)
TWO = (emit.OP_AFFINE, emit.OP_AFFINE_C)
ONE = (emit.OP_AFF1, emit.OP_AFF1_C)


@pytest.fixture(scope="module", autouse=True)
def fields():
    register()


_TREES = {}


def tree(name, n):
    if (name, n) not in _TREES:
        _TREES[(name, n)] = build_fftree_native(FIELDS[name], n,
                                                device="cpu")
    return _TREES[(name, n)]


def plan_of(name, n, alg):
    t = tree(name, n)
    sched, bank, _ = t._schedule(alg, n)
    return sched, tsch.StepPlan(t.spec, t._pool, sched, bank)


def reads_its_pairs(op, start, cols, h, A):
    """The rule, in python ints: x2 reads q or q ^ h at every q, q ^ h at
    least once; a two-product step's x1 reads q."""
    x2 = [int(v) - start for v in cols[3][1]]
    if not all(r in (q, q ^ h) for q, r in enumerate(x2)):
        return False
    if not any(r == q ^ h for q, r in enumerate(x2)):
        return False
    return op not in TWO or [int(v) - start for v in cols[1][1]] == \
        list(range(A))


@pytest.mark.parametrize("alg", ["enter", "exit"])
@pytest.mark.parametrize("n", [16, 1024])
@pytest.mark.parametrize("name", ["secp256k1", "gp_cios3", "bn254_fq"])
def test_the_plan_marks_the_pair_steps(name, n, alg):
    """Every self-read step is marked, and in ENTER every two-product
    step; no OP_AFF1*, OP_MUL or OP_CMPSEL step is; each mark's h is a
    power of two with A a multiple of 2h, and the step's rows keep to its
    pairs; every two-product step left unmarked breaks the rule."""
    sched, plan = plan_of(name, n, alg)
    A = sched.A
    assert len(plan.pairs) == len(plan.steps)
    marked = collections.Counter()
    for (op, start, cols), h in zip(plan.steps, plan.pairs):
        if op in SELF_READ or (alg == "enter" and op in TWO):
            assert h, (op, start)
        if op not in (*SELF_READ, *TWO):
            assert h == 0, (op, start)
        if h:
            assert h & (h - 1) == 0 and A % (2 * h) == 0
            assert reads_its_pairs(op, start, cols, h, A)
            marked[op] += 1
        elif op in TWO:
            assert not any(reads_its_pairs(op, start, cols, 1 << k, A)
                           for k in range(A.bit_length() - 1))
    assert marked[emit.OP_AFF1S_C] > 0 and marked[emit.OP_AFFINE_C] > 0
    assert not any(op in ONE for op in marked)


@pytest.mark.parametrize("alg", ["enter", "exit"])
@pytest.mark.parametrize("n", [16, 1024])
def test_m31_marks_no_step(n, alg):
    """M31's kernels have no pair form, so its plan marks nothing, though
    its rows are those that the word forms' plans mark."""
    sched, plan = plan_of("m31", n, alg)
    assert not step.pair_form(FIELDS["m31"])
    assert plan.pairs == [0] * len(plan.steps)
    q = torch.arange(sched.A)
    assert any(tsch.pair_h(op, start, cols, q)
               for op, start, cols in plan.steps)


@pytest.mark.parametrize("where", ["first", "middle", "last"])
@pytest.mark.parametrize("what", ["x2 outside the pair", "x2 at another h",
                                  "x1 not the window"])
def test_a_row_altered_in_one_position_is_not_marked(what, where):
    """A marked step of ENTER at n = 1024 stops being one when one entry
    of its index rows leaves the rule."""
    sched, plan = plan_of("secp256k1", 1024, "enter")
    A = sched.A
    q = torch.arange(A)
    ops = TWO if what == "x1 not the window" else SELF_READ
    (op, start, cols), h = next(
        (s, h) for s, h in zip(plan.steps, plan.pairs)
        if h and s[0] in ops and 2 <= h and 4 * h < A)
    assert tsch.pair_h(op, start, cols, q) == h
    k = {"first": 0, "middle": A // 2 + 1, "last": A - 1}[where]
    ci = 1 if what == "x1 not the window" else 3
    row = cols[ci][1].clone()
    row[k] = start + {"x2 outside the pair": k ^ h ^ 1,
                      "x2 at another h": k ^ (2 * h),
                      "x1 not the window": k ^ h}[what]
    altered = tuple((c[0], row) if i == ci else c
                    for i, c in enumerate(cols))
    assert tsch.pair_h(op, start, altered, q) == 0


def _state(spec, rows, lanes, rng):
    vals = [[rng.randrange(spec.p) for _ in range(lanes)] for _ in range(rows)]
    return fd.encode(spec, vals, "cpu").permute(0, 2, 1).contiguous()


def _rows(spec, A, rng):
    return fd.encode(spec, [rng.randrange(spec.p) for _ in range(A)], "cpu")


@pytest.mark.parametrize("index_row", [False, True], ids=["partners",
                                                          "some_own"])
@pytest.mark.parametrize("h", [1, 2, 32])
@pytest.mark.parametrize("kind", ["aff1s", "aff2g"])
@pytest.mark.parametrize("name", ["secp256k1", "bn254_fq"])
def test_pair_wrappers_equal_the_gathered_ones(name, kind, h, index_row):
    """On a (W, L, B) state with its window of A = 64 rows at start 40,
    the pair wrapper's plain version equals the gathered wrapper given the
    rows its index row names as x2 (and the window as x1): every row's
    partner, or every third row's own."""
    spec, rng = FIELDS[name], random.Random(h)
    W, A, B, start = 128, 64, 3, 40
    state = _state(spec, W, B, rng)
    q = torch.arange(A)
    rows = start + (q ^ h)
    if index_row:  # every third row reads itself
        rows = torch.where(q % 3 == 0, start + q, rows)
    x2row = rows.to(torch.int32)
    ca, cb = _rows(spec, A, rng), _rows(spec, A, rng)
    want, got = state.clone(), state.clone()
    if kind == "aff1s":
        step.aff1s_ip(spec, cb, want, want.index_select(0, rows), start)
        step.aff1s_pair_ip(spec, cb, got, h, start, x2row)
    else:
        step.aff2g_ip(spec, ca, cb, want, want[start:start + A].clone(),
                      want.index_select(0, rows), start)
        step.aff2g_pair_ip(spec, ca, cb, got, h, start, x2row)
    assert torch.equal(got, want)
    assert not torch.equal(got[start:start + A], state[start:start + A])


def test_pair_wrappers_check_their_operands():
    spec, rng = FIELDS["secp256k1"], random.Random(0)
    state = _state(spec, 32, 2, rng)
    C = _rows(spec, 8, rng)
    row = torch.arange(4, 12, dtype=torch.int32)
    for h in (0, 3, 8, 16):  # not a power of two, or 2h not dividing A
        with pytest.raises(ValueError, match="partner distance"):
            step.aff1s_pair_ip(spec, C, state, h, 4, row)
    for bad in (row.long(), row[:4], row.reshape(2, 4)):
        with pytest.raises(ValueError, match="index row"):
            step.aff1s_pair_ip(spec, C, state, 2, 4, bad)
    with pytest.raises(ValueError, match="outside"):
        step.aff2g_pair_ip(spec, C, C, state, 2, 28, row)
    with pytest.raises(ValueError):
        step.aff2g_pair_ip(spec, C, C[:4].contiguous(), state, 2, 4, row)


N = 64
S1 = emit.S1


def _ints(spec, t):
    return [[int(v) for v in fd.decode(spec, row)] for row in t]


@pytest.mark.parametrize("alg", ["enter", "exit", "extend", "degree",
                                 "redc_z0", "modular_reduce"])
@pytest.mark.parametrize("name", ["secp256k1", "bn254_fq"])
def test_the_planned_loop_with_pair_steps_matches_native(monkeypatch, name,
                                                         alg):
    """Each algorithm at n = 64, B = 2 through the planned loop, which
    hands its pair steps to the pair wrappers (counted here), equals the
    native engine with 0 differing limbs, at the call that makes the plan
    and at the one that reads it. DEGREE has no pair step, and runs as
    before."""
    monkeypatch.delenv("ECFFT_EXECUTOR", raising=False)
    calls = collections.Counter()
    for w in ("aff1s_pair_ip", "aff2g_pair_ip"):
        fn = getattr(step, w)
        monkeypatch.setattr(step, w, lambda *a, _f=fn, _w=w, **k: (
            calls.update([_w]), _f(*a, **k))[1])
    spec = FIELDS[name]
    t, nt = tree(name, N), NativeFFTree(spec, N)
    rng = random.Random(sum(map(ord, name + alg)))
    m = N // 2 if alg == "extend" else N
    if alg == "degree":
        degrees = [0, N - 1, 7]
        batch = [nt.enter([rng.randrange(1, spec.p) if i <= d else 0
                           for i in range(N)]) for d in degrees]
    else:
        batch = [[rng.randrange(spec.p) for _ in range(m)] for _ in range(2)]
    x = fd.encode(spec, batch, "cpu")
    args = (S1,) if alg == "extend" else ()
    for _ in range(2):
        got = getattr(t, alg)(x, *args)
        if alg == "degree":
            assert got.tolist() == degrees
            continue
        if alg in ("enter", "exit"):
            want = [getattr(nt, alg)(v) for v in batch]
        elif alg == "extend":
            want = [nt.extend(v, S1) for v in batch]
        else:
            a = nt.table(N, "xnn_s")
            want = ([nt.redc_z0(v, a) for v in batch] if alg == "redc_z0"
                    else [nt.modular_reduce(v, a, nt.table(
                        N, "z0z0_rem_xnn_s")) for v in batch])
        assert _ints(spec, got) == want
    # DEGREE's steps span the windows of several sizes at once: no pairs
    assert (calls["aff1s_pair_ip"] > 0) == (alg != "degree")


def test_the_call_record_keeps_pair_launches_apart():
    """A chunk's step launches (``shapes``) count a pair launch under its
    step, as its kernel runs as that step's; ``pairs`` holds the pair
    wrappers' own counts. A chunk without pair launches notes none."""
    spec = FIELDS["secp256k1"]
    x = torch.zeros((4, 16, 2), dtype=torch.int32)

    def loop(pairs):
        def run(_):
            step.count(step.aff1s_ip, spec, 4, 2)
            step.count(step.aff1g_ip, spec, 4, 2)
            for _ in range(pairs):
                step.count(step.aff1s_ip, spec, 4, 2)
                step.count(step.aff1s_pair_ip, spec, 4, 2)
        return run

    for pairs in (2, 0):
        before = graphs._counts_now()
        with profiling.call("enter", 4, x.permute(2, 0, 1)) as rec:
            tsch._chunk_loop(rec, x, 2, loop(pairs), None, None, ())
        graphs._take_back(before)
        (ch,) = rec.chunks
        assert [(w.__name__, dict(c)) for w, c in ch.shapes] == [
            ("aff1s_ip", {("fold16", 4, 2): 1 + pairs}),
            ("aff1g_ip", {("fold16", 4, 2): 1})]
        assert [(w.__name__, dict(c)) for w, c in ch.pairs] == (
            [("aff1s_pair_ip", {("fold16", 4, 2): pairs})] if pairs else [])
        assert rec.launches()[("aff1s_ip", 4, 2)] == 1 + pairs
