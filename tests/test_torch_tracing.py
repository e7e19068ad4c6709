"""The program's spans and call record (``ecfft_tpu_torch/utils/profiling.py``)
on the CPU, with the stand-in graph of ``tests/test_torch_graphs.py``
(a capture runs the loop's Python on a copy of the state, a replay runs
the recorded loop on its own state), at n = 64 and B = 3.

They hold the spans and their nesting under a profiler (a warm-up and a
capture at a key's first call, a replay at the next), that no
``record_function`` opens without one, what a call's entry in the ring
carries, that one call in ``EVERY`` records CUDA events, that the ring
stays bounded and reuses its events, that a
replay adds its capture's launch shapes once, and the idle arithmetic on
events with set device times.
"""

import collections
import itertools
import os
import sys
import time
import weakref

import pytest
import torch

from ecfft_tpu_torch import build_fftree_native
from ecfft_tpu_torch.fields import device as fd
from ecfft_tpu_torch.fields.registry import FIELDS
from ecfft_tpu_torch.ops import graphs, step
from ecfft_tpu_torch.utils import profiling

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_general_fields import register  # noqa: E402

N, B = 64, 3
register()


class StandInGraph:
    """A captured loop: a replay runs it on the state it was captured on."""

    def __init__(self, body, state):
        self.body, self.state = body, state

    def replay(self):  # the loop's data, not its Python's counting
        before = graphs._counts_now()
        self.body(self.state)
        graphs._take_back(before)


class StandInPool:
    def __init__(self, device):
        self.handle = self.stream = None
        self.bytes = 0
        self.live = weakref.WeakSet()


@pytest.fixture
def card(monkeypatch):
    """The CPU standing in for a card: every step loop goes through the
    cache."""
    def capture(device, pool, body, state):
        body(state.clone())  # the loop's Python runs; no data changes
        return StandInGraph(body, state), 0.0, 0.0, 0

    monkeypatch.setattr(graphs, "replays", lambda t: not graphs._EAGER)
    monkeypatch.setattr(graphs, "_capture", capture)
    monkeypatch.setattr(graphs, "_replay", lambda device, g: g.replay())
    monkeypatch.setattr(graphs, "_Pool", StandInPool)
    monkeypatch.setattr(graphs, "_POOLS", {})


def tree(name="m31"):
    return build_fftree_native(FIELDS[name], N, device="cpu")


def batch(name="m31", b=B):
    return fd.encode(FIELDS[name], [[(7 * i + j) % 1000 for i in range(N)]
                                    for j in range(b)], "cpu")


def profiled_spans(fn) -> list:
    """(name, nearest ``ecfft.`` ancestor) of each program span that
    ``fn()`` emits under a CPU profiler, in order."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    out = []
    for e in sorted(prof.events(), key=lambda e: e.time_range.start):
        if not e.name.startswith("ecfft."):
            continue
        up = e.cpu_parent
        while up is not None and not up.name.startswith("ecfft."):
            up = up.cpu_parent
        out.append((e.name, up.name if up is not None else None))
    return out


def chunk_spans(loop, mont=False, plan=False) -> list:
    """The spans of a one-chunk call; ``plan``: the call makes its
    schedule's step plan first."""
    inner = [("ecfft.pack", "ecfft.chunk")]
    inner += [("ecfft.to_mont", "ecfft.chunk")] if mont else []
    inner += [(name, "ecfft.chunk") for name in loop]
    inner += [("ecfft.from_mont", "ecfft.chunk")] if mont else []
    return ([("ecfft.call", None)]
            + ([("ecfft.plan", "ecfft.call")] if plan else [])
            + [("ecfft.chunk", "ecfft.call")] + inner
            + [("ecfft.unpack", "ecfft.chunk")])


# --------------------------------------------------------------- the spans


@pytest.mark.parametrize("name", ["m31", "gp_cios3"])
def test_spans_nest_under_a_profiler(card, name):
    """A key's first call makes the step plan, warms up and captures, the
    next replays; the Montgomery conversions are spans only where the
    field has them."""
    t, x = tree(name), batch(name)
    mont = fd.is_mont(FIELDS[name])
    assert profiled_spans(lambda: t.enter(x)) == chunk_spans(
        ["ecfft.warmup", "ecfft.capture"], mont, plan=True)
    assert profiled_spans(lambda: t.enter(x)) == chunk_spans(
        ["ecfft.replay"], mont)
    assert [c.profiled for c in profiling.recorded()[-2:]] == [True, True]


def test_the_eager_loop_is_one_span():
    t, x = tree(), batch()
    assert profiled_spans(lambda: t.enter(x)) == chunk_spans(["ecfft.steps"],
                                                             plan=True)
    assert profiled_spans(lambda: t.enter(x)) == chunk_spans(["ecfft.steps"])


def test_no_record_function_opens_without_a_profiler(card, monkeypatch):
    opened = []

    class Counting:
        def __init__(self, name):
            opened.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.profiler, "record_function", Counting)
    t, x = tree(), batch()
    t.enter(x)
    t.enter(x)
    assert opened == []
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        t.enter(x)
    assert "ecfft.replay" in opened


def test_recording_off_keeps_no_record_and_the_spans(card):
    t, x = tree(), batch()
    t.enter(x)
    before = [c.id for c in profiling.recorded()]
    with profiling._recording(False):
        assert profiled_spans(lambda: t.enter(x)) == chunk_spans(
            ["ecfft.replay"])
        t.enter(x)
    assert [c.id for c in profiling.recorded()] == before


# -------------------------------------------------------------- the record


def test_one_entry_a_call_with_lanes_flags_and_stamps(card, monkeypatch):
    """Each call's entry: its algorithm, size, batch, a chunk of 3 lanes
    in a 4-lane graph (captured, then replayed, pointing at the graph's
    record), 2 of 5 lanes in the second chunk of a 2-lane budget, flags,
    and host stamps in order inside the caller's bracket."""
    t, x = tree(), batch()
    recs = []
    for _ in range(2):
        a = time.perf_counter_ns()
        t.enter(x)
        b = time.perf_counter_ns()
        recs.append((a, b, profiling.recorded()[-1]))
    (a0, b0, first), (a1, b1, second) = recs
    assert second.id == first.id + 1
    for a, b, rec in recs:
        assert (rec.alg, rec.m, rec.batch) == ("enter", N, B)
        assert not rec.profiled and not rec.built
        assert [(c.lanes, c.graph_lanes) for c in rec.chunks] == [(3, 4)]
        assert rec.spans[0][0] == "ecfft.call" and rec.spans[0][1] is None
        stamps = [s for _, _, s, _ in rec.spans] + rec.marks
        assert all(a <= s <= b for s in stamps)
        assert all(a <= e <= b for _, _, _, e in rec.spans)
        assert rec.marks == sorted(rec.marks) and len(rec.marks) == 4
        assert rec.device_ns() is None and rec.idle_ns(a, b) is None
    assert [c.how for c in first.chunks + second.chunks] == ["capture",
                                                             "replay"]
    graph = second.chunks[0].graph()
    assert graph is first.chunks[0].graph() is next(iter(
        t._graphs.graphs.values()))
    assert graph.replays == 1 and graph.capture_s == 0.0
    assert second.span_ns("ecfft.replay") > 0 == second.span_ns(
        "ecfft.warmup")

    monkeypatch.setattr(t._graphs, "_lanes", {})
    monkeypatch.setattr(graphs.GraphCache, "lanes",
                        lambda self, loop, b, dev, budget: 2)
    t.enter(batch(b=5))
    rec = profiling.recorded()[-1]
    assert [(c.lanes, c.graph_lanes, c.how) for c in rec.chunks] == [
        (2, 2, "capture"), (2, 2, "replay"), (1, 1, "capture")]
    assert len(rec.marks) == 2 + 2 * 3
    assert [n for n, *_ in rec.spans].count("ecfft.chunk") == 3


def test_an_eager_call_records_its_launches():
    """On the eager loop the chunk's launches are what its wrappers
    counted (the plain path counts none) and the lanes are the batch's."""
    t, x = tree(), batch()
    t.enter(x)
    rec = profiling.recorded()[-1]
    assert [(c.lanes, c.graph_lanes, c.how, c.graph, c.shapes)
            for c in rec.chunks] == [(3, 3, "steps", None, [])]


def test_a_kernel_library_load_is_flagged(card, monkeypatch):
    t, x = tree(), batch()
    t.enter(x)
    assert not profiling.recorded()[-1].built
    monkeypatch.setattr(profiling, "_loads", profiling._loads)
    monkeypatch.setattr(graphs, "_replay",
                        lambda device, g: (profiling.loaded(), g.replay()))
    t.enter(x)
    assert profiling.recorded()[-1].built


class StandInEvent:
    """A CUDA event whose device time is set where it is recorded."""

    clock = [0.0]  # ms

    def record(self, stream):
        self.at = self.clock[0]

    def elapsed_time(self, other):
        return other.at - self.at

    def synchronize(self):
        pass


class StandInBatch:
    is_cuda, device, shape = True, "card", (1, N, 1)


def card_events(monkeypatch) -> list:
    """Stand-in CUDA events and stream, an empty pool, and call ids from
    0; returns the list of the events made."""
    made = []

    def event(enable_timing):
        made.append(StandInEvent())
        return made[-1]

    class Stream:
        device = "card"

    monkeypatch.setattr(torch.cuda, "Event", event)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d: Stream())
    monkeypatch.setattr(profiling, "_free_events", {})
    monkeypatch.setattr(profiling, "_ids", itertools.count())
    return made


def test_the_ring_stays_bounded_and_reuses_its_events(monkeypatch):
    """A call that captures a graph (set-up) fills the pool of events, so
    that the calls after it make none; the ring keeps the last RING calls
    and hands the events of those it drops back to the pool."""
    made = card_events(monkeypatch)
    monkeypatch.setattr(profiling, "_ring",
                        collections.deque(maxlen=profiling.RING))
    calls = profiling.RING + 5
    for i in range(calls):
        with profiling.call("enter", N, StandInBatch()) as rec:
            if i == 0:
                rec.chunks.append(profiling.Chunk(1, 1, "capture", None, []))
    ring = profiling.recorded()
    assert len(ring) == profiling.RING
    assert [c.id for c in ring] == list(range(5, calls))
    assert len(made) == 2 + profiling.EVENTS
    sampled = [c for c in ring if c._events]
    assert [c.id for c in sampled] == list(range(8, calls, profiling.EVERY))
    assert len({id(e) for c in sampled for e in c._events}) == \
        2 * len(sampled)
    # the dropped call 0 gave its two events back
    assert len(profiling._free_events["card"]) == \
        profiling.EVENTS - 2 * len(sampled) + 2


def test_one_call_in_every_records_events(monkeypatch):
    """Calls whose id is a multiple of EVERY look up their stream and
    record an event at each mark; the others keep the same host stamps
    and no event, and read no device time."""
    made = card_events(monkeypatch)
    streams = []
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: streams.append(d) or object())
    recs = []
    for _ in range(2 * profiling.EVERY):
        with profiling.call("enter", N, StandInBatch()) as rec:
            rec.mark()
            rec.mark()
        recs.append(rec)
    assert [len(r.marks) for r in recs] == [4] * len(recs)
    assert [r.id for r in recs if r._events] == [0, profiling.EVERY]
    assert all(len(r._events) == 4 for r in recs if r._events)
    assert len(made) == 8
    assert streams == ["card", "card"]  # looked up by those two alone
    assert all(r.device_ns() is None and r.idle_ns(0, 1) is None
               for r in recs if r.id % profiling.EVERY)


def test_a_replay_adds_its_captures_shapes_once(card):
    """The warm-up's launch shapes count, the capture's are taken back,
    and each replay adds the captured shapes again, as the launches."""
    cache = graphs.GraphCache()
    sched = tree()._schedule("enter", N)[0]
    key = (graphs.loop_key(("scan",), (sched,)), 2, torch.device("cpu"))
    state = torch.zeros(4, 1, 2, dtype=torch.int32)
    spec = FIELDS["secp256k1"]
    w = step.aff1s_ip.shapes
    base = (w[("fold16", 4, 2)], w[("fold16", 4, 1)])

    def body(s):
        step.count(step.aff1s_ip, spec, 4, 2)
        step.count(step.aff1s_ip, spec, 4, 1)
        step.count(step.aff1s_ip, spec, 4, 1)

    cache.run(key, state, body, (sched,))
    for k in range(4):
        assert (w[("fold16", 4, 2)] - base[0],
                w[("fold16", 4, 1)] - base[1]) == (1 + k, 2 + 2 * k)
        if k < 3:
            cache.run(key, state, body, (sched,))
    rec = cache.graphs[key]
    assert [(x.__name__, dict(c)) for x, c in rec.shapes] == [
        ("aff1s_ip", {("fold16", 4, 2): 1, ("fold16", 4, 1): 2})]
    assert [(x.__name__, dict(c)) for x, c in rec.counts] == [
        ("aff1s_ip", {"fold16": 3})]


# ------------------------------------------------------------ the idle


def test_the_idle_arithmetic(monkeypatch):
    """A call from t0 = 0 to t1 = 100 (µs, host clock) with its entry
    event at 10. The pack starts at 12, its work done at 20 (device
    time 10 after the entry); the graph's launch spans 30–34, its work
    done at 80; the unpack starts at 36 and its work is done at 90. Idle:
    0–12 before the first work, 20–34 up to the graph's launch, and 90–100
    after: 36 µs."""
    us = 1000
    spans = [["ecfft.call", None, 9 * us, 95 * us],
             ["ecfft.chunk", 0, 11 * us, 94 * us],
             ["ecfft.pack", 1, 12 * us, 14 * us],
             ["ecfft.replay", 1, 30 * us, 34 * us],
             ["ecfft.unpack", 1, 36 * us, 37 * us]]
    marks = [10 * us, 29 * us, 35 * us, 38 * us]
    device = [10 * us, 20 * us, 80 * us, 90 * us]
    assert profiling.idle_between(marks, device, spans, 0, 100 * us) == \
        36 * us
    # a graph launched onto a queue still busy adds no idle
    busy = [10 * us, 40 * us, 80 * us, 90 * us]
    assert profiling.idle_between(marks, busy, spans, 0, 100 * us) == \
        22 * us

    card_events(monkeypatch)
    rec = profiling.Call("enter", N, 1, "card")
    for host, dev in zip(marks, device):
        StandInEvent.clock[0] = (dev - device[0]) / 1e6
        rec.mark()
        rec.marks[-1] = host
    rec.spans = spans
    assert rec.device_ns() == device
    assert rec.idle_ns(0, 100 * us) == 36 * us

    # under a profiler a launch returns long after its graph began: the
    # rule then counts the graph's work up to the launch's end as idle
    late = [["ecfft.replay", 1, 30 * us, 70 * us]]
    assert profiling.idle_between(marks, device, spans[:3] + late, 0,
                                  100 * us) == 72 * us
