"""The readers of the program's call record (``benchmark/program.py`` and
the metrics ``pad_lanes_pct``, ``replay_launch_ms``, ``untraced_idle_pct``
and ``all_steps_roofline``) on a synthetic run: records of the program's
own kind (``ecfft_tpu_torch.utils.profiling.Call``) with set spans,
chunks, launches and events, and a synthetic trace."""

import collections
import os
import sys
import types

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark import harness, program, roofline, trace  # noqa: E402
from ecfft_tpu_torch.utils import profiling  # noqa: E402

SECP_P = 2**256 - 2**32 - 977
MS = 1_000_000  # ns
READERS = ("pad_lanes_pct", "replay_launch_ms", "untraced_idle_pct",
           "all_steps_roofline")


class Event:
    """A CUDA event at a set device time (ms)."""

    def __init__(self, at):
        self.at = at

    def elapsed_time(self, other):
        return other.at - self.at

    def synchronize(self):
        pass


def record(t0, *, profiled=False, lanes=135, graph_lanes=256, replay=0.2,
           device=None, launches=()):
    """A one-chunk replayed call starting at ``t0`` ms: the pack at
    0.1–0.5 ms, the graph's launch from 1.1 ms for ``replay`` ms, the
    unpack 0.1 ms after it; events at its entry, before and after the
    replay (1 ms and 0.1 ms after the launch) and at 3 ms; ``device``:
    where its events completed, in ms after the entry; ``launches``:
    (wrapper, rows, lanes, count)."""
    rec = profiling.Call("enter", 65536, lanes)
    rec.profiled = profiled
    s = t0 * MS
    after = s + round((1.2 + replay) * MS)
    rec.spans = [["ecfft.call", None, s, s + 3 * MS],
                 ["ecfft.chunk", 0, s, s + 3 * MS],
                 ["ecfft.pack", 1, s + MS // 10, s + MS // 2],
                 ["ecfft.replay", 1, s + round(1.1 * MS),
                  s + round((1.1 + replay) * MS)],
                 ["ecfft.unpack", 1, after + MS // 10, after + MS // 5]]
    rec.marks = [s, s + MS, after, s + 3 * MS]
    if device is not None:
        rec._events = [Event(d) for d in device]
    wrappers = {}
    for name, rows, ln, k in launches:
        wrappers.setdefault(name, collections.Counter())[
            ("fold16", rows, ln)] += k
    shapes = [(types.SimpleNamespace(__name__=name), c)
              for name, c in wrappers.items()]
    rec.chunks = [profiling.Chunk(lanes, graph_lanes, "replay", None,
                                  shapes)]
    return rec


STEP = "void (anonymous namespace)::step_kernel<{}>(Field)"
GATHER = "void at::native::vectorized_gather_kernel<16, long>()"


def synthetic_run(monkeypatch, recs, trace_ops=None):
    """Three window calls at 100, 200 and 300 ms (5 ms each), the second
    traced, after a set-up call at 10 ms; ``trace_ops``: the traced call's
    device records."""
    monkeypatch.setattr(profiling, "recorded", lambda: list(recs))
    tr = None
    if trace_ops is not None:
        tr = trace.Trace([(200_000.0, 205_000.0)], trace_ops, [])
    return harness.Run(
        config={"p": str(SECP_P), "limbs": 16, "limb_bits": 16,
                "n": 65536},
        calls=[(0.1, 0.105, 135), (0.2, 0.205, 135), (0.3, 0.305, 135)],
        window_s=0.25, setup_s=12.5, memory_peak_bytes=0, lanes=256,
        trace=tr)


def calls(monkeypatch, **traced):
    launches = [("aff1s_ip", 65536, 256, 2), ("muladd1", 65536, 256, 1),
                ("aff1s_ip", 32, 1, 5), ("fused_bf1", 64, 256, 1)]
    return [record(10, lanes=3, graph_lanes=4, replay=0.9),  # set-up
            record(100, replay=0.2, device=[0, 1.5, 4.0, 4.5]),
            record(200, profiled=True, lanes=1, replay=1.0,
                   launches=launches, **traced),
            record(300, replay=0.4, device=[0, 1.2, 3.5, 4.0])]


def trace_ops(n_one_lane=5):
    t = 200_000.0
    ops = [(GATHER, t + 1, t + 2, (1024, 1, 1))]
    ops += [(STEP.format(0), t + 2 + k, t + 3 + k, None) for k in range(2)]
    ops += [(STEP.format(1), t + 5, t + 7, None)]
    ops += [(STEP.format(0), t + 8 + k, t + 8.5 + k, None)
            for k in range(n_one_lane)]
    return ops


def test_pad_lanes_leave_out_set_up_and_traced_calls(monkeypatch):
    recs = calls(monkeypatch)
    run = synthetic_run(monkeypatch, recs)
    assert [r.start_ns // MS for _, _, r in program.window_calls(run)] == \
        [100]
    assert [r.start_ns // MS for _, _, r in
            program.window_calls(run, profiled=True)] == [200]
    assert harness.reader("pad_lanes_pct")(run) == 100 * 121 / 256
    recs[2].profiled = False
    assert [r.start_ns // MS for _, _, r in program.window_calls(run)] == \
        [100, 200, 300]
    assert round(100 * 121 / 256, 2) == 47.27


def test_replay_launch_is_the_median_untraced_call_s(monkeypatch):
    recs = calls(monkeypatch)
    recs[2].profiled = False  # no traced call: all three are read
    run = synthetic_run(monkeypatch, recs)
    assert harness.reader("replay_launch_ms")(run) == pytest.approx(0.4)


def test_calls_after_a_profiler_session_are_left_out(monkeypatch):
    """The call at 300 ms, after the traced one, is read by no reader:
    the profiler's hooks stay and hold its graph launch."""
    recs = calls(monkeypatch) + [record(50, replay=0.6)]
    run = synthetic_run(monkeypatch, recs)
    run.calls.insert(0, (0.05, 0.055, 135))
    assert [r.start_ns // MS for _, _, r in program.window_calls(run)] == \
        [50, 100]
    assert harness.reader("replay_launch_ms")(run) == pytest.approx(
        (0.2 + 0.6) / 2)


def test_untraced_idle_from_the_records_events(monkeypatch):
    """Call at 100 ms: entry at 100 (the caller's t0), the pack's work
    from 100.1 done at 101.5, the graph launched 101.1–101.3 onto a busy
    queue, its work done at 104.0, the unpack's at 104.5; t1 105: idle
    0.1 + 0.5 = 0.6 ms of 5. Call at 300: pack done at 301.2, the launch ends at
    301.5 (0.3 idle), the graph done at 304.0, the unpack at 304.5; idle
    0.1 + 0.3 + 0.5 = 0.9 ms. The call at 200 ms, made without a
    profiler here, has no events."""
    recs = calls(monkeypatch)
    recs[2].profiled = False
    recs[3] = record(300, replay=0.4, device=[0, 1.2, 4.0, 4.5])
    run = synthetic_run(monkeypatch, recs)
    assert harness.reader("untraced_idle_pct")(run) == pytest.approx(
        (100 * 0.6 / 5 + 100 * 0.9 / 5) / 2)


def test_a_call_that_loaded_a_kernel_library_is_left_out(monkeypatch):
    """A library load inside the window is set-up work: the call that
    made it is read by no reader, untraced or traced."""
    recs = calls(monkeypatch)
    recs[2].profiled = False
    recs[1].built = True
    recs[3] = record(300, replay=0.4, device=[0, 1.2, 4.0, 4.5])
    run = synthetic_run(monkeypatch, recs)
    assert [r.start_ns // MS for _, _, r in program.window_calls(run)] == \
        [200, 300]
    assert harness.reader("replay_launch_ms")(run) == pytest.approx(0.7)
    assert harness.reader("untraced_idle_pct")(run) == pytest.approx(
        100 * 0.9 / 5)
    recs = calls(monkeypatch)
    recs[2].built = True
    run = synthetic_run(monkeypatch, recs, trace_ops())
    assert program.window_calls(run, profiled=True) == []
    assert harness.reader("all_steps_roofline")(run) is None


def test_all_steps_roofline_counts_every_launch_of_the_record(monkeypatch):
    run = synthetic_run(monkeypatch, calls(monkeypatch), trace_ops())
    b = lambda kind, rows, lanes: roofline.bound_s(  # noqa: E731
        kind, rows, lanes, SECP_P, 16, 16)
    bound = (2 * b("aff1s_ip", 65536, 256) + b("aff1g_ip", 65536, 256)
             + 5 * b("aff1s_ip", 32, 1))
    took = (2 * 1 + 2 + 5 * 0.5) / 1e6
    assert harness.reader("all_steps_roofline")(run) == pytest.approx(
        100 * bound / took)


def test_all_steps_roofline_leaves_out_a_call_that_lost_records(
        monkeypatch):
    run = synthetic_run(monkeypatch, calls(monkeypatch), trace_ops(4))
    assert harness.reader("all_steps_roofline")(run) is None


def test_all_steps_roofline_needs_one_record_a_traced_call(monkeypatch):
    recs = calls(monkeypatch)
    recs[3].profiled = True  # two traced records, one traced call
    run = synthetic_run(monkeypatch, recs, trace_ops())
    assert harness.reader("all_steps_roofline")(run) is None
    run = synthetic_run(monkeypatch, calls(monkeypatch))  # no trace
    assert harness.reader("all_steps_roofline")(run) is None


def test_every_reader_finds_nothing_without_a_record(monkeypatch):
    run = synthetic_run(monkeypatch, [], trace_ops())
    for m in READERS:
        assert harness.reader(m)(run) is None
    monkeypatch.delattr(profiling, "recorded")  # a program without it
    assert program.records() == []
    for m in READERS:
        assert harness.reader(m)(run) is None
