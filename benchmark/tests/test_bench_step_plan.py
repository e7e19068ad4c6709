"""The reader of ``step_plan_pct`` on a synthetic run: call records of the
program's own kind (``ecfft_tpu_torch.utils.profiling.Call``) whose chunks
did or did not read a kept step plan."""

import collections
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark import harness  # noqa: E402
from ecfft_tpu_torch.utils import profiling  # noqa: E402

MS = 1_000_000  # ns


def record(t0, plans, profiled=False):
    """A call starting at ``t0`` ms with one replayed chunk a flag of
    ``plans`` (whether its loop read a kept plan)."""
    rec = profiling.Call("enter", 65536, 135)
    rec.profiled = profiled
    s = t0 * MS
    rec.spans = [["ecfft.call", None, s, s + 3 * MS]]
    rec.chunks = [profiling.Chunk(135, 256, "replay", None, [], kept,
                                  123 if kept else 0) for kept in plans]
    return rec


def run_of(monkeypatch, recs):
    """Three window calls at 100, 200 and 300 ms (5 ms each), after a
    set-up call at 10 ms."""
    monkeypatch.setattr(profiling, "recorded", lambda: list(recs))
    return harness.Run(
        config={"p": "2147483647", "limbs": 1, "limb_bits": 31,
                "n": 65536},
        calls=[(0.1, 0.105, 135), (0.2, 0.205, 135), (0.3, 0.305, 135)],
        window_s=0.25, setup_s=10.0, memory_peak_bytes=0, lanes=256,
        trace=None)


def test_every_chunk_from_a_kept_plan_reads_100(monkeypatch):
    recs = [record(10, [False]),  # set-up: left out
            record(100, [True]), record(200, [True, True]),
            record(300, [True])]
    assert harness.reader("step_plan_pct")(run_of(monkeypatch, recs)) \
        == 100


def test_a_mix_reads_the_share_of_chunks(monkeypatch):
    """Five window chunks, two without a kept plan; the traced call and
    the calls after it are left out, as every reader of the record
    leaves them."""
    recs = [record(10, [True]), record(100, [True, False]),
            record(200, [True, True, False]), record(300, [False])]
    assert harness.reader("step_plan_pct")(run_of(monkeypatch, recs)) \
        == 100 * 3 / 6
    recs[2].profiled = True
    assert harness.reader("step_plan_pct")(run_of(monkeypatch, recs)) \
        == 50


def test_none_without_chunks_or_a_plan_field(monkeypatch):
    reader = harness.reader("step_plan_pct")
    assert reader(run_of(monkeypatch, [])) is None
    assert reader(run_of(monkeypatch, [record(100, [])])) is None
    # a program whose record notes no plan (its chunks of five fields)
    chunk = collections.namedtuple("Chunk",
                                   "lanes graph_lanes how graph shapes")
    old = profiling.Call("enter", 65536, 135)
    old.spans = [["ecfft.call", None, 200 * MS, 203 * MS]]
    old.chunks = [chunk(135, 256, "replay", None, [])]
    assert reader(run_of(monkeypatch, [old])) is None
    run = run_of(monkeypatch, [record(100, [True])])
    monkeypatch.delattr(profiling, "recorded")  # a program without it
    assert reader(run) is None
