"""The reader of ``pair_steps_pct`` on a synthetic run: call records of the
program's own kind (``ecfft_tpu_torch.utils.profiling.Call``) whose chunks
ran some of their step launches in the pair form."""

import collections
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark import harness  # noqa: E402
from ecfft_tpu_torch.ops import step  # noqa: E402
from ecfft_tpu_torch.utils import profiling  # noqa: E402

MS = 1_000_000  # ns


def chunk(steps, pairs):
    """A replayed chunk of ``steps`` step launches, ``pairs`` of them
    aff1s_ip in the pair form and the others aff1g_ip."""
    shape = ("fold16", 65536, 256)
    shapes = [(w, collections.Counter({shape: k}))
              for w, k in ((step.aff1s_ip, pairs),
                           (step.aff1g_ip, steps - pairs)) if k]
    pair = ([(step.aff1s_pair_ip, collections.Counter({shape: pairs}))]
            if pairs else [])
    return profiling.Chunk(135, 256, "replay", None, shapes, True, 123, (),
                           pair)


def record(t0, chunks, profiled=False):
    """A call starting at ``t0`` ms with ``chunks`` [(steps, pairs)]."""
    rec = profiling.Call("enter", 65536, 135)
    rec.profiled = profiled
    s = t0 * MS
    rec.spans = [["ecfft.call", None, s, s + 3 * MS]]
    rec.chunks = [chunk(*c) for c in chunks]
    return rec


def run_of(monkeypatch, recs):
    """Three window calls at 100, 200 and 300 ms (5 ms each), after a
    set-up call at 10 ms."""
    monkeypatch.setattr(profiling, "recorded", lambda: list(recs))
    return harness.Run(
        config={"p": str(2**256 - 2**32 - 977), "limbs": 16,
                "limb_bits": 16, "n": 65536},
        calls=[(0.1, 0.105, 135), (0.2, 0.205, 135), (0.3, 0.305, 135)],
        window_s=0.25, setup_s=10.0, memory_peak_bytes=0, lanes=256,
        trace=None)


def read(run):
    return harness.reader("pair_steps_pct")(run)


def test_every_launch_in_the_pair_form_reads_100(monkeypatch):
    recs = [record(10, [(256, 0)]),  # set-up: left out
            record(100, [(256, 256)]), record(200, [(10, 10), (6, 6)]),
            record(300, [(256, 256)])]
    assert read(run_of(monkeypatch, recs)) == 100


def test_no_pair_launch_reads_0(monkeypatch):
    recs = [record(100, [(256, 0)]), record(200, [(256, 0)]),
            record(300, [(256, 0)])]
    assert read(run_of(monkeypatch, recs)) == 0


def test_a_mix_reads_the_share_of_the_untraced_chunks_launches(monkeypatch):
    """225 of 256 and 937 of 1056 launches in the pair form over the
    untraced window calls; a traced call, and the calls after it, are left
    out, as every reader of the record leaves them."""
    recs = [record(10, [(256, 0)]), record(100, [(256, 225)]),
            record(200, [(1056, 937)]), record(300, [(256, 0)])]
    assert read(run_of(monkeypatch, recs)) == \
        100 * (225 + 937) / (256 + 1056 + 256)
    recs[3].profiled = True
    assert read(run_of(monkeypatch, recs)) == \
        100 * (225 + 937) / (256 + 1056)
    recs[2].profiled = True
    assert read(run_of(monkeypatch, recs)) == 100 * 225 / 256


def test_none_without_a_pair_counter_or_a_step_launch(monkeypatch):
    assert read(run_of(monkeypatch, [])) is None
    assert read(run_of(monkeypatch, [record(100, [])])) is None
    # a chunk of a program whose record notes no pair launches
    old = profiling.Call("enter", 65536, 135)
    old.spans = [["ecfft.call", None, 200 * MS, 203 * MS]]
    fields = profiling.Chunk._fields[:-1]
    old.chunks = [collections.namedtuple("Chunk", fields)(
        *chunk(256, 0)[:len(fields)])]
    assert read(run_of(monkeypatch, [old])) is None
    # a chunk that counted no step launch (the plain path on the CPU)
    none = record(100, [(256, 0)])
    none.chunks = [none.chunks[0]._replace(shapes=[])]
    assert read(run_of(monkeypatch, [none])) is None
    run = run_of(monkeypatch, [record(100, [(256, 225)])])
    monkeypatch.delattr(profiling, "recorded")  # a program without it
    assert read(run) is None
