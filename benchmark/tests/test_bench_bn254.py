"""The pieces the benchmark gained with ``bn254fq-n16`` (BN254's base field,
kept in Montgomery form on the card) and ``exit-b135``: the reference and
the roofline take the configuration, the traffic file carries what the
harness reads, a small run of the new cell on the CPU is judged correct
(and its control not), and on synthetic runs, after
``test_bench_program_metrics.py``, the reader ``mont_convert_pct`` and
``all_steps_roofline`` over a call whose conversions launch kernels."""

import collections
import json
import os
import sys
import types

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark import harness, reference as ref, roofline, trace  # noqa: E402
from benchmark.control import lower_precision  # noqa: E402
from ecfft_tpu_torch.utils import profiling  # noqa: E402

CELL = "bn254fq-n16.enter-b135"
Q = 0x30644e72e131a029b85045b68181585d97816a916871ca8d3c208c16d87cfd47
SECP_P = 2**256 - 2**32 - 977
MS = 1_000_000  # ns
STEP = "void (anonymous namespace)::step_kernel<{}>(Field)"


def config(name: str, **kw) -> dict:
    with open(os.path.join(ROOT, "benchmark", "configs",
                           f"{name}.json")) as fh:
        return dict(json.load(fh), **kw)


def test_the_reference_and_the_roofline_take_the_configuration():
    cfg = config("bn254fq-n16", n=32)
    f = ref.Field(cfg)
    assert f.p == Q and (f.limbs, f.limb_bits, f.two_adicity) == (16, 16, 21)
    xs = ref.leaves(f)
    lam = ref.weights(f, xs)
    for j in (0, 7, 31):
        d = 1
        for i in range(32):
            if i != j:
                d = d * (xs[j] - xs[i]) % Q
        assert lam[j] * d % Q == 1
    assert roofline.form(Q, 16, 16) == "cios"
    assert roofline.form(SECP_P, 16, 16) == "fold"
    assert roofline.word_products("aff1s_ip", Q, 16, 16) == 64 + 8 * 9
    assert harness.Cell(CELL).config["field"] == "bn254_fq"


def test_the_exit_traffic_carries_what_the_harness_reads():
    cell = harness.Cell("secp256k1-n16.exit-b135")
    t = cell.traffic
    assert t["method"] == "exit" and t["batch"] == 135
    assert (t["keep"], t["check_polys"], t["trace_calls"]) == (1, 32, 3)
    assert t["loop"].startswith("closed") and t["why"]
    assert harness.bucket(t["batch"]) == 256
    assert cell.config["field"] == "secp256k1"
    assert harness.Cell(CELL).traffic["method"] == "enter"


def test_a_small_run_of_the_cell_is_correct_and_its_control_is_not(
        tmp_path):
    """The cell on the CPU at n = 16, 3 polys a call, every lane kept: the
    tree built and saved by name in the cache, then judged."""
    c = harness.Cell(CELL)
    cfg = dict(c.config, n=16)
    traffic = dict(c.traffic, batch=3, keep=3, check_polys=10_000,
                   trace_calls=0)
    kw = dict(device="cpu", cache=str(tmp_path), config=cfg,
              traffic=traffic)
    res = harness.run_cell(CELL, 2**33 + 7, 0.1, False, **kw)
    assert res["correct"] and res["checks"]["checked_polys"]["value"] >= 3
    assert os.path.isfile(tmp_path / "tree_bn254_fq_16.npz")
    res = harness.run_cell(CELL, 2**33 + 7, 0.1, False,
                           wrap=lower_precision(cfg), **kw)
    assert not res["correct"]
    assert res["checks"]["wrong_polys"]["value"] == \
        res["checks"]["checked_polys"]["value"]


# ------------------------------------------------ readers of the record


class Event:
    """A CUDA event at a set device time (ms)."""

    def __init__(self, at):
        self.at = at

    def elapsed_time(self, other):
        return other.at - self.at

    def synchronize(self):
        pass


def record(t0, *, mont=True, profiled=False, device=None, launches=()):
    """A one-chunk replayed call of 135 lanes in 256 starting at ``t0``
    ms, 5 ms long, with marks at its entry, before and after each
    conversion (``mont``) and the replay, and at its end; ``device``:
    where its events completed, in ms after the entry; ``launches``:
    (wrapper, rows, lanes, count) of its step loop."""
    rec = profiling.Call("enter", 65536, 135)
    rec.profiled = profiled
    s = t0 * MS
    at = [0, 0.5, 1.0, 1.1, 4.0, 4.1, 4.6, 5.0] if mont else [0, 1.1, 4.0,
                                                              5.0]
    rec.marks = [s + round(a * MS) for a in at]
    rec.spans = [["ecfft.call", None, s, s + 5 * MS]]
    if device is not None:
        rec._events = [Event(d) for d in device]
    c = collections.Counter()
    for _, rows, ln, k in launches:
        c[("cios16", rows, ln)] += k
    shapes = [(types.SimpleNamespace(__name__="aff1s_ip"), c)] if c else []
    converts = ((profiling.Convert("ecfft.to_mont", 65536, 256, 1, (1, 2)),
                 profiling.Convert("ecfft.from_mont", 65536, 256, 1,
                                   (5, 6))) if mont else ())
    rec.chunks = [profiling.Chunk(135, 256, "replay", None, shapes, True,
                                  0, converts)]
    return rec


def synthetic_run(monkeypatch, recs, p=Q, trace_ops=None):
    """Three window calls at 100, 200 and 300 ms (5 ms each), the second
    traced, after a set-up call at 10 ms."""
    monkeypatch.setattr(profiling, "recorded", lambda: list(recs))
    tr = None
    if trace_ops is not None:
        tr = trace.Trace([(200_000.0, 205_000.0)], trace_ops, [])
    return harness.Run(
        config={"p": str(p), "limbs": 16, "limb_bits": 16, "n": 65536},
        calls=[(0.1, 0.105, 135), (0.2, 0.205, 135), (0.3, 0.305, 135)],
        window_s=0.25, setup_s=12.5, memory_peak_bytes=0, lanes=256,
        trace=tr)


def calls(mont=True):
    loop = [("aff1s_ip", 65536, 256, 2)]
    return [record(10, mont=mont),  # set-up
            record(100, mont=mont,
                   device=[0, 0.5, 0.55, 1.1, 4.0, 4.1, 4.2, 5.0][
                       :8 if mont else 4]),
            record(200, mont=mont, profiled=True, launches=loop),
            record(300, mont=mont,
                   device=[0, 0.5, 0.6, 1.1, 4.0, 4.1, 4.16, 5.0][
                       :8 if mont else 4])]


def test_mont_convert_pct_reads_the_events_around_the_conversions(
        monkeypatch):
    """Calls at 100 and 300 ms carry events: conversions of 0.05 + 0.1 ms
    and of 0.1 + 0.06 ms, of 5 ms calls (read here with no profiler
    session between them)."""
    recs = calls()
    recs[2].profiled = False
    run = synthetic_run(monkeypatch, recs)
    assert harness.reader("mont_convert_pct")(run) == pytest.approx(
        (100 * 0.15 / 5 + 100 * 0.16 / 5) / 2)


def test_mont_convert_pct_finds_nothing_without_conversion_events(
        monkeypatch):
    run = synthetic_run(monkeypatch, calls(mont=False), p=SECP_P)
    assert harness.reader("mont_convert_pct")(run) is None
    recs = calls()
    for rec in recs:
        rec._events = None  # calls that carry no events
    run = synthetic_run(monkeypatch, recs)
    assert harness.reader("mont_convert_pct")(run) is None
    run = synthetic_run(monkeypatch, [])
    assert harness.reader("mont_convert_pct")(run) is None


def test_mont_convert_pct_reads_a_record_without_conversions_as_none(
        monkeypatch):
    """A program whose call record knows no conversions (a record with
    neither ``convert_ns`` nor ``Chunk.converts``) gives no reading."""
    old = [types.SimpleNamespace(start_ns=r.start_ns, end_ns=r.end_ns,
                                 id=r.id, built=False, profiled=r.profiled)
           for r in calls()]
    run = synthetic_run(monkeypatch, old)
    assert harness.reader("mont_convert_pct")(run) is None


def trace_ops(records=4):
    t = 200_000.0  # µs
    return [(STEP.format(0), t + 500 + 1000 * k, t + 1500 + 1000 * k, None)
            for k in range(records)]


def test_all_steps_roofline_counts_the_conversions_launches(monkeypatch):
    """The traced call's step loop made two launches and its conversions
    one each, all over 65,536 rows and 256 lanes; four step-kernel
    records of 1 ms each."""
    run = synthetic_run(monkeypatch, calls(), trace_ops=trace_ops())
    bound = 4 * roofline.bound_s("aff1s_ip", 65536, 256, Q, 16, 16)
    got = harness.reader("all_steps_roofline")(run)
    assert got == pytest.approx(100 * bound / 4e-3)
    # a record of a conversion lost: the call is left out
    run = synthetic_run(monkeypatch, calls(), trace_ops=trace_ops(3))
    assert harness.reader("all_steps_roofline")(run) is None


def test_all_steps_roofline_on_a_canonical_field_and_without_a_trace(
        monkeypatch):
    """A canonical field's call counts only its step loop's two launches;
    a run with no trace reads nothing."""
    run = synthetic_run(monkeypatch, calls(mont=False), p=SECP_P,
                        trace_ops=trace_ops(2))
    bound = 2 * roofline.bound_s("aff1s_ip", 65536, 256, SECP_P, 16, 16)
    assert harness.reader("all_steps_roofline")(run) == pytest.approx(
        100 * bound / 2e-3)
    run = synthetic_run(monkeypatch, calls())  # no trace
    assert harness.reader("all_steps_roofline")(run) is None
