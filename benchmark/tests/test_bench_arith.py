"""The metrics' arithmetic: the union of intervals, the percentile over
calls, the frozen bound and launch geometry, and the readers on a
synthetic trace."""

import os
import random
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark import harness, roofline, trace  # noqa: E402

SECP_P = 2**256 - 2**32 - 977
M31_P = 2**31 - 1


def test_busy_is_the_union():
    assert trace.busy_us([]) == 0
    assert trace.busy_us([(0, 10), (5, 15), (20, 30)]) == 25
    assert trace.busy_us([(0, 10), (2, 3), (10, 12)]) == 12
    rng = random.Random(3)
    ivs = [(s, s + rng.uniform(0, 5)) for s in
           (rng.uniform(0, 100) for _ in range(200))]
    grid = np.zeros(110_000, dtype=bool)  # 1 ns cells over 0..110 µs
    for s, e in ivs:
        grid[int(round(s * 1000)):int(round(e * 1000))] = True
    assert trace.busy_us(ivs) == pytest.approx(grid.sum() / 1000, abs=0.3)
    m = trace.merged(ivs)
    assert all(a[1] < b[0] for a, b in zip(m, m[1:]))


def test_minus_leaves_what_the_cover_does_not_hold():
    cover = trace.merged([(2, 4), (6, 7), (9, 20)])
    assert trace.minus((0, 10), cover) == [(0, 2), (4, 6), (7, 9)]
    assert trace.minus((3, 5), cover) == [(4, 5)]
    assert trace.minus((10, 12), cover) == []
    assert trace.minus((0, 1), []) == [(0, 1)]


@pytest.mark.parametrize("n", [1, 2, 19, 20, 21, 300])
def test_percentile_is_numpys(n):
    v = [random.Random(n).expovariate(1.0) for _ in range(n)]
    for q in (50, 95, 99):
        assert harness.percentile(v, q) == pytest.approx(
            float(np.percentile(v, q)))


def test_bound_at_the_main_shape():
    # chip_smoke.py's bound at W 131200, A 65536, B 256 (PERF.md's table):
    # 0.963 ms by bytes for aff1s/aff1g, 0.964 for aff2g, 0.962 for mulss,
    # at 64 bytes an element; the frozen bound counts a value's 32
    for kind, ms in (("aff1s_ip", 0.963), ("aff1g_ip", 0.963),
                     ("aff2g_ip", 0.964), ("mulss", 0.962)):
        got = roofline.bound_s(kind, 65536, 256, SECP_P, 16, 16) * 1e3
        assert got == pytest.approx(ms / 2, abs=6e-4)
    assert roofline.value_bytes(SECP_P) == 32
    assert roofline.value_bytes(M31_P) == 4
    assert roofline.word_products("aff1g_ip", SECP_P, 16, 16) == 84
    assert roofline.word_products("aff2g_ip", SECP_P, 16, 16) == 148
    assert roofline.word_products("aff2g_ip", M31_P, 1, 32) == 2
    assert roofline.form(SECP_P, 16, 16) == "fold"
    assert roofline.form(M31_P, 1, 32) == "m31"
    stark = 2**251 + 17 * 2**192 + 1
    assert roofline.form(stark, 16, 16) == "cios"
    assert roofline.word_products("aff1g_ip", stark, 16, 16) == 64 + 72


def test_bound_is_chip_smokes():
    chip_smoke = pytest.importorskip("chip_smoke")
    spec = chip_smoke.FIELDS["secp256k1"]
    m31 = chip_smoke.FIELDS["m31"]
    saved = chip_smoke.SM_CLOCKS if hasattr(chip_smoke, "SM_CLOCKS") \
        else None
    chip_smoke.SM_CLOCKS = roofline.SMS * roofline.SM_CLOCK_HZ
    work = chip_smoke.thread_work
    chip_smoke.thread_work = lambda *a, **k: (1, {"fma": 0, "alu": 0,
                                                  "all": 0})
    try:
        for kind in ("aff1s_ip", "aff1g_ip", "aff2g_ip", "mulss"):
            for s, p, L, bits, B in ((spec, SECP_P, 16, 16, 256),
                                     (spec, SECP_P, 16, 16, 8),
                                     (m31, M31_P, 1, 32, 512)):
                # chip_smoke.py counts L·4 bytes an element, the frozen
                # bound a value's: the same for M31, half for secp256k1
                want = chip_smoke.bound(kind, 65536, B, spec=s)["bound_ms"]
                got = roofline.bound_s(kind, 65536, B, p, L, bits) * 1e3
                share = roofline.value_bytes(p) / (4 * L)
                assert got == pytest.approx(want * share, rel=1e-12)
    finally:
        chip_smoke.thread_work = work
        if saved is not None:
            chip_smoke.SM_CLOCKS = saved


def test_launch_geometry():
    assert roofline.grid("fold", 65536, 256) == (65536, 1, 1)
    assert roofline.grid("fold", 65536, 8) == (2048, 1, 1)
    assert roofline.grid("fold", 32768, 1) == (128, 1, 1)
    assert roofline.grid("fold", 100, 3) == (2, 1, 1)
    assert roofline.grid("m31", 65536, 512) == (65536, 2, 1)
    assert roofline.grid("m31", 32768, 1) == (128, 1, 1)
    assert roofline.grid("m31", 1000, 8) == (32, 1, 1)


def test_step_kinds():
    assert roofline.step_kind("void (anonymous namespace)::step_kernel<0>("
                              "Field, int const*)") == "aff1s_ip"
    assert roofline.step_kind("void (anonymous namespace)::"
                              "m31_step_kernel<2>(int const*)") == "aff2g_ip"
    assert roofline.step_kind("step_kernel<(int)3>") == "mulss"
    assert roofline.step_kind("void (anonymous namespace)::pair_kernel"
                              "<false>(Field)") is None
    assert roofline.step_kind("xstep_kernel<1>") is None


def synthetic_run(lanes=256):
    """Two traced calls: each a graph launch, two step kernels at the main
    shape, a gather and a one-lane D-engine launch, with gaps."""
    grid = roofline.grid("fold", 65536, lanes)
    ops, host, spans = [], [], []
    for k in range(2):
        t = 1000.0 * k
        spans.append((t, t + 100))
        host += [("cudaGraphLaunch", t + 1, t + 3),
                 ("cudaDeviceSynchronize", t + 3, t + 99),
                 ("aten::copy_", t + 0.5, t + 0.9),
                 ("cudaLaunchKernel", t + 0.6, t + 0.8)]
        ops += [("void at::native::vectorized_gather_kernel<16, long>()",
                 t + 5, t + 15, (1024, 1, 1)),
                ("void (anonymous namespace)::step_kernel<1>(Field)",
                 t + 15, t + 35, grid),
                ("void (anonymous namespace)::step_kernel<2>(Field)",
                 t + 40, t + 60, grid),
                ("void (anonymous namespace)::step_kernel<0>(Field)",
                 t + 60, t + 70, (128, 1, 1)),
                ("Memcpy DtoD (Device -> Device)", t + 70, t + 80, None)]
    ops.append(("void at::native::distribution_kernel()", 500, 510, None))
    tr = trace.Trace(spans, ops, host)
    return harness.Run(
        config={"p": str(SECP_P), "limbs": 16, "limb_bits": 16, "n": 65536},
        trace=tr, lanes=lanes, calls=[(0, 0.1, 256), (1, 1.1, 256)],
        window_s=1.25, setup_s=12.5, memory_peak_bytes=6_400_000_000)


def test_readers_on_a_synthetic_trace():
    run = synthetic_run()
    tr = run.trace
    assert tr.calls == 2 and tr.window_us() == 200
    assert sum(map(len, tr.ops)) == 10  # the harness's op between calls
    assert tr.busy_us() == 2 * 70
    read = {m: harness.reader(m)(run) for m in (
        "host_launches_per_call", "torch_ops_pct", "step_roofline",
        "device_idle_pct", "peak_mem_gb", "polys_per_s", "call_p95_ms",
        "setup_s")}
    assert read["host_launches_per_call"] == 2  # graph launch + a kernel
    assert read["torch_ops_pct"] == pytest.approx(100 * 20 / 70)
    b1 = roofline.bound_s("aff1g_ip", 65536, 256, SECP_P, 16, 16)
    b2 = roofline.bound_s("aff2g_ip", 65536, 256, SECP_P, 16, 16)
    assert read["step_roofline"] == pytest.approx(
        100 * 2 * (b1 + b2) / (2 * 40e-6))  # the one-lane launch left out
    # 30 µs idle a call, 2 of them under the graph launch (left out)
    assert [tr.idle(i)[1] for i in range(2)] == [2, 2]
    assert read["device_idle_pct"] == pytest.approx(100 * 56 / 196)
    assert read["peak_mem_gb"] == pytest.approx(6.4)
    assert read["polys_per_s"] == pytest.approx(512 / 1.25)
    assert read["call_p95_ms"] == pytest.approx(100)
    assert read["setup_s"] == 12.5


def test_breakdown_names_ops_and_idle():
    b = synthetic_run().trace.breakdown()
    ops = dict(b["device_ops"])
    assert ops["::step_kernel<1>"] == pytest.approx(40e-6)
    assert ops["Memcpy DtoD"] == pytest.approx(20e-6)
    idle = dict(b["idle_gaps"])
    # 0-5: 0-1 in a copy, 1-3 under the graph launch, 3-5 under the
    # synchronize; 35-40 and 80-100 under the synchronize
    assert idle[trace.HELD] == pytest.approx(2 * 2e-6)
    assert idle["aten::copy_"] == pytest.approx(2 * 1e-6)
    assert idle["cudaDeviceSynchronize"] == pytest.approx(2 * 27e-6)
    assert sum(idle.values()) == pytest.approx(2 * 30e-6)
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10


def test_readers_find_nothing_without_a_trace():
    run = synthetic_run()
    run.trace = None
    for m in ("host_launches_per_call", "torch_ops_pct", "step_roofline",
              "device_idle_pct"):
        assert harness.reader(m)(run) is None
    run = synthetic_run(lanes=8)  # no launch of the mix's shape
    run.lanes = 512
    assert harness.reader("step_roofline")(run) is None


def test_idle_is_the_median_call_s():
    # three calls of 30 µs with 3 ops of 5 µs; the second lost a record
    ops = [("k", t + 10.0 * i, t + 10.0 * i + 5, None)
           for t in (0, 100, 200) for i in range(3)
           if (t, i) != (100, 1)]
    run = harness.Run(trace=trace.Trace([(0, 30), (100, 130), (200, 230)],
                                        ops, []))
    assert [run.trace.idle_share(i) for i in range(3)] == [0.5, 2 / 3, 0.5]
    assert harness.reader("device_idle_pct")(run) == pytest.approx(50)


def test_chrome_events_give_grids_spans_and_host_events():
    ev = [{"ph": "X", "cat": "user_annotation", "name": trace.SPAN,
           "ts": 100.0, "dur": 50.0},
          {"ph": "X", "cat": "gpu_user_annotation", "name": trace.SPAN,
           "ts": 101.0, "dur": 48.0},
          {"ph": "X", "cat": "kernel", "name": "step_kernel<1>",
           "ts": 110.0, "dur": 20.0, "args": {"grid": [65536, 1, 1],
                                              "block": [256, 1, 1]}},
          {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoD",
           "ts": 131.0, "dur": 2.0, "args": {}},
          {"ph": "X", "cat": "cuda_runtime", "name": "cudaGraphLaunch",
           "ts": 102.0, "dur": 3.0},
          {"ph": "f", "cat": "ac2g", "name": "ac2g", "ts": 110.0},
          {"ph": "M", "name": "process_name", "ts": 0}]
    tr = trace.from_events(ev)
    assert tr.calls == 1 and tr.window_us() == 50 and tr.by_device
    assert tr.ops[0] == [("step_kernel<1>", 110.0, 130.0, (65536, 1, 1)),
                         ("Memcpy DtoD", 131.0, 133.0, None)]
    assert tr.launches() == 1


def test_device_records_go_by_the_device_spans():
    # the card's clock maps 20 µs late: the inputs' kernel made before the
    # call lands in its host span, the call's last kernel after it
    ops = [("input", 101.0, 104.0, None), ("k", 120.0, 140.0, None),
           ("last", 151.0, 155.0, None)]
    by_host = trace.Trace([(100, 150)], ops, [])
    by_dev = trace.Trace([(100, 150)], ops, [], [(120, 155)])
    assert not by_host.by_device and by_dev.by_device
    assert [r[0] for r in by_host.ops[0]] == ["input", "k"]
    assert [r[0] for r in by_dev.ops[0]] == ["k", "last"]
    # a device span missing for some call: the host's spans for all
    two = trace.Trace([(100, 150), (200, 250)], ops, [], [(120, 155)])
    assert not two.by_device


def test_collect_reads_a_cpu_profile():
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    x = torch.ones(64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            with record_function(trace.SPAN):
                x = x * 2 + 1
    tr = trace.collect(prof)
    assert tr.calls == 3
    assert all(any(n == "aten::mul" for n, _, _ in h) for h in tr.host)


def test_bucket_is_the_programs():
    assert harness.bucket(1) == 1 and harness.bucket(3) == 4
    assert harness.bucket(13) == 16 and harness.bucket(135) == 256
    assert harness.bucket(256) == 256 and harness.bucket(257) == 512
