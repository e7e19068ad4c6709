"""One run of one cell of the benchmark, found by name in ``BENCHMARK.json``.

A cell names a configuration (``benchmark/configs/<config>.json``: the
field, its published curve constants and the tree size) and a traffic mix
(``benchmark/traffic/<traffic>.json``: the FFTree method, the batch a
call, how many outputs to keep for the check, how many calls to trace).
Each metric is a reader of its own, ``benchmark/metrics/<metric>.py``,
whose ``read(run)`` takes a :class:`Run` and returns a number, or None
where it finds nothing to read. A new configuration, mix or metric is a
new file and an entry in ``BENCHMARK.json``; no file here changes.

A run, in one process:

1. **Set-up** (``setup_s``: from the process's start to the first timed
   call): the tree's tables from the cache (``benchmark/cache``, built by
   the native engine and saved there where missing), the pool and the
   schedules through ``FFTree.prepare(cache_dir=…)``, the tree on the card,
   then a first call at the mix's batch (the eager step loop, then its
   capture as a CUDA graph) and one replay. The program's
   defaults hold: no executor is chosen, no knob is turned.
2. **The window**: calls back to back from one caller (a closed loop),
   each on a fresh batch made on the device from (seed, call index),
   uniform below p, for at least ``seconds``; the window closes when the
   call running at that moment ends. A call's latency runs from its start
   to its output synchronized on the device; making its input lies
   outside it. A sample of the outputs, drawn from the seed, is kept on
   the host. With ``trace``, a fixed number of whole calls a third of the
   way in run under ``torch.profiler``, each in a span of its own
   (``benchmark.trace``).
3. **After the window**: the peak memory is read, the program's state is
   freed, the sampled calls' inputs are made again from their seeds, and
   the plain reference (``benchmark.reference``) judges every kept output.
"""

from __future__ import annotations

import contextlib
import gc
import hashlib
import importlib.util
import itertools
import json
import os
import random
import subprocess
import sys
import time
import traceback

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
CACHE = os.path.join(BENCH, "cache")
# top-level module names that no run may hold: JAX and the JAX package
# (compared whole: the port's own name begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "ecfft_tpu")


def forbidden_modules(names) -> list:
    """The module names whose top-level name is one of :data:`FORBIDDEN`."""
    return sorted(m for m in names if m.split(".", 1)[0] in FORBIDDEN)


def process_age_s() -> float:
    """Seconds since this process started, from Linux's /proc (clock ticks
    of 10 ms)."""
    with open("/proc/self/stat") as fh:
        start = int(fh.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as fh:
        up = float(fh.read().split()[0])
    return up - start / os.sysconf("SC_CLK_TCK")


def load_json(path: str):
    with open(path) as fh:
        return json.load(fh)


def reader(name: str):
    """The ``read`` function of ``benchmark/metrics/<name>.py``."""
    path = os.path.join(BENCH, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Cell:
    """A cell of ``BENCHMARK.json`` with its configuration, traffic mix and
    the metrics it reports."""

    def __init__(self, name: str, root: str = ROOT):
        manifest = load_json(os.path.join(root, "BENCHMARK.json"))
        cells = {w["name"]: w for w in manifest["workloads"]}
        if name not in cells:
            raise SystemExit(f"benchmark: no workload {name!r}; there are "
                             f"{', '.join(sorted(cells))}")
        self.name, self.entry = name, cells[name]
        cfgs = {c["name"]: c for c in manifest["configs"]}
        self.config = load_json(os.path.join(
            root, cfgs[self.entry["config"]]["file"]))
        self.traffic = load_json(os.path.join(
            BENCH, "traffic", f"{self.entry['traffic']}.json"))

        def mine(m):
            return name in m.get("workloads", [name])

        self.end_to_end = [m for m in manifest["end_to_end"] if mine(m)]
        self.per_layer = [m for m in manifest["per_layer"] if mine(m)]


class Run:
    """What a metric's reader reads: the cell (``config``, ``traffic``),
    ``setup_s``, the window's ``calls`` as (start s, end s, polys), its
    length ``window_s``, ``memory_peak_bytes`` (what the allocator
    allocated at most, with the step loops' graph pool), the lanes of the
    graph the calls ran (``lanes``: the batch rounded up to a power of
    two), and ``trace`` (a
    :class:`benchmark.trace.Trace`, or None without ``--trace 1``)."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def call_seed(seed: int, tag) -> int:
    """A generator seed below 2^63 from the run's seed and a tag."""
    h = hashlib.blake2b(f"{seed}:{tag}".encode(), digest_size=8).digest()
    return int.from_bytes(h, "little") >> 1


def make_input(cfg: dict, batch: int, seed: int, dev):
    """A (batch, n, L) int32 batch made on ``dev`` from ``seed``: values
    uniform below p in one word, or 16-bit limbs with the top limb below
    p's (every value below p)."""
    import torch

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    p, n, L, bits = (int(cfg["p"]), int(cfg["n"]), int(cfg["limbs"]),
                     int(cfg["limb_bits"]))
    if L == 1:
        return torch.randint(0, p, (batch, n, 1), generator=gen, device=dev,
                             dtype=torch.int32)
    x = torch.randint(0, 1 << bits, (batch, n, L), generator=gen,
                      device=dev, dtype=torch.int32)
    x[..., -1] = torch.randint(0, p >> (bits * (L - 1)), (batch, n),
                               generator=gen, device=dev, dtype=torch.int32)
    return x


def percentile(values, q: float) -> float:
    """The q-th percentile of ``values``, linear between the closest ranks
    (numpy's default)."""
    v = sorted(values)
    pos = q / 100 * (len(v) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def bucket(b: int) -> int:
    """The lanes of the graph a call of ``b`` polynomials replays: ``b``
    rounded up to a power of two, the rest computed on zeros."""
    return 1 << (b - 1).bit_length()


class Sample:
    """A uniform sample, drawn from the seed, of at most ``size`` outputs
    of the window's calls (reservoir sampling over ``keep`` lanes a call),
    each copied to the host as it is taken."""

    def __init__(self, size: int, keep: int, seed: int):
        self.size, self.keep = size, keep
        self.rng = random.Random(f"{seed}:sample")
        self.seen, self.kept = 0, []  # kept: [call, batch, lane, output]

    def offer(self, call: int, batch: int, out) -> None:
        for lane in self.rng.sample(range(batch), min(self.keep, batch)):
            self.seen += 1
            slot = (len(self.kept) if len(self.kept) < self.size
                    else self.rng.randrange(self.seen))
            if slot < self.size:
                rec = [call, batch, lane, out[lane].to("cpu")]
                if slot == len(self.kept):
                    self.kept.append(rec)
                else:
                    self.kept[slot] = rec


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def set_up(cfg: dict, traffic: dict, dev, seed: int, cache: str = CACHE):
    """The tree on ``dev`` and its method of the mix, called once at the
    mix's batch (the eager loop, then the capture) and replayed once.
    Logs each stage's seconds, from the process's start, on stderr."""
    def stage(what):
        print(f"set-up: {what} by {process_age_s():.2f} s", file=sys.stderr,
              flush=True)

    stage("interpreter and torch loaded")
    from ecfft_tpu_torch.fftree import build_fftree_native
    from ecfft_tpu_torch.serialize_native import (load_tables_npz,
                                                  save_tables_npz)

    field, n = cfg["field"], int(cfg["n"])
    os.makedirs(cache, exist_ok=True)
    path = os.path.join(cache, f"tree_{field}_{n}.npz")
    if os.path.exists(path):
        tree = load_tables_npz(path, device="cpu")
        stage("tree loaded")
    else:
        tree = build_fftree_native(field, n, device="cpu")
        part = os.path.join(cache, f"tree_{field}_{n}.part.npz")
        save_tables_npz(tree, part)
        os.replace(part, path)
        stage("tree built and saved")
    tree.prepare((n,), cache_dir=cache)
    tree.place_on(dev)
    stage("prepared and placed")
    method = getattr(tree, traffic["method"])
    b = int(traffic["batch"])
    x = make_input(cfg, b, call_seed(seed, f"warm-up {b}"), dev)
    for what in ("first call (eager loop, capture)", "replay"):
        method(x)
        _sync(dev)
        stage(f"B = {b}: {what}")
    return tree, method


def window(method, cfg: dict, traffic: dict, seed: int, seconds: float, dev,
           trace: bool) -> dict:
    """Calls back to back for at least ``seconds``; see the module's
    docstring."""
    import torch
    from benchmark.trace import SPAN, collect

    b = int(traffic["batch"])
    sample = Sample(traffic["check_polys"], traffic["keep"], seed)
    calls, failed, error = [], 0, None
    prof, traced, want = None, 0, traffic["trace_calls"] if trace else 0
    t_open = time.perf_counter()
    for i in itertools.count():
        now = time.perf_counter()
        if now - t_open >= seconds and not (prof and traced < want):
            break
        x = make_input(cfg, b, call_seed(seed, i), dev)
        _sync(dev)
        if want and prof is None and now - t_open >= seconds / 3:
            prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])
            prof.start()
        span = (torch.profiler.record_function(SPAN)
                if prof is not None and traced < want
                else contextlib.nullcontext())
        t0 = time.perf_counter()
        try:
            with span:
                out = method(x)
                _sync(dev)
        except Exception:
            failed, error = 1, traceback.format_exc()
            break
        t1 = time.perf_counter()
        calls.append((t0, t1, b))
        if prof is not None and traced < want:
            traced += 1
            if traced == want:
                prof.stop()
        sample.offer(i, b, out)
        del x, out
    t_close = calls[-1][1] if calls else time.perf_counter()
    inside = sum(t1 - t0 for t0, t1, _ in calls)
    print(f"window: {len(calls)} calls in {t_close - t_open:.3f} s, "
          f"{inside:.3f} s inside them, the rest making inputs and keeping "
          "the sample", file=sys.stderr, flush=True)
    return {"calls": calls, "window_s": t_close - t_open, "failed": failed,
            "error": error, "sample": sample,
            "trace": collect(prof) if want and traced == want else None}


def judge(cfg: dict, traffic: dict, seed: int, sample: Sample, dev) -> dict:
    """The plain reference's verdict on the kept outputs: each number
    compared, with its limit."""
    import numpy as np

    from benchmark import reference as ref

    t0 = time.perf_counter()
    f = ref.Field(cfg)
    xs = ref.leaves(f)
    chk = ref.Checker(f, xs, ref.weights(f, xs), seed, ref.points_for(f))
    inputs, outputs = [], []
    by_call = {}
    for call, b, lane, out in sample.kept:
        by_call.setdefault((call, b), []).append((lane, out))
    for (call, b), recs in sorted(by_call.items()):
        x = make_input(cfg, b, call_seed(seed, call), dev)
        for lane, out in recs:
            inputs.append(x[lane].cpu().numpy())
            outputs.append(out.numpy())
        del x
    if not outputs:
        return {"checked_polys": {"value": 0, "at_least": 1}}
    xin, yout = np.stack(inputs), np.stack(outputs)
    coeffs, evals = ((xin, yout) if traffic["method"] == "enter"
                     else (yout, xin))
    ok = ref.check(chk, coeffs, evals)
    print(f"reference: {len(ok)} polys of {len(by_call)} calls judged in "
          f"{time.perf_counter() - t0:.2f} s", file=sys.stderr, flush=True)
    return {"checked_polys": {"value": len(ok), "at_least": 1},
            "noncanonical_values": {"value": ref.noncanonical(f, yout),
                                    "limit": 0},
            "wrong_polys": {"value": ok.count(False), "limit": 0}}


def passes(checks: dict) -> bool:
    return all(c["value"] >= c["at_least"] if "at_least" in c
               else c["value"] <= c["limit"] for c in checks.values())


def card(dev) -> dict:
    """The device as the result names it, with its power limit."""
    import torch

    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1}
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", f"--id={dev.index or 0}"],
            capture_output=True, text=True, check=True, timeout=30
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        smi = "not read"
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": 1, "nvidia_smi": smi}


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", root: str = ROOT, cache: str = CACHE,
             config: dict | None = None, traffic: dict | None = None,
             wrap=None) -> dict:
    """One run of cell ``name``: its result as ``run.py`` prints it.
    ``config`` and ``traffic`` replace the cell's (a smaller tree for a
    test); ``wrap(method)`` replaces the method the window calls (a fault
    or a control, for a test)."""
    import torch

    cell = Cell(name, root)
    cfg = config or cell.config
    if traffic is not None:
        cell.traffic = traffic
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    tree, method = set_up(cfg, cell.traffic, dev, seed, cache)
    setup_s = process_age_s()
    if wrap is not None:
        method = wrap(method)
    w = window(method, cfg, cell.traffic, seed, seconds, dev, trace)
    peak = 0
    if dev.type == "cuda":
        from ecfft_tpu_torch.ops import graphs

        peak = torch.cuda.max_memory_allocated(dev) + graphs.pool_bytes(dev)
    del tree, method
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    run = Run(config=cfg, traffic=cell.traffic, setup_s=setup_s,
              calls=w["calls"], window_s=w["window_s"],
              memory_peak_bytes=peak, trace=w["trace"],
              lanes=bucket(int(cell.traffic["batch"])))
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device_rec = card(dev)
    device_rec["memory_peak_bytes"] = peak
    result = {"attempted": len(w["calls"]) + w["failed"],
              "failed": w["failed"], "metrics": metrics}
    if trace and w["trace"] is not None:
        tr = w["trace"]
        print(f"trace: {tr.calls} calls, device records a call "
              f"{[len(ops) for ops in tr.ops]}, put in calls by their spans "
              f"on the {'device' if tr.by_device else 'host'}",
              file=sys.stderr, flush=True)
        device_rec["busy_s"] = tr.busy_us() / 1e6
        device_rec["window_s"] = tr.window_us() / 1e6
        result["breakdown"] = tr.breakdown()
    result["device"] = device_rec
    if w["error"]:
        print(w["error"], file=sys.stderr)
    checks = {"failed_calls": {"value": w["failed"], "limit": 0}}
    checks.update(judge(cfg, cell.traffic, seed, w["sample"], dev))
    result["correct"] = passes(checks)
    result["checks"] = checks
    return {k: result[k] for k in ("correct", "attempted", "failed",
                                   "metrics", "device", "breakdown",
                                   "checks") if k in result}


def print_checks(checks: dict) -> None:
    """Each number compared beside its limit, as the last lines of stderr."""
    for k, c in checks.items():
        limit = (f"at least {c['at_least']}" if "at_least" in c
                 else f"at most {c['limit']}")
        print(f"check {k}: {c['value']} ({limit})", file=sys.stderr,
              flush=True)
