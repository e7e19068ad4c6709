#!/usr/bin/env python3
"""Where the device time of one port transform goes, on one CUDA card.

Usage, from the repository root:

    python3 tools/profile_torch_enter.py [methods] [n] [batch] [field] \
        [executors]

(default: enter 65536 256 secp256k1, the main path; ``field`` may be
``m31`` or a general prime of ``chip_smoke.py``'s phase 10: ``cios16``,
``stark``, ``fold4``, ``band16``, ``cios3``, ``cios13``, registered from
the curves that script hardcodes). ``methods`` is one of the FFTree's, or
several joined by commas (``enter,exit``): enter, exit, extend, mextend,
degree, redc_z0, redc_z1, modular_reduce, vanish; or general_redc_z0,
general_modular_reduce for a modulus table given at run time (a seeded
random one). ``n`` is the number of points of the input, on a tree of
that size (twice that size for extend, mextend and vanish); random
evaluations have full degree. ``executors`` is ``scan``, ``unrolled`` or
both joined by a comma (``scan,unrolled``); without it
``ECFFT_EXECUTOR=unrolled`` in the environment selects the unrolled
executor, as everywhere in the port. Builds a tree of the field with the
native engine, then for each executor and method: runs the transform
once (the first call on the card: the eager step loop, then its capture
as a CUDA graph), then for the replayed call and for the eager loop
(``ops.graphs._eager_loop``) in turn: times three warm calls (the best
wall, fenced by ``torch.cuda.synchronize()``, as polys/s), then runs one
more under ``torch.profiler``. Prints for each the wall time of the
profiled call, the device kernels grouped by name with their time, share
and launches, the device busy share (the union of the kernels' intervals
over the wall time, so overlapping kernels are not counted twice), the
host's kernel launches and graph launches, the device operations that
ran (a replay's: its graph's nodes), the peak device memory (the input
and the first call's output, held for the comparison, included), and
whether the last warm call's output equals the first call's bit for bit
(exit 1 where it does not). Imports nothing of JAX.
"""

import collections
import contextlib
import os
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
from ecfft_tpu_torch import build_fftree_native  # noqa: E402
from ecfft_tpu_torch.ops import graphs  # noqa: E402

KERNEL_LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel",
                   "cudaLaunchKernelExC", "cuLaunchKernelEx")
GRAPH_LAUNCHES = ("cudaGraphLaunch", "cuGraphLaunch")


def busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def main() -> int:
    algs = (sys.argv[1] if len(sys.argv) > 1 else "enter").split(",")
    n = int(sys.argv[2]) if len(sys.argv) > 2 else 1 << 16
    batch = int(sys.argv[3]) if len(sys.argv) > 3 else 256
    field = sys.argv[4] if len(sys.argv) > 4 else "secp256k1"
    executors = (sys.argv[5].split(",") if len(sys.argv) > 5 else [
        os.environ.get("ECFFT_EXECUTOR") or "scan"])
    if field not in ("secp256k1", "m31"):
        import chip_smoke  # registers its general fields as gp_<label>

        field = f"gp_{field}" if field in chip_smoke.CURVES else field
    if not torch.cuda.is_available():
        print("profile_torch_enter: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    size = max(2 * n if a.removeprefix("general_") in (
        "extend", "mextend", "vanish") else n for a in algs)
    tree = build_fftree_native(field, size, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)

    def limbs(*shape):  # canonical: M31 values, or a top limb below p's
        spec = tree.spec
        if spec.num_limbs == 1:
            return torch.randint(0, spec.p, (*shape, 1), generator=gen,
                                 device=dev, dtype=torch.int32)
        x = torch.randint(0, 1 << 16, (*shape, spec.num_limbs),
                          generator=gen, device=dev, dtype=torch.int32)
        x[..., -1] = torch.randint(0, spec.to_limbs(spec.p)[-1], shape,
                                   generator=gen, device=dev,
                                   dtype=torch.int32)
        return x

    x = limbs(batch, n)
    rc = 0
    for ex in executors:
        if ex == "unrolled":
            os.environ["ECFFT_EXECUTOR"] = "unrolled"
        else:
            os.environ.pop("ECFFT_EXECUTOR", None)
        for alg in algs:
            rc |= profile_one(tree, alg, ex, x, n, batch, field, limbs, dev)
    return rc


# the span and the device kernel of :func:`trace`'s prelude
PRELUDE, PRELUDE_KERNEL = "prelude", "FillFunctor<float>"


def trace(fn, dev, cpu: bool = True, prelude: int = 0) -> dict:
    """One call of ``fn`` under ``torch.profiler``, fenced by
    synchronizes: its wall seconds, the device's records (kernels, copies
    and fills) with their microseconds by name, the union of their
    intervals, and the host's kernel launches and graph launches (CUDA
    runtime records, which the CUDA activity traces; ``cpu`` adds the
    host's operator records, several a launch). The program's spans
    (``record_function``, which the profiler also lays over the device's
    records) are left out. Reads the profiler's raw records
    (``kineto_results``), which costs a small part of building its event
    tree at 10^5 launches.

    ``prelude``: that many fills of a one-element float tensor, run and
    synchronized under the profiler before ``fn`` in a span of their own,
    and left out of what is returned (the host's records up to the span's
    end, the device's by their kernel, which the port never launches). In
    a process that has run many profiler sessions, CUPTI now and then
    drops the first records of a session (up to about 16 kernels); the
    prelude takes them, so that ``fn``'s records are whole."""
    torch.cuda.synchronize(dev)
    acts = [ProfilerActivity.CUDA] + [ProfilerActivity.CPU] * cpu
    with profile(activities=acts) as prof:
        if prelude:
            with record_function(PRELUDE):
                pad = torch.zeros(1, device=dev)
                for _ in range(prelude):
                    pad.fill_(1.0)
                torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
    by_name = collections.defaultdict(lambda: [0.0, 0])
    host, spans = collections.Counter(), []
    events = list(prof.profiler.kineto_results.events())
    cut = max((e.start_ns() + e.duration_ns() for e in events
               if e.is_user_annotation() and e.name() == PRELUDE
               and e.device_type() != DeviceType.CUDA), default=None)
    for e in events:
        if e.is_user_annotation():  # a span, on the host or the device
            continue
        if cut is not None and (PRELUDE_KERNEL in e.name() if
                                e.device_type() == DeviceType.CUDA
                                else e.start_ns() <= cut):
            continue
        if e.device_type() == DeviceType.CUDA:
            us = e.duration_ns() / 1e3
            by_name[e.name()][0] += us
            by_name[e.name()][1] += 1
            spans.append((e.start_ns() / 1e3, e.start_ns() / 1e3 + us))
        else:
            host[e.name()] += 1
    return {
        "wall_s": wall, "device_ops": len(spans), "by_name": by_name,
        "busy_us": busy_us(spans),
        "kernel_launches": sum(host[k] for k in KERNEL_LAUNCHES),
        "graph_launches": sum(host[k] for k in GRAPH_LAUNCHES)}


def profile_one(tree, alg, ex, x, n, batch, field, limbs, dev) -> int:
    general = alg.startswith("general_")
    method = alg[len("general_"):] if general else alg
    tables = ()
    if general:
        a = limbs(n)  # no zero entry to invert
        a = a.clamp(min=1) if tree.spec.num_limbs == 1 else a | 1
        tables = (a,) * (2 if method == "modular_reduce" else 1)

    def run(x):
        return getattr(tree, method)(x, *tables)

    first = run(x)  # the first call: the eager loop and its capture
    torch.cuda.synchronize()
    rc = 0
    for mode in ("replay", "eager"):
        ctx = (graphs._eager_loop if mode == "eager"
               else contextlib.nullcontext)
        with ctx():
            walls = []
            for _ in range(3):
                t0 = time.perf_counter()
                out = run(x)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
            same = torch.equal(out, first)
            del out
            torch.cuda.reset_peak_memory_stats(dev)
            t = trace(lambda: run(x), dev)
        wall = t["wall_s"]
        print(f"{alg} {field} n={n} B={batch}, {ex} executor, {mode}: warm "
              f"walls {[round(w * 1e3, 3) for w in walls]} ms, best "
              f"{batch / min(walls):.1f} polys/s; profiled wall "
              f"{wall * 1e3:.3f} ms on {torch.cuda.get_device_name(0)}; "
              f"output {'==' if same else 'DIFFERS from'} the first "
              "call's (the eager loop's)")
        if not same:
            rc = 1
        if not t["device_ops"]:
            print("the profiler recorded no device operations")
            rc = 1
            continue
        total = sum(us for us, _ in t["by_name"].values())
        print(f"{'device ms':>10} {'share':>7} {'launches':>8}  kernel")
        for name, (us, c) in sorted(t["by_name"].items(),
                                    key=lambda kv: -kv[1][0]):
            print(f"{us / 1e3:10.3f} {us / total:7.2%} {c:8d}  {name[:90]}")
        print(f"device time {total / 1e3:.3f} ms; busy (union) "
              f"{t['busy_us'] / 1e3:.3f} ms = "
              f"{t['busy_us'] / 1e6 / wall:.1%} of the wall")
        print(f"host: {t['kernel_launches']} kernel launches, "
              f"{t['graph_launches']} graph launches, {t['device_ops']} "
              f"device operations ran; peak device memory "
              f"{torch.cuda.max_memory_allocated(dev) / 1e9:.3f} GB "
              f"allocated, {graphs.pool_bytes(dev) / 1e9:.3f} GB in the "
              "step loops' graph pool", flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
