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
once to warm up, times three more warm calls (the best wall, fenced by
``torch.cuda.synchronize()``, as polys/s), then runs it once more under
``torch.profiler``. Prints the wall time of the profiled call, the
device kernels grouped by name with their time, share and launches, the
device busy share (the union of the kernels' intervals over the wall
time, so overlapping kernels are not counted twice), the host's launches
and CPU time, and the peak device memory. Imports nothing of JAX.
"""

import collections
import os
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
from ecfft_tpu_torch import build_fftree_native  # noqa: E402


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

    run(x)
    torch.cuda.synchronize()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        run(x)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    torch.cuda.reset_peak_memory_stats(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(x)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.events()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    launches = sum(1 for e in events if e.name in (
        "cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC"))
    cpu_ms = sum(e.self_cpu_time_total for e in events
                 if e.device_type == DeviceType.CPU) / 1e3
    print(f"{alg} {field} n={n} B={batch}, {ex} executor: warm walls "
          f"{[round(w * 1e3, 3) for w in walls]} ms, best "
          f"{batch / min(walls):.1f} polys/s; profiled wall "
          f"{wall * 1e3:.3f} ms on {torch.cuda.get_device_name(0)}")
    if not kernels:
        print("the profiler recorded no device kernels")
        return 1
    by_name = collections.defaultdict(lambda: [0.0, 0])
    for e in kernels:
        by_name[e.name][0] += e.time_range.end - e.time_range.start
        by_name[e.name][1] += 1
    total = sum(t for t, _ in by_name.values())
    print(f"{'device ms':>10} {'share':>7} {'launches':>8}  kernel")
    for name, (t, c) in sorted(by_name.items(), key=lambda kv: -kv[1][0]):
        print(f"{t / 1e3:10.3f} {t / total:7.2%} {c:8d}  {name[:90]}")
    busy = busy_us((e.time_range.start, e.time_range.end) for e in kernels)
    print(f"device kernel time {total / 1e3:.3f} ms; busy (union) "
          f"{busy / 1e3:.3f} ms = {busy / 1e6 / wall:.1%} of the wall")
    print(f"host: {launches} kernel launches, {cpu_ms:.3f} ms CPU self "
          f"time; peak device memory "
          f"{torch.cuda.max_memory_allocated(dev) / 1e9:.3f} GB", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
