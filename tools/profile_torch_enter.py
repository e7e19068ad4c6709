#!/usr/bin/env python3
"""Where the device time of one port transform goes, on one CUDA card.

Usage, from the repository root:

    python3 tools/profile_torch_enter.py [enter|exit] [n] [batch]

(default: enter 65536 256, the main path). Builds a secp256k1 tree with
the native engine, runs the transform once to warm up, then once more
under ``torch.profiler``. Prints the wall time of the profiled call
(fenced by ``torch.cuda.synchronize()``), the device kernels grouped by
name with their time, share and launches, the device busy share (the
union of the kernels' intervals over the wall time, so overlapping
kernels are not counted twice), the host's launches and CPU time, and
the peak device memory. Imports nothing of JAX.
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
    alg = sys.argv[1] if len(sys.argv) > 1 else "enter"
    n = int(sys.argv[2]) if len(sys.argv) > 2 else 1 << 16
    batch = int(sys.argv[3]) if len(sys.argv) > 3 else 256
    if not torch.cuda.is_available():
        print("profile_torch_enter: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    tree = build_fftree_native("secp256k1", n, device=dev).prepare()
    gen = torch.Generator(device=dev).manual_seed(1)
    x = torch.randint(0, 1 << 15, (batch, n, 16), generator=gen, device=dev,
                      dtype=torch.int32)  # top limb below p's: canonical
    run = getattr(tree, alg)
    run(x)
    torch.cuda.synchronize()
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
    print(f"{alg} n={n} B={batch}: profiled wall {wall * 1e3:.3f} ms on "
          f"{torch.cuda.get_device_name(0)}")
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
          f"{torch.cuda.max_memory_allocated(dev) / 1e9:.3f} GB")
    return 0


if __name__ == "__main__":
    sys.exit(main())
