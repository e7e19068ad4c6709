"""Profiling and timing utilities.

The port's counterpart of ``ecfft_tpu/utils/profiling.py``:

- :func:`trace`: a context manager around ``torch.profiler`` that writes
  a Chrome trace of the host and (where a card is present) its kernels to
  ``log_dir``;
- :func:`time_op`: wall timing with warm-up, fenced by
  ``torch.cuda.synchronize()`` when a card holds the result;
- ``python -m ecfft_tpu_torch.bench_suite``: the per-op benchmark CLI
  (``ecfft_tpu_torch/bench_suite.py``).
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a profile: ``with trace("prof"): run()`` writes
    ``<log_dir>/trace.json`` (open it in chrome://tracing or Perfetto)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _on_card(x) -> bool:
    """Whether ``x`` (a tensor, or a tuple, list or dict of them) holds a
    CUDA tensor."""
    if isinstance(x, torch.Tensor):
        return x.is_cuda
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (tuple, list)):
        return any(_on_card(v) for v in x)
    return False


def _block(x):
    if _on_card(x):
        torch.cuda.synchronize()
    return x


def time_op(fn, *args, reps: int = 3, warmup: int = 1):
    """(best_seconds, result): times ``fn(*args)`` with device sync."""
    result = None
    for _ in range(warmup):
        result = _block(fn(*args))
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        result = _block(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best, result
