"""The program's own call record (``ecfft_tpu_torch.utils.profiling``),
as the per-layer metrics read it.

Each call of the window is matched to the record whose ``ecfft.call``
span started inside it (the harness's ``time.perf_counter`` and the
record's ``time.perf_counter_ns`` are one clock), so the set-up calls,
made before the window, fall out by time, the traced calls by their
flag, and a call that built or loaded a kernel library by its flag. A
program without the record gives no calls, and each reader then returns
None.
"""

from __future__ import annotations

import bisect


def records() -> list:
    """The calls the program recorded, oldest first; [] where it keeps no
    record."""
    try:
        from ecfft_tpu_torch.utils import profiling
    except ImportError:
        return []
    recorded = getattr(profiling, "recorded", None)
    return recorded() if recorded is not None else []


def window_calls(run, profiled: bool = False) -> list:
    """[(t0 ns, t1 ns, record)] for each call of ``run.calls`` whose record
    started inside it, in order: the calls made before any profiler
    session of the run, or with ``profiled`` those made under one (the
    traced calls). A call that built or loaded a kernel library (set-up
    work inside the window) is left out of both, and so are the calls
    after a session: the profiler's hooks stay in the process, and hold
    each later graph launch for milliseconds (PERF.md §5)."""
    recs = sorted((r.start_ns, r.id, r) for r in records()
                  if r.end_ns is not None and not r.built)
    first = min((s for s, _, r in recs if r.profiled), default=None)
    recs = [x for x in recs if x[2].profiled == profiled
            and (profiled or first is None or x[0] < first)]
    starts = [s for s, _, _ in recs]
    out = []
    for t0, t1, _ in run.calls:
        a, b = round(t0 * 1e9), round(t1 * 1e9)
        i = bisect.bisect_left(starts, a)
        if i < len(recs) and recs[i][0] <= b:
            out.append((a, b, recs[i][2]))
    return out
