"""untraced_idle_pct: the card's idle in a call made without a profiler,
the median over the window's such calls that carry CUDA events (one in
eight) of the program's record's idle (``Call.idle_ns``: its events
placed on the host's clock from the entry event, and the host's spans)
from the call's start to its output synchronized (``run.calls``), over
that time."""

import statistics

from benchmark import program


def read(run):
    shares = []
    for t0, t1, rec in program.window_calls(run):
        idle = rec.idle_ns(t0, t1)
        if idle is not None and t1 > t0:
            shares.append(100 * idle / (t1 - t0))
    return statistics.median(shares) if shares else None
