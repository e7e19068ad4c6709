"""device_idle_pct: the median over the traced calls of the share of a
call's span in which no operation ran on the card, leaving out the idle
under a graph launch on the host (``trace.HELD``: the profiler's hold,
which untraced calls do not have; ``breakdown`` reports it on its own).
The median, and not the total, since the profiler now and then loses a
call's device records, which would read as idle."""

import statistics


def read(run):
    if run.trace is None:
        return None
    shares = [run.trace.idle_share(i) for i in range(run.trace.calls)]
    shares = [v for v in shares if v is not None]
    return 100 * statistics.median(shares) if shares else None
