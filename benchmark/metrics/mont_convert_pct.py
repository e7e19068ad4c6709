"""mont_convert_pct: the share of a call the card spends converting the
state into and out of Montgomery form, the median over the window's calls
made without a profiler that carry CUDA events (one in eight) of the
device ns between the events the program places before and after each
conversion (the record's ``Call.convert_ns``: ``ecfft.to_mont`` and
``ecfft.from_mont`` of every chunk), over the call's time from its start
to its output synchronized (``run.calls``). None where no such call holds
conversion events: a field kept canonical on the card, or a program that
places none."""

import statistics

from benchmark import program


def read(run):
    shares = []
    for t0, t1, rec in program.window_calls(run):
        convert_ns = getattr(rec, "convert_ns", None)
        ns = convert_ns() if convert_ns is not None else None
        if ns is not None and t1 > t0:
            shares.append(100 * ns / (t1 - t0))
    return statistics.median(shares) if shares else None
