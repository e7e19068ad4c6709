"""replay_launch_ms: a graph launch's cost to the host without a
profiler, the median over the window's calls made without one of a call's
host ms in the program's ``ecfft.replay`` spans (``graph.replay()``), from
the program's call record."""

import statistics

from benchmark import program


def read(run):
    ms = [rec.span_ns("ecfft.replay") / 1e6
          for _, _, rec in program.window_calls(run)
          if any(ch.how == "replay" for ch in rec.chunks)]
    return statistics.median(ms) if ms else None
