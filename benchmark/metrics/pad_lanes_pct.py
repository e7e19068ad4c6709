"""pad_lanes_pct: the share of the lanes the window's step loops computed
that were pad, 100 × Σ (graph lanes − lanes) ÷ Σ graph lanes over the
lane chunks of the window's calls made without a profiler, from the
program's call record (each chunk's lanes, and the lanes of the state its
step loop ran on: a graph's, rounded up by the program)."""

from benchmark import program


def read(run):
    chunks = [ch for _, _, rec in program.window_calls(run)
              for ch in rec.chunks]
    computed = sum(ch.graph_lanes for ch in chunks)
    if not computed:
        return None
    return 100 * sum(ch.graph_lanes - ch.lanes for ch in chunks) / computed
