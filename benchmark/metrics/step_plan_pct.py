"""step_plan_pct: the share of the window's lane chunks whose step loop
read a step plan that the program keeps (each schedule's index rows and
D-engine rows, made once per schedule and device), 100 × chunks with a
kept plan ÷ all chunks, over the lane chunks of the window's calls made
without a profiler, from the program's call record. None where the
record notes no plan (a program that keeps none) or holds no chunk."""

from benchmark import program


def read(run):
    chunks = [ch for _, _, rec in program.window_calls(run)
              for ch in rec.chunks]
    if not chunks or "plan" not in getattr(chunks[0], "_fields", ()):
        return None
    return 100 * sum(bool(ch.plan) for ch in chunks) / len(chunks)
