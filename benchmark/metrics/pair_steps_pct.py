"""pair_steps_pct: the share of the scan executor's step launches that ran
in the pair form (x2 read in place from the window's own pairs of rows q,
q XOR h: no gather), 100 × pair launches ÷ step launches, over the lane
chunks of the window's calls made without a profiler, from the program's
call record (each chunk's step launches by wrapper, in which a pair launch
counts as its step's, and its pair launches beside them). None where the
record notes no pair launches (a program without the pair form) or counts
no step launch."""

from benchmark import program


def read(run):
    chunks = [ch for _, _, rec in program.window_calls(run)
              for ch in rec.chunks]
    if not chunks or "pairs" not in getattr(chunks[0], "_fields", ()):
        return None
    steps = sum(k for ch in chunks for _, c in ch.shapes or ()
                for k in c.values())
    pairs = sum(k for ch in chunks for _, c in ch.pairs for k in c.values())
    return 100 * pairs / steps if steps else None
