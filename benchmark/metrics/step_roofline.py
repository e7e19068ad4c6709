"""step_roofline: the step kernels' share of their roofline, Σ bound ÷ Σ
measured time over the step-kernel launches of the traced calls whose
shape the trace gives: a grid that is the frozen launch geometry's for
the tree's n rows by the lanes of the mix's graph (the scan executor's
batch steps; the batch rounded up to a power of two, since the kernel
computes the pad lanes too). Other launches (the D-engine's one-lane row
products, whose grid gives their rows only to 256) are left out; stderr
says how many and how long. The bound is ``benchmark/roofline.py``'s, at
the published peaks, on the bytes of the field's values."""

import sys

from benchmark import roofline


def read(run):
    if run.trace is None:
        return None
    cfg = run.config
    p, L, bits, n = (int(cfg["p"]), int(cfg["limbs"]), int(cfg["limb_bits"]),
                     int(cfg["n"]))
    fm = roofline.form(p, L, bits)
    shape = roofline.grid(fm, n, run.lanes)
    bound = took = left_s = 0.0
    counted = left = 0
    for name, start, end, grid in run.trace.all_ops():
        kind = roofline.step_kind(name)
        if kind is None:
            continue
        if grid != shape:
            left, left_s = left + 1, left_s + (end - start) / 1e6
            continue
        counted += 1
        bound += roofline.bound_s(kind, n, run.lanes, p, L, bits)
        took += (end - start) / 1e6
    print(f"step_roofline: {counted} launches of the mix's shape, "
          f"{took * 1e3:.3f} ms against a bound of {bound * 1e3:.3f} ms; "
          f"{left} other step launches left out, {left_s * 1e3:.3f} ms",
          file=sys.stderr)
    return 100 * bound / took if took else None
