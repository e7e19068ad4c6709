"""all_steps_roofline: every step kernel's share of its roofline, the
median over the traced calls of Σ bound ÷ Σ measured time. The bound is
``benchmark/roofline.py``'s over the call's step launches as the
program's call record counts them, by kernel, rows and lanes (the
D-engine's one-lane launches too; no shape is taken from a grid); the
time is that of the trace's step-kernel records of the call. The traced
calls' records are matched to the trace's calls in order (None where
their counts differ); a call whose trace holds fewer step-kernel records
than its record counts (records the profiler lost) is left out, and
stderr says how many."""

import statistics
import sys

from benchmark import program, roofline

# the step kernel each step wrapper of the program launches
KIND = {"aff1s_ip": "aff1s_ip", "aff1g_ip": "aff1g_ip",
        "muladd1": "aff1g_ip", "aff2g_ip": "aff2g_ip",
        "muladd2": "aff2g_ip", "mulss": "mulss"}


def read(run):
    if run.trace is None:
        return None
    recs = [rec for _, _, rec in program.window_calls(run, profiled=True)]
    if not recs or len(recs) != run.trace.calls:
        return None
    cfg = run.config
    p, L, bits = int(cfg["p"]), int(cfg["limbs"]), int(cfg["limb_bits"])
    shares, lost = [], 0
    for rec, ops in zip(recs, run.trace.ops):
        launches = [(KIND[name], rows, lanes, k)
                    for (name, rows, lanes), k in rec.launches().items()
                    if name in KIND]
        counted = sum(k for *_, k in launches)
        took = [e - s for name, s, e, _ in ops if roofline.step_kind(name)]
        if not counted:
            continue
        if len(took) < counted:
            lost += 1
            continue
        bound = sum(k * roofline.bound_s(kind, rows, lanes, p, L, bits)
                    for kind, rows, lanes, k in launches)
        shares.append(100 * bound / (sum(took) / 1e6))
    print(f"all_steps_roofline: {len(shares)} traced calls read, {lost} "
          "left out (fewer step-kernel records than launches)",
          file=sys.stderr)
    return statistics.median(shares) if shares else None
