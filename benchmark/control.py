"""The control of ``correct``: the cell's traffic with its outputs one
precision below what the configuration states, which the check has to
refuse. Run on the card, at the cell's own size::

    python3 benchmark/control.py --workload <cell> --seeds 1 2 3 \
        --seconds 5

For each seed, in one process (one set-up), a window of the cell's calls
whose outputs are put through :func:`lower_precision`, then the check.
Prints one JSON line a seed: the seed, ``correct`` and each number
compared. The benchmark's own runs never run this.

The configurations state exact field elements, so the step below is a
value kept to fewer bits: a 256-bit element of 16 limbs of 16 bits
computed to 240 (its lowest limb lost), an M31 element of one 32-bit word
kept in float32 (24 bits of mantissa). The output stays canonical, so
only the reference's identity can see the difference.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from benchmark import harness  # noqa: E402


def lower_precision(cfg: dict):
    """``wrap(method)``: the method with its outputs one precision below
    the configuration's."""
    import torch

    p = int(cfg["p"])

    def lower(out):
        if int(cfg["limb_bits"]) == 32:
            v = out.to(torch.float32).to(torch.float64).clamp(0, p - 1)
            return v.to(torch.int32)
        out = out.clone()
        out[..., 0] = 0
        return out

    def wrap(method):
        return lambda x: lower(method(x))

    return wrap


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)

    import torch

    cell = harness.Cell(args.workload)
    cfg, traffic = cell.config, cell.traffic
    dev = torch.device("cuda", 0)
    tree, method = harness.set_up(cfg, traffic, dev, args.seeds[0])
    method = lower_precision(cfg)(method)
    for seed in args.seeds:
        w = harness.window(method, cfg, traffic, seed, args.seconds, dev,
                           False)
        checks = {"failed_calls": {"value": w["failed"], "limit": 0}}
        checks.update(harness.judge(cfg, traffic, seed, w["sample"], dev))
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "calls": len(w["calls"]),
                          "correct": harness.passes(checks),
                          "checks": checks}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
