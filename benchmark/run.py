"""Run one cell of the benchmark once and print its result as one JSON line.

Usage, from the root of a checkout, on a machine with the cell's cards::

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cells, their configurations, traffic mixes and metrics are named in
``BENCHMARK.json`` at the root; ``benchmark/harness.py`` says what a run
does. With ``--trace 0`` the result's metrics are the cell's end-to-end
metrics, with ``--trace 1`` its per-layer metrics, read from a
``torch.profiler`` trace of some of the window's calls. The last lines
on stderr, and the result's last key ``checks``, give each number that
decides ``correct`` beside its limit.

It exits non-zero and prints no result where no CUDA card is there (or
fewer than the cell asks for), where the program is missing, and where a
module of JAX or of the JAX package was loaded by the time the window
closed.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from benchmark import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    chips = harness.Cell(args.workload).entry["chips"]

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: {args.workload} runs on {chips} CUDA card(s); "
              f"this machine has {torch.cuda.device_count()} usable",
              file=sys.stderr)
        return 2
    result = harness.run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace))
    found = harness.forbidden_modules(list(sys.modules))
    if found:
        print(f"benchmark: JAX or the JAX package was loaded: "
              f"{', '.join(found)}", file=sys.stderr)
        return 3
    harness.print_checks(result["checks"])
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
