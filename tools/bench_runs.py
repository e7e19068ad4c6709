#!/usr/bin/env python3
"""Run the port's main bench once per batch size and executor, in order.

Each run is ``python -m ecfft_tpu_torch.bench`` in a process of its own,
as a user runs it, with ``ECFFT_BENCH_FIELD``, ``ECFFT_BENCH_N``,
``ECFFT_BENCH_BATCH`` and ``ECFFT_EXECUTOR`` set; the first run builds
the tree and the pool and schedule caches at the repository root, the
later ones read them. Each run's stdout and stderr go to
``<out>/bench_<field>_<n>_<batch>_<executor>.log`` (``--out``, default
``bench_logs/`` at the repository root); one line per run is
printed here (exit code, seconds, the JSON line), with the card's
``nvidia-smi`` name and power limit first. A failed run does not stop the
others; the exit code is 1 if any failed.

Usage::

    python3 tools/bench_runs.py secp256k1 1048576 8,64
    python3 tools/bench_runs.py m31 1048576 128 --executors scan,unrolled
"""

import argparse
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("field")
    ap.add_argument("n", type=int)
    ap.add_argument("batches", help="comma-separated batch sizes")
    ap.add_argument("--executors", default="scan,unrolled")
    ap.add_argument("--out", default=os.path.join(ROOT, "bench_logs"),
                    help="directory of the runs' logs")
    ap.add_argument("--timeout", type=float, default=3000.0,
                    help="seconds allowed to each run")
    args = ap.parse_args()
    os.makedirs(args.out, exist_ok=True)
    if shutil.which("nvidia-smi"):
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip(), flush=True)
    failed = 0
    for batch in (int(b) for b in args.batches.split(",")):
        for executor in args.executors.split(","):
            env = dict(os.environ, ECFFT_BENCH_FIELD=args.field,
                       ECFFT_BENCH_N=str(args.n),
                       ECFFT_BENCH_BATCH=str(batch),
                       ECFFT_EXECUTOR=executor)
            path = os.path.join(
                args.out,
                f"bench_{args.field}_{args.n}_{batch}_{executor}.log")
            t0 = time.perf_counter()
            with open(path, "w") as fh:
                try:
                    res = subprocess.run(
                        [sys.executable, "-m", "ecfft_tpu_torch.bench"],
                        cwd=ROOT, env=env, stdout=subprocess.PIPE,
                        stderr=fh, text=True, timeout=args.timeout)
                    rc, out = res.returncode, res.stdout
                except subprocess.TimeoutExpired as e:
                    rc, out = "timeout", e.stdout or ""
                fh.write(out if isinstance(out, str) else out.decode())
            failed += rc != 0
            print(f"{args.field} n={args.n} B={batch} {executor}: exit {rc} "
                  f"in {time.perf_counter() - t0:.1f} s", flush=True)
            print(out.strip() if isinstance(out, str) else out.decode(),
                  flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
