"""Per-op benchmark suite CLI.

The port's counterpart of ``ecfft_tpu/bench_suite.py``, with the same
options and output: the reference's benchmark protocol
(benches/fftree.rs:14-109: all eight algorithms at n = 2048 with
seed-fixed inputs on both fields, plus FFTree generate and serialize /
deserialize) and the ECFFT side of benches/comparison.rs (n = 8192), with
the classical NTT over the STARK prime beside it, batched. It runs on the
card unless ``--device cpu`` is given.

Usage::

    python -m ecfft_tpu_torch.bench_suite --field m31 --n 2048 --batch 8
    python -m ecfft_tpu_torch.bench_suite --comparison   # n = 8192 protocol
"""

from __future__ import annotations

import argparse
import random
import sys
import time

COMPARISON_N = 8192  # benches/comparison.rs's size


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--field", default="m31", choices=["m31", "secp256k1"])
    ap.add_argument("--n", type=int, default=2048)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--comparison", action="store_true",
                    help="run the benches/comparison.rs protocol (n=8192)")
    ap.add_argument("--native", action="store_true",
                    help="also time the single-core native engine")
    ap.add_argument("--device", default=None,
                    help="cpu to force the CPU, default = the card")
    args = ap.parse_args(argv)

    import torch

    import ecfft_tpu_torch as ec
    from ecfft_tpu_torch.fftree import build_fftree_native
    from ecfft_tpu_torch.serialize import deserialize_fftree, serialize_fftree
    from ecfft_tpu_torch.utils.profiling import time_op

    dev = torch.device("cpu" if args.device == "cpu" else
                       args.device or "cuda")
    if args.comparison:
        args.field, args.n = "secp256k1", COMPARISON_N
        # the classical-FFT side of benches/comparison.rs: radix-2 NTT on
        # the 2-adic STARK prime, same n, same batch, same executor
        from ecfft_tpu_torch.ntt import NTTPlan

        plan = NTTPlan(args.n, device=dev)
        rngc = random.Random(1)
        vals_ntt = [[rngc.randrange(plan.p) for _ in range(args.n)]
                    for _ in range(args.batch)]
        enc_ntt = plan.encode(vals_ntt)
        best, _ = time_op(lambda: plan.ntt(enc_ntt), reps=args.reps)
        print(f"# NTT evaluate (STARK prime): {best:.4f}s total, "
              f"{best / args.batch * 1e3:.3f} ms/poly", file=sys.stderr)
        best, _ = time_op(lambda: plan.intt(enc_ntt), reps=args.reps)
        print(f"# NTT interpolate (STARK prime): {best:.4f}s total, "
              f"{best / args.batch * 1e3:.3f} ms/poly", file=sys.stderr)

    field, n, batch = args.field, args.n, args.batch
    spec = ec.FIELDS[field]
    p = spec.p
    print(f"# field={field} n={n} batch={batch} device={dev}", file=sys.stderr)

    t0 = time.time()
    tree = build_fftree_native(field, 2 * n, device=dev)  # a tree of 2n
    gen_s = time.time() - t0

    rng = random.Random(1)
    vals = [[rng.randrange(p) for _ in range(n)] for _ in range(batch)]
    enc = tree.encode(vals)
    half_enc = enc[:, : n // 2].contiguous()

    rows = [("tree generate (native)", gen_s, 1)]

    cases = [
        ("ENTER", lambda: tree.enter(enc)),
        ("EXIT", lambda: tree.exit(enc)),
        ("DEGREE", lambda: tree.degree(enc)),
        ("EXTEND", lambda: tree.extend(enc, ec.S1)),
        ("MEXTEND", lambda: tree.mextend(enc, ec.S1)),
        ("MOD", lambda: tree.modular_reduce(enc)),
        ("REDC", lambda: tree.redc_z0(enc)),
        ("VANISH", lambda: tree.vanish(half_enc)),
    ]
    for name, fn in cases:
        best, _ = time_op(fn, reps=args.reps)
        rows.append((name, best, batch))

    t0 = time.time()
    data = serialize_fftree(tree, compress=True)
    rows.append(("serialize compressed", time.time() - t0, 1))
    t0 = time.time()
    deserialize_fftree(field, data, compress=True, device=dev)
    rows.append(("deserialize compressed", time.time() - t0, 1))

    if args.native:
        from ecfft_tpu_torch.native import NativeFFTree

        nt = NativeFFTree(field, 2 * n)
        for name, fn in (
            ("native ENTER (1 core)", lambda: nt.enter(vals[0])),
            ("native EXTEND (1 core)", lambda: nt.extend(vals[0][: n // 2], 1)),
        ):
            t0 = time.time()
            fn()
            rows.append((name, time.time() - t0, 1))

    w = max(len(r[0]) for r in rows) + 2
    print(f"{'op':<{w}}{'total s':>12}{'per poly ms':>14}")
    for name, secs, cnt in rows:
        print(f"{name:<{w}}{secs:>12.4f}{secs / cnt * 1e3:>14.3f}")


if __name__ == "__main__":
    main()
