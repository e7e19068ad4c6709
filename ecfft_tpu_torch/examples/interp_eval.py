"""End-to-end demo mirroring the reference's examples/interp_eval.rs:
build a secp256k1 FFTree, ENTER a random polynomial batch, check against
naive O(n^2) evaluation, then EXIT back to coefficients, with wall-clock
prints. Runs on the card unless ``--device cpu`` is given.

    python -m ecfft_tpu_torch.examples.interp_eval [log2_n] [batch] [--device cpu]
"""

import argparse
import random
import time

import torch

from ecfft_tpu_torch.fftree import build_fftree_native
from ecfft_tpu_torch.fields.registry import FIELDS
from ecfft_tpu_torch.utils.poly import evaluate


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("log2_n", nargs="?", type=int, default=10)
    ap.add_argument("batch", nargs="?", type=int, default=8)
    ap.add_argument("--device", default="cuda",
                    help="cpu to compute on the CPU, default = the card")
    args = ap.parse_args(argv)
    n, batch = 1 << args.log2_n, args.batch
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("interp_eval: no CUDA device (pass --device cpu "
                         "to compute on the CPU)")
    p = FIELDS["secp256k1"].p

    def fence():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    now = time.time()
    tree = build_fftree_native("secp256k1", n, device=dev)
    tree.prepare((n,))
    print(f"FFTree generation time: {time.time()-now:.2f}s")

    rng = random.Random()
    polys = [[rng.randrange(p) for _ in range(n)] for _ in range(batch)]
    enc = tree.encode(polys)

    fence()
    now = time.time()
    evals = tree.enter(enc)
    fence()
    print(f"evaluation time (fft), batch {batch}: {time.time()-now:.3f}s")

    now = time.time()
    dom = list(tree.eval_domain())
    naive = [evaluate(polys[0], x, p) for x in dom]
    print(f"naive O(n^2) eval (1 poly, host): {time.time()-now:.2f}s")
    assert list(tree.decode(evals[0])) == naive, "ECFFT != naive"

    now = time.time()
    coeffs = tree.exit(evals)
    fence()
    print(f"interpolation time (ifft): {time.time()-now:.3f}s")
    assert [list(r) for r in tree.decode(coeffs)] == polys
    print("roundtrip exact ✓")


if __name__ == "__main__":
    main()
