#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA card, ``nvcc`` and ``g++``, and imports nothing of JAX.
Phases, each printed with its seconds; the first failure stops the run
with a non-zero exit:

1. device report: the card, ``nvidia-smi``'s name and power limit, the
   CUDA version, whether ``nvcc`` and ``triton`` are there;
2. build: the step kernels (ecfft_tpu_torch/csrc) and the native engine;
3. each of the three step kernels against its plain PyTorch version on the
   card, bit for bit (edge values, seeded random values at B = 1 and 256,
   a non-zero window start, rows outside the window untouched), again at
   the shapes the main path gives it (the step shape, and for the
   self-read kernel the D-engine's one-lane row products), then both
   timed at the main path's step shape;
4. the main path: batched ENTER of 256 secp256k1 polynomials at n = 2^16
   on a native-built tree, gated bit-for-bit against the native engine on
   polys 0, 128 and 255 plus an EXIT round trip, with the kernels' launch
   counts from that run, then timed over 5 warm reps on fresh inputs next
   to the native single-core baseline (best of 3) measured in the same run;
5. a JSON line of the kernels, the ``nvidia-smi`` line, and last the
   result line ``{"ok": true, "device": {...}}``.
"""

import json
import os
import random
import shutil
import subprocess
import sys
import time

import torch

from ecfft_tpu_torch import build_fftree_native
from ecfft_tpu_torch.fields import device as fd
from ecfft_tpu_torch.fields.registry import FIELDS
from ecfft_tpu_torch.native import NativeFFTree, native_library
from ecfft_tpu_torch.ops import emit, step
from ecfft_tpu_torch.ops.schedule import _d_engine

FIELD, N, BATCH, REPS = "secp256k1", 1 << 16, 256, 5
DEV = torch.device("cuda", 0)  # one card
SPEC = FIELDS[FIELD]
P = SPEC.p
L = SPEC.num_limbs
EDGE = [0, 1, P - 1, P - 2, P // 2, 2**16, 2**255 % P, (P - 1) // 2]
SOURCE = "ecfft_tpu_torch/csrc/step_kernels.cu"
REPLACES = {
    "aff1s_ip": "ecfft_tpu/ops/pallas_step.py:298",
    "aff1g_ip": "ecfft_tpu/ops/pallas_step.py:311",
    "aff2g_ip": "ecfft_tpu/ops/pallas_step.py:324",
}


def log(*a):
    print(*a, flush=True)


def check(ok: bool, what: str):
    if not ok:
        raise RuntimeError(f"check failed: {what}")


class Phase:
    def __init__(self, name):
        self.name = name

    def __enter__(self):
        log(f"== {self.name}")
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        if exc[0] is None:
            log(f"== {self.name}: {time.perf_counter() - self.t0:.3f} s")


def rand_limbs(shape, gen):
    """Canonical secp256k1 values as (..., L) int32 limbs: uniform 16-bit
    limbs with a top limb below p's (so every value is < p)."""
    x = torch.randint(0, 1 << 16, (*shape, L), generator=gen, device=DEV,
                      dtype=torch.int32)
    top = SPEC.to_limbs(P)[-1]
    x[..., -1] = torch.randint(0, top, shape, generator=gen, device=DEV,
                               dtype=torch.int32)
    return x


def plain_window(kind, coeffs, state, x1, x2, start):
    """The plain PyTorch version of ``kind`` on the same inputs: the new
    window rows (int64), the reference the kernel is held to."""
    if kind == "aff2g_ip":
        return step._muladd2_cols(SPEC, coeffs[0].unsqueeze(-1), x1,
                                  coeffs[1].unsqueeze(-1), x2)
    x1 = state[start:start + x2.shape[0]] if kind == "aff1s_ip" else x1
    return step._muladd1_cols(SPEC, coeffs[0].unsqueeze(-1), x1, x2)


def launch(kind, coeffs, state, x1, x2, start):
    wrapper = getattr(step, kind)
    if kind == "aff1s_ip":
        wrapper(SPEC, coeffs[0], state, x2, start)
    elif kind == "aff1g_ip":
        wrapper(SPEC, coeffs[0], state, x1, x2, start)
    else:
        wrapper(SPEC, coeffs[0], coeffs[1], state, x1, x2, start)


def operands(kind, W, A, B, gen, edge=False):
    n_coef = 2 if kind == "aff2g_ip" else 1
    state = rand_limbs((W, B), gen).permute(0, 2, 1).contiguous()
    if edge:  # every edge coefficient against every edge value
        E = len(EDGE)
        cvals = [EDGE[(i // E) % E] for i in range(A)]
        xvals = [[EDGE[(i + b) % E] for b in range(B)] for i in range(A)]
        coeffs = [fd.encode(SPEC, cvals, DEV)] * n_coef
        x = fd.encode(SPEC, xvals, DEV).permute(0, 2, 1).contiguous()
        x1, x2 = x, x.clone()
    else:
        coeffs = [rand_limbs((A,), gen) for _ in range(n_coef)]
        x1, x2 = (rand_limbs((A, B), gen).permute(0, 2, 1).contiguous()
                  for _ in range(2))
    return coeffs, state, x1, x2


def compare(kind, coeffs, state, x1, x2, start):
    """Run the kernel on a copy of ``state`` and hold its window against
    the plain version on the same operands. Rows outside the window must
    come back untouched. Returns (max |kernel - plain|, the plain window)."""
    A = x2.shape[0]
    want = plain_window(kind, coeffs, state, x1, x2, start)
    got = state.clone()
    launch(kind, coeffs, got, x1, x2, start)
    torch.cuda.synchronize()
    check(torch.equal(got[:start], state[:start])
          and torch.equal(got[start + A:], state[start + A:]),
          f"{kind}: rows outside the window changed")
    err = int((got[start:start + A].long() - want).abs_().max())
    return err, want


def cuda_ms(fn, reps):
    """Mean device milliseconds of ``fn`` over ``reps`` runs (CUDA events,
    after one warm-up run)."""
    fn()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def kernels_against_plain(gen, main_A, main_W, main_bsx):
    """Phase 3: bit-exact comparisons at small shapes and at the main
    path's shapes, then timings at the main path's step shape. Returns
    {kind: {"max_abs_err", "ms", "plain_ms"}}, the error the largest over
    every comparison of that kernel."""
    res = {}
    for kind in REPLACES:
        err = 0
        for B, edge in ((1, True), (256, True), (1, False), (256, False)):
            W, A, start = 1024, 512, 384
            coeffs, state, x1, x2 = operands(kind, W, A, B, gen, edge)
            e, want = compare(kind, coeffs, state, x1, x2, start)
            err = max(err, e)
            if edge and B == 1:  # and the plain version against ints
                dec = fd.decode(SPEC, want[:64, :, 0])
                cv = fd.decode(SPEC, coeffs[0][:64])
                xv = fd.decode(SPEC, x2[:64, :, 0])
                sv = fd.decode(SPEC, (x1 if kind != "aff1s_ip"
                                      else state[start:])[:64, :, 0])
                for q in range(64):
                    exp = (cv[q] * xv[q] + (cv[q] if kind == "aff2g_ip"
                                            else 1) * sv[q]) % P
                    check(dec[q] == exp, f"{kind} plain version vs ints")
            log(f"{kind} B={B} {'edge' if edge else 'random'}: "
                f"max |kernel - plain| = {e}")
        # the step shape of the main path: ENTER's state and window
        coeffs, state, x1, x2 = operands(kind, main_W, main_A, BATCH, gen)
        start = main_W - main_A - 128
        e, want = compare(kind, coeffs, state, x1, x2, start)
        del want
        err = max(err, e)
        log(f"{kind} at (W={main_W}, A={main_A}, L={L}, B={BATCH}): "
            f"max |kernel - plain| = {e}")
        if kind == "aff1s_ip":  # the D-engine's one-lane row products
            a, b = rand_limbs((main_bsx,), gen), rand_limbs((main_bsx,), gen)
            got = step.mul_rows(SPEC, a, b)
            want = step._muladd1_cols(
                SPEC, a.unsqueeze(-1), torch.zeros_like(a).unsqueeze(-1),
                b.unsqueeze(-1)).squeeze(-1)
            e = int((got.long() - want).abs_().max())
            err = max(err, e)
            log(f"{kind} one-lane row products (mul_rows) at ({main_bsx}, "
                f"{L}, 1): max |kernel - plain| = {e}")
        check(err == 0, f"{kind} disagrees with its plain version")
        torch.cuda.empty_cache()
        ms = cuda_ms(lambda: launch(kind, coeffs, state, x1, x2, start), 20)
        plain_ms = cuda_ms(
            lambda: plain_window(kind, coeffs, state, x1, x2, start), 3)
        log(f"{kind} at (W={main_W}, A={main_A}, L={L}, B={BATCH}): kernel "
            f"{ms:.3f} ms, plain {plain_ms:.3f} ms")
        res[kind] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
        del coeffs, state, x1, x2
        torch.cuda.empty_cache()
    return res


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.cuda.set_device(DEV)

    with Phase("1 device report"):
        name = torch.cuda.get_device_name(0)
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
        nvcc = shutil.which("nvcc") or (
            "/usr/local/cuda/bin/nvcc"
            if os.path.exists("/usr/local/cuda/bin/nvcc") else None)
        try:
            import triton
            triton_v = triton.__version__
        except ImportError:
            triton_v = None
        log(f"device: {name}; count {torch.cuda.device_count()}")
        log(smi)
        log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
            f"nvcc {nvcc}, triton {triton_v}")

    with Phase("2 build"):
        t0 = time.perf_counter()
        step.load_kernels()
        log(f"step kernels built and loaded in "
            f"{time.perf_counter() - t0:.3f} s")
        t0 = time.perf_counter()
        native_library()
        log(f"native engine built in {time.perf_counter() - t0:.3f} s")

    gen = torch.Generator(device=DEV)
    gen.manual_seed(1)
    # ENTER's state and window at n: W = 2n + 1 rounded up to 128 rows,
    # the combine steps' window of n rows, and the D-engine's n/2 scratch
    # rows (checked in phase 4)
    main_W, main_A, main_bsx = (2 * N + 1 + 127) & ~127, N, N // 2
    with Phase("3 kernels against their plain versions"):
        kstats = kernels_against_plain(gen, main_A, main_W, main_bsx)

    with Phase("4a tree, pool and schedules (set-up)"):
        tree = build_fftree_native(FIELD, N, device=DEV).prepare()
        sched = tree._schedule("enter", N)[0]
        log(f"W={sched.W} A={sched.A} steps={len(sched.xs[0])} "
            f"pool rows={tree._pool.shape[0]}")
        check((sched.W, sched.A, sched.bs_max) == (main_W, main_A,
                                                    main_bsx),
              "phase 3 checked other shapes than ENTER's")

    with Phase("4b native single-core ENTER baseline"):
        nt = NativeFFTree(FIELD, N)
        rng = random.Random(1)
        base = []
        for _ in range(3):
            cs = [rng.randrange(P) for _ in range(N)]
            t0 = time.perf_counter()
            nt.enter(cs)
            base.append(time.perf_counter() - t0)
        native_s = min(base)
        log(f"native ENTER: {native_s:.4f} s/poly (reps "
            f"{[round(t, 4) for t in base]})")

    with Phase("4c ENTER on the card, gated against the native engine"):
        coeffs = rand_limbs((BATCH, N), gen)
        torch.cuda.synchronize()
        for w in step.STEP_WRAPPERS:
            w.launches = 0
        t0 = time.perf_counter()
        out = tree.enter(coeffs)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        launches = {w.__name__: w.launches for w in step.STEP_WRAPPERS}
        log(f"first ENTER (B={BATCH}, n={N}): {first_s:.3f} s; kernel "
            f"launches {launches}")
        check(all(v > 0 for v in launches.values()),
              f"a step kernel was not launched on the main path: {launches}")
        check(out.shape == coeffs.shape and out.dtype == torch.int32,
              "ENTER output shape")
        check(bool(((out >= 0) & (out < 1 << 16)).all()),
              "ENTER output limbs out of range")
        for bi in (0, BATCH // 2, BATCH - 1):
            ints = [int(v) for v in fd.decode(SPEC, coeffs[bi])]
            got = [int(v) for v in fd.decode(SPEC, out[bi])]
            check(got == nt.enter(ints),
                  f"ENTER does not match the native engine (poly {bi})")
        back = tree.exit(out[:1].contiguous())
        check(torch.equal(back, coeffs[:1]),
              "EXIT does not round-trip ENTER (poly 0)")
        log(f"gate passed: ENTER == native on polys 0, {BATCH // 2}, "
            f"{BATCH - 1}; EXIT(ENTER(poly 0)) == poly 0")

    with Phase("4d ENTER timing, fresh inputs per rep"):
        times = []
        for _ in range(REPS):
            fresh = rand_limbs((BATCH, N), gen)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tree.enter(fresh)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        best = min(times)
        log(f"warm ENTER reps (s): {[round(t, 4) for t in times]}")
        log(f"ENTER throughput: {BATCH / best:.3f} polys/s "
            f"({best / BATCH * 1e3:.4f} ms/poly); native single-core "
            f"{native_s:.4f} s/poly = {1 / native_s:.3f} polys/s; "
            f"ratio {BATCH / best * native_s:.2f}x")
        # the D-engine's cost on one DOP_LEVEL step (5 one-lane row
        # products through the self-read kernel, plus plane gathers)
        t = int(next(i for i, d in enumerate(sched.xs[3][:, 0])
                     if d == emit.DOP_LEVEL))
        D = rand_limbs((max(sched.bs_max, 1),), gen)
        iD = rand_limbs((max(sched.bs_max, 1),), gen)
        d_ms = cuda_ms(lambda: _d_engine(SPEC, tree._pool, sched.xs[3][t],
                                         D, iD, int(sched.xs[0][t])), 20)
        log(f"D-engine, one DOP_LEVEL step ({sched.bs_max} rows): "
            f"{d_ms:.4f} ms")

    kernels = [{"name": k, "route": "cuda", "source": SOURCE,
                "replaces": REPLACES[k], "launches": launches[k],
                **kstats[k]} for k in REPLACES]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
