"""ecfft-tpu benchmark on one card: batched ENTER throughput.

The port's counterpart of the repository's ``bench.py`` (the JAX package's
bench, which stays as it is), taken step by step. Run it on the card::

    python -m ecfft_tpu_torch.bench
    ECFFT_EXECUTOR=unrolled python -m ecfft_tpu_torch.bench
    ECFFT_BENCH_FIELD=m31 ECFFT_BENCH_N=1048576 ECFFT_BENCH_BATCH=128 \\
        python -m ecfft_tpu_torch.bench

Prints exactly ONE JSON line on stdout::

  {"metric": ..., "value": N, "unit": "polys/sec", "vs_baseline": N,
   "gpu_s_per_poly": ..., "native_1core_s_per_poly": ...,
   "native_baseline_reps_s": [...], "executor": ..., "device": ...}

``device`` is the card's name and power limit as ``nvidia-smi
--query-gpu=name,power.limit --format=csv,noheader`` prints them. On
stderr it logs its set-up: the seconds of each stage (the tree, the native
baseline, ``prepare``, the first call, the gate) and the peak device memory
(``torch.cuda.max_memory_allocated``).

Knobs, environment variables read when :func:`main` is called:
``ECFFT_BENCH_FIELD`` (secp256k1), ``ECFFT_BENCH_N`` (65536),
``ECFFT_BENCH_BATCH`` (256), ``ECFFT_BENCH_REPS`` (5), ``ECFFT_EXECUTOR``
(``unrolled`` selects the unrolled executor, else the scan one runs) and
``ECFFT_BENCH_DEVICE``: the run is on the card; ``cpu`` puts it on the CPU
(bench.py under ``JAX_PLATFORMS=cpu``). Without a card, and without that
variable, the bench exits non-zero and names the cause.

The protocol, bench.py's:

1. the tree from ``.bench_tree_<field>_<n>.npz`` at the repository root
   (``serialize_native``'s file, which either package reads), or built by
   the native engine and saved there;
2. the single-core native ENTER baseline, best of 3 on ``random.Random(1)``
   inputs, measured in this run;
3. ``prepare`` on the CPU with the pool and schedule files at the
   repository root, then ``place_on`` the run's device;
4. the gate inputs, ``np.random.RandomState(1)`` draw for draw as bench.py
   draws them: uniform 16-bit limbs with the top limb below p's, or for a
   one-limb field values uniform below p;
5. the first call, timed, then the gate: polys 0, B/2 and B − 1 equal to
   the native engine's ENTER, and EXIT of poly 0 back to its coefficients;
6. REPS timed calls, each on fresh inputs made on the device by a
   ``torch.Generator`` seeded with the rep (the same value recipe), the
   window opened after a synchronize and closed by a synchronize and the
   readback of one element; the best of them.

Two deliberate differences from bench.py:

- No executor fallback. bench.py re-runs a failed non-scan executor on
  the scan executor in a fresh process, which covers a failed gate too: a
  wrong unrolled result prints the scan executor's numbers and exits 0.
  Here any failure, the gate's included, exits non-zero with its error.
- One native tree. bench.py builds a second native tree for the gate; the
  baseline's serves the gate here (the same engine on the same domain),
  which saves one native build, minutes at n = 2^20, and changes no
  reported number.
"""

from __future__ import annotations

import json
import os
import random
import resource
import subprocess
import sys
import time

import numpy as np
import torch

# the repository root: the tree, pool and schedule caches live there, as
# bench.py keeps them beside itself
CACHE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class GateError(RuntimeError):
    """The card's result differs from the native engine's, or EXIT does not
    give back the coefficients."""


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def gate_inputs(spec, batch: int, n: int) -> np.ndarray:
    """bench.py's gate inputs, draw for draw: (batch, n, L) uint32."""
    rng = np.random.RandomState(1)
    L = spec.num_limbs
    if L == 1:
        return rng.randint(0, spec.p, size=(batch, n, 1)).astype(np.uint32)
    # uniform 16-bit limbs with a constrained top limb keeps values < p
    top = spec.to_limbs(spec.p)[-1]
    coeffs = rng.randint(0, 1 << 16, size=(batch, n, L)).astype(np.uint32)
    coeffs[..., -1] = rng.randint(0, top, size=(batch, n))
    return coeffs


def fresh_input(spec, batch: int, n: int, seed: int, device) -> torch.Tensor:
    """A (batch, n, L) int32 batch made on ``device`` by a generator seeded
    with ``seed``, by :func:`gate_inputs`' value recipe."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    L = spec.num_limbs
    if L == 1:
        return torch.randint(0, spec.p, (batch, n, 1), generator=gen,
                             device=device, dtype=torch.int32)
    x = torch.randint(0, 1 << 16, (batch, n, L), generator=gen,
                      device=device, dtype=torch.int32)
    x[..., -1] = torch.randint(0, spec.to_limbs(spec.p)[-1], (batch, n),
                               generator=gen, device=device,
                               dtype=torch.int32)
    return x


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _card(device) -> tuple[str, str]:
    """(the device's name, ``nvidia-smi``'s name and power limit)."""
    if device.type != "cuda":
        return "CPU", "cpu"
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    return torch.cuda.get_device_name(device), smi


def main() -> dict:
    """Run the bench; print its JSON line and return it as a dict."""
    from ecfft_tpu_torch.fftree import build_fftree_native
    from ecfft_tpu_torch.fields import device as fd
    from ecfft_tpu_torch.fields.registry import FIELDS
    from ecfft_tpu_torch.native import NativeFFTree
    from ecfft_tpu_torch.ops.schedule import unrolled_selected
    from ecfft_tpu_torch.serialize_native import (load_tables_npz,
                                                  save_tables_npz)

    field = os.environ.get("ECFFT_BENCH_FIELD", "secp256k1")
    # default = the BASELINE.md north-star config: ENTER n=2^16, batch 256
    n = int(os.environ.get("ECFFT_BENCH_N", str(1 << 16)))
    batch = int(os.environ.get("ECFFT_BENCH_BATCH", "256"))
    reps = int(os.environ.get("ECFFT_BENCH_REPS", "5"))
    where = os.environ.get("ECFFT_BENCH_DEVICE") or "cuda"
    if where not in ("cuda", "cpu"):
        raise SystemExit(f"bench: ECFFT_BENCH_DEVICE={where!r}: unset runs "
                         "on the card, cpu on the CPU")
    dev = torch.device(where)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("bench: no CUDA device; the bench runs on the card, "
                         "or on the CPU with ECFFT_BENCH_DEVICE=cpu")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    spec = FIELDS[field]
    executor = "unrolled" if unrolled_selected() else "scan"
    log(f"bench: field={field} n={n} batch={batch} reps={reps} "
        f"executor={executor} on {dev}")

    cache = os.path.join(CACHE_DIR, f".bench_tree_{field}_{n}.npz")
    t0 = time.perf_counter()
    if os.path.exists(cache):
        log("loading cached tree", cache)
        tree = load_tables_npz(cache, device="cpu")
        log(f"tree loaded in {time.perf_counter() - t0:.3f} s")
    else:
        log("building tree via native engine (one-time)...")
        tree = build_fftree_native(field, n, device="cpu")
        if tree is None:
            raise SystemExit(f"bench: n = {n} exceeds {field}'s curve "
                             "two-adicity")
        log(f"tree built in {time.perf_counter() - t0:.3f} s")
        t0 = time.perf_counter()
        save_tables_npz(tree, cache)
        log(f"tree saved in {time.perf_counter() - t0:.3f} s")

    # the single-core native baseline on the same workload, measured in
    # this run: 3 reps, best of
    log("measuring native single-core ENTER baseline (3 reps)...")
    t0 = time.perf_counter()
    nt = NativeFFTree(field, n)
    log(f"native tree built in {time.perf_counter() - t0:.3f} s")
    rng_ = random.Random(1)
    base_reps = []
    for _ in range(3):
        cs = [rng_.randrange(spec.p) for _ in range(n)]
        t0 = time.perf_counter()
        nt.enter(cs)
        base_reps.append(time.perf_counter() - t0)
    native_enter_s = min(base_reps)
    log(f"native single-core ENTER: {native_enter_s:.4f} s/poly "
        f"(reps {base_reps})")

    # pool and schedules on the CPU (cached at the repository root), then
    # moved to the run's device
    t0 = time.perf_counter()
    tree.prepare((n,), cache_dir=CACHE_DIR)
    log(f"prepare ({executor} executor): {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    tree.place_on(dev)
    log(f"place_on {dev}: {time.perf_counter() - t0:.3f} s")

    t0 = time.perf_counter()
    host_coeffs = gate_inputs(spec, batch, n)
    coeffs = torch.from_numpy(host_coeffs.view(np.int32)).to(dev)
    log(f"gate inputs drawn and placed: {time.perf_counter() - t0:.3f} s")

    _sync(dev)
    log(f"first call starts at {time.time():.3f} (s since the epoch)")
    t0 = time.perf_counter()
    out = tree.enter(coeffs)
    _sync(dev)
    int(out[0, 0, 0])
    log(f"first call: {time.perf_counter() - t0:.3f} s")

    # correctness gate: the result must match the native engine bit for
    # bit on several polys of the batch, in both directions
    t0 = time.perf_counter()
    for bi in dict.fromkeys((0, batch // 2, batch - 1)):
        expected = nt.enter([int(v) for v in fd.decode(spec,
                                                       host_coeffs[bi])])
        got = [int(v) for v in fd.decode(spec, out[bi])]
        if got != expected:
            pos = next(i for i, (a, b) in enumerate(zip(got, expected))
                       if a != b)
            raise GateError(f"ENTER on {dev} does not match the native "
                            f"engine (poly {bi}, first at position {pos})")
    back = tree.exit(out[:1])
    if not torch.equal(back[0], coeffs[0]):
        raise GateError(f"EXIT on {dev} does not round-trip ENTER (poly 0)")
    log(f"correctness gate passed ({dev} == native: ENTER x3 polys, EXIT "
        f"roundtrip) in {time.perf_counter() - t0:.3f} s")
    del out, back, coeffs, host_coeffs

    # fresh inputs every rep, made on the device; the window ends at a
    # readback of a result element
    times = []
    for rep in range(reps):
        fresh = fresh_input(spec, batch, n, rep, dev)
        _sync(dev)
        int(fresh[0, 0, 0])  # fence the generation
        t0 = time.perf_counter()
        out = tree.enter(fresh)
        _sync(dev)
        int(out[rep % batch, rep % n, 0])
        times.append(time.perf_counter() - t0)
        del fresh, out
    best = min(times)
    polys_per_sec = batch / best
    base = 1.0 / native_enter_s
    log(f"warm times: {times}; throughput {polys_per_sec} polys/s; native "
        f"1-core {base} polys/s; the reps end at {time.time():.3f} (s since "
        "the epoch)")
    if dev.type == "cuda":
        log(f"peak device memory: "
            f"{torch.cuda.max_memory_allocated(dev) / 1e9:.3f} GB")
    log(f"peak host memory: "
        f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6:.3f} GB")

    name, smi = _card(dev)
    result = {
        "metric": f"batched ENTER throughput, {field}, "
                  f"n=2^{n.bit_length() - 1}, batch {batch}, 1 {name}",
        "value": polys_per_sec,
        "unit": "polys/sec",
        "vs_baseline": polys_per_sec / base,
        "gpu_s_per_poly": best / batch,
        "native_1core_s_per_poly": native_enter_s,
        "native_baseline_reps_s": base_reps,
        "executor": executor,
        "device": smi,
    }
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
