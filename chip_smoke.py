#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths once on one NVIDIA GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA card, ``nvcc``, ``cuobjdump`` and ``g++``, and imports
nothing of JAX. Phases, each printed with its seconds; the first failure
stops the run with a non-zero exit:

1. device report: the card, ``nvidia-smi``'s name and power limit, its SM
   count and top SM clock, the CUDA version, ``nvcc`` and ``triton``;
2. build: the seven kernel forms this run takes (``ecfft_tpu_torch/csrc``:
   secp256k1's "fold16", "m31", phase 10's "cios16", "fold4", "cios3"
   and "cios13", and the one-limb fold form "fold1" of phases 4d, 11 and
   12), one ``nvcc`` each, all started together, and the native
   engine; then the instructions one thread of each kernel of each form
   issues, per pipe, read from its SASS (``tools/sass_count.py``, with
   the fold rounds this run's values take in that form's field; for the
   operation bounds), and each kernel's registers, shared bytes and
   spills;
3. set-up: a native-built secp256k1 tree at n = 2^16, its pool, the
   ENTER/EXIT schedules and the unrolled executor's fusion analysis; 3b
   the same for M31; 3c for each general prime of phase 10, registered
   with ``register_field`` from the curve FIND_CURVE found for it;
4. each of the nine kernels against its plain PyTorch version on the
   card, bit for bit: edge values and seeded random values at B = 1 and
   256 with rows outside the window untouched (the state×state product
   also with one buffer as both factors), then at the shapes the main
   paths give it; the five on 32-bit words (aff1s, mulss, the pair
   levels, the cascade) also on inputs that stress the word reduction,
   for secp256k1 and for 2^255 − 19; then each timed at its main shape
   (CUDA events, with the SM clock and power draw read just after) beside
   its plain version, its bound (bytes or word products) and this
   design's issue bound; then (4b) the nine M31 forms likewise (edge
   values 0, 1, p − 1, p − 2, 2^30, (p − 1)/2, 2^16 and seeded random ones
   at B = 1 and 256, rows outside the window untouched, the square, then
   the M31 main shapes at B = 2048), each timed beside its plain version,
   its byte bound and the int64 PyTorch expression of the same function;
   then (4c) the general prime's forms likewise (edge values 0, 1, 2,
   p − 1, p − 2, p − 3, (p − 1)/2, R mod p, R² mod p, p − (R mod p) and
   the largest below 2^(16L − 1); seeded random ones), each timed at its
   field's phase-10 shape: "cios16" with the STARK prime's constants at
   the full width (and the 256-bit prime of slack 0 at the small shapes),
   "fold4" (M61), and at n = 2^10 "band16" (2^256 − 1053 on the "fold16"
   form), "cios3" and "cios13", whose launches' device times come from a
   ``torch.profiler`` trace as in 4d; then (4d) the one-limb fold form "fold1" likewise, for
   64513 (F = 1023, slack 0) with the edge values of 4c and the largest
   value below 2^16, timed at the window of phase 11's 64513 NTT (A =
   2^10, B = 256; each launch's device time from a ``torch.profiler``
   trace, since the host's work between launches outlasts a launch
   there; where three traces hold no record of the kernel, from CUDA
   events around one launch queued behind a spin, and the log says
   which), and for 97 and 65521 at the small shapes;
5. the native single-core ENTER baseline (best of 3);
6. the scan executor (the default): batched ENTER of 256 polynomials at
   n = 2^16 gated bit-for-bit against the native engine on polys 0, 128
   and 255 plus an EXIT round trip, with its kernels' launch counts; then
   5 warm reps on fresh inputs and the peak device memory;
7. the same through the unrolled executor (``ECFFT_EXECUTOR=unrolled``),
   whose EXIT round trip runs the 2-mul generic kernel; its launch counts
   beside the counts its fusion analysis predicts;
8. the six other algorithms at full width on the same tree, each on both
   executors: EXTEND and MEXTEND (2^15 points, onto S0 and S1), DEGREE
   (n = 2^16, lanes of different known degrees), REDC by Z0 and by Z1 and
   MOD by the tree's own X^(n/2) (n = 2^16), VANISH (2^15 points), and
   REDC and MOD by a modulus table given at run time (n = 2^16 too).
   Each is gated bit for bit against the native engine on lanes 0 and
   255, the two executors against each other on the whole batch, its
   launch counts against the schedule's steps and the fusion analysis,
   and timed warm (best of 2, fenced by ``torch.cuda.synchronize()``);
   8c. persistence on the same tree: ``serialize_fftree`` in both modes,
   the bytes identical after a deserialize and a reserialize; the npz
   tables saved and loaded; ``prepare(cache_dir=…)`` on a temporary
   directory by the deserialized tree (it writes the pool and schedule
   files) and by the npz tree (it must read them); the ENTER of the whole
   batch equal to the tree's on the deserialized and the cached trees
   (and the EXIT on the cached one), and on a tree built on the CPU,
   prepared there and moved to the card with ``place_on``; each step
   with its seconds and bytes;
   8d. the device bootstrap, the unscheduled algorithms and sharding:
   (a) ``FFTree.build`` on the card for secp256k1 and M31 at n = 2^16
   (phase 3's and 3b's trees), the 256-bit CIOS prime at n = 2^16 and
   the STARK prime at n = 2^10 (3c's), 64513 at n = 64, every table of
   every size and each ``mats`` plane equal bit for bit to the native
   engine's, each bootstrap's seconds beside the native build's (timed in
   phases 3–3c) and its launches per kernel; (b) on phase 3's tree at
   B = 256 each ``*_unscheduled`` algorithm (ENTER with EXIT's round
   trip, EXTEND and MEXTEND onto both moieties over 2^15 points, DEGREE on
   lanes of known degrees, REDC by Z0 and Z1 and MOD by the tree's own
   tables, VANISH over 2^15 points) equal on the whole batch to the
   scheduled method on the same input, both timed warm (best of 2), and
   a ``ShardedFFTree`` over two shards of the card running the same
   inputs, plus REDC and MOD by tables given at run time: the shards,
   concatenated, equal to the unsharded output, each on its device;
   (c) the unscheduled algorithms likewise on phase 3b's M31 tree at
   B = 256. Throughout 8d the kernels' plain versions (and the plain
   field product) must see no CUDA tensor, and mulss, muladd1 and muladd2
   must launch;
9. M31: a batch of B = 2048 at n = 2^16 through all eight algorithms on
   both executors (ENTER with its EXIT round trip, then the others as in
   phase 8), each gated bit for bit against the native engine on lanes 0
   and B − 1 and the executors against each other on the whole batch, its
   launches against the schedule and the analysis, timed warm with the
   peak device memory; every M31 form must run;
10. the general prime, each field as phase 9 on both executors: a 256-bit
   prime of slack 0 without a fold (the CIOS form, 16 limbs) at the full
   width, n = 2^16, B = 256, all eight algorithms; M61 (the fold form, 4
   limbs) at n = 2^16, B = 1024, ENTER with its EXIT round trip and
   VANISH; the STARK prime, 2^256 − 1053 and the CIOS primes of 3 and 13
   limbs at n = 2^10, B = 256, all eight algorithms; every form's nine
   kernels must run;
11. the classical NTT (``ecfft_tpu_torch.ntt.NTTPlan``) on both
   executors: the STARK prime at n = 2^16, B = 256 (the "cios16" form),
   then 64513 at n = 2^10 and 97 at n = 32, B = 256 ("fold1"); gated:
   intt(ntt(x)) == x on the whole batch, ntt against Horner evaluation in
   Python ints on lanes 0 and B − 1 (8 root powers at 2^16, all of them
   below), the executors equal, the launches one 2-mul step a stage plus
   the state's two Montgomery conversions; forward and inverse timed warm
   (best of 5), and the STARK NTT's polys/s printed beside phases 6b/7b's
   secp256k1 ENTER (the reference's benches/comparison.rs);
12. the one-limb fold prime's tree: 64513 on a curve FIND_CURVE found, at
   n = 64 (the host's isogeny chain stops there), B = 256, all eight
   algorithms on both executors as phase 10, with the unrolled tile at 8
   rows so that n = 64 reaches every fused kernel; gated against the
   native engine (the JAX package's one-limb product is wrong at this
   prime); every "fold1" kernel must launch;
13. the per-op bench suite as a user runs it, in processes of their own
   that must exit 0: ``python -m ecfft_tpu_torch.bench_suite --field m31
   --n 2048 --batch 256`` and ``--comparison --batch 128``, their tables
   printed;
14. the host-side modules: (a) the host oracle (``host.fftree``, python
   ints), a third witness beside the native engine and the other
   executor: a spawned process, started after phase 6b with phase 6a's
   lane 0, builds its secp256k1 tree at n = 2^16 and ENTERs that lane
   while phases 7–13 run; its evaluations must equal the scan executor's
   ENTER of the lane on the card; (b) two seeded lanes of M31
   coefficients at n = 4096, evaluated by the host oracle, EXITed on the
   card on both executors back to the coefficients; (c) the binary-field
   tree, GF(2^9) at n = 16 (host only): ENTER against naive evaluation
   and the EXIT round trip; (d) Schoof through the native engine: the
   order of y² = x³ + 8x + 81 over M31 (2147489041), and over 2^61 − 1
   within Hasse's bound with N·P = O on two points; (e) the examples as
   users run them, each in a process of its own that must exit 0:
   ``python -m ecfft_tpu_torch.examples.interp_eval`` (n = 2^10, batch 8,
   on the card), ``find_curve 10`` and ``schoof_large 61``;
15. the main bench as ``python -m ecfft_tpu_torch.bench`` runs it, called
   in this process at secp256k1, n = 2^16, B = 256, 5 reps, once on the
   default executor and once with ``ECFFT_EXECUTOR=unrolled``, on phase
   3's tree (saved to the bench's cache file, so the bench builds only its
   native baseline's tree): each run prints exactly one JSON line naming
   the executor asked for, passes its gate and reports polys/s > 0, with
   no plain version called on a CUDA tensor; its polys/s printed beside
   phases 6b's and 7b's;
16. a JSON line of the kernels (the nine 16-limb forms, whose launches are
   phases 6–8's and 15's, the nine M31 forms, phase 9's, the nine of each general
   form, phase 10's (and phase 11's STARK NTT for "cios16"), and the nine
   "fold1" forms, phases 11's and 12's, each with its form's launches of
   phase 8d added, and the M31 forms' with 14b's; 72 in all, named
   ``"aff1s_ip[cios16]"`` and so on), the ``nvidia-smi`` line, and last
   the result line ``{"ok": true, "device": {...}}``.
"""

import collections
import contextlib
import ctypes
import io
import json
import math
import multiprocessing
import os
import random
import shutil
import subprocess
import sys
import time
import types

import numpy as np
import torch

from ecfft_tpu_torch import FFTree, bench, build_fftree_native
from ecfft_tpu_torch.ec.curve import Point, ShortWeierstrass
from ecfft_tpu_torch.fields.binary import GF512
from ecfft_tpu_torch.fields import device as fd
from ecfft_tpu_torch.fields.host import sqrt_mod
from ecfft_tpu_torch.fields.registry import (FIELDS, register_field,
                                             spec_for_prime)
from ecfft_tpu_torch.host.fftree import (_evaluate, build_host_fftree,
                                         build_host_fftree_even)
from ecfft_tpu_torch import native
from ecfft_tpu_torch.native import NativeFFTree, native_library
from ecfft_tpu_torch.ntt import STARK_GENERATOR, STARK_P, NTTPlan
from ecfft_tpu_torch.ops import _build, emit, step, unrolled
from ecfft_tpu_torch.ops.schedule import _d_engine
from ecfft_tpu_torch.parallel.sharding import ShardedFFTree, make_mesh
from ecfft_tpu_torch.schoof import cardinality_native
from ecfft_tpu_torch.serialize import deserialize_fftree, serialize_fftree
from ecfft_tpu_torch.serialize_native import load_tables_npz, save_tables_npz
from ecfft_tpu_torch.utils.poly import evaluate
from tools import sass_count

FIELD, N, BATCH, REPS = "secp256k1", 1 << 16, 256, 5
DEV = torch.device("cuda", 0)  # one card
SPEC = FIELDS[FIELD]
P = SPEC.p
L = SPEC.num_limbs
ED = spec_for_prime(2**255 - 19)  # a second fold-friendly prime, slack 1
EDGE = [0, 1, P - 1, P - 2, P // 2, 2**16, 2**255 % P, (P - 1) // 2]
M31 = FIELDS["m31"]
M31_N, M31_BATCH = 1 << 16, 2048  # (131200, 1, 2048) int32 = 1.07 GB
M31_EDGE = [0, 1, M31.p - 1, M31.p - 2, 1 << 30, (M31.p - 1) // 2, 1 << 16]
# the general prime (phases 4c and 10): fields a user registers with
# register_field after FIND_CURVE (``native.find_curve_parallel`` found
# each curve offline, its coset point drawn as field_from_curve_search
# draws it), as lib.rs hardcodes secp256k1's curve. label: (p, a, B = b²,
# subgroup generator, coset offset, 2-adicity)
CURVES = {
    # 256 bits, slack 0, no fold: the CIOS form at 16 limbs, full width
    "cios16": (
        0xaacdabbb49c9c6072c54a01283037cadfde8ec5e3e1544596ebbec4cc598e9c7,
        0x69f41e7a9e125a221a9f39e1a970e266894abacbfecdbf18a25ae4679bc9327c,
        0x42ab9776845b792ed01b295180db18df09fa72cbfa5a52fa9da872dac8d0b616,
        (0x8d1869d5830133c2f57e5c44cf7f8ab2c9634041c199f3117741751270d42c64,
         0x3df97905a2786cbdd7ba704200709564773cf304a4d754161a62f24eb7110801),
        (0x1e2feb89414c343c1027c4d1c386bbc4cd613e30d8f16adf91b7584a2265b1f5,
         0x40412c9cdd62c507e5114bf808d7578b44ed38e788163e79d02d02b7b8d57461),
        18),
    # the STARK prime (no fold, slack 4): the host's isogeny chain builder
    # (ec/curve.py) stops after a few levels on most of its curves; this
    # one builds trees up to n = 2^10
    "stark": (
        0x0800000000000011000000000000000000000000000000000000000000000001,
        0x05b2daa498b030603df3e25dc566f9124bcb7e072f463eaffeb0074b7d6f124b,
        0x0779d1b5e0189e099c9ac94e378ca60584332f6571244a90443872236b814800,
        (0x0793a98892746f3d979a4880eb9eeedfcf2c3fc09834d5d9cb7bee1a25a84c68,
         0x0034cb06dcfdc21a8c91848f8259d31c3e0262d2eff156d4dbd7a7440479ca8f),
        (0x035bf992c9e9c616612e7696a6cecc1b78e510617311d8a3c2ce6f447ed4d57b,
         0x0491bedba9c70d50099adefceb688bb0d765d2f69d17157394a79ccac610ad95),
        13),
    # M61 = 2^61 - 1: the fold form at 4 limbs (F = 8, slack 3)
    "fold4": (
        (1 << 61) - 1, 0xecdc0b8148d8108, 0x187d577ae1410e52,
        (0x149c57a8c28cbfbc, 0x24cf3f3202f1f3),
        (0x19ac27c6d8f16adf, 0x1ee5e2c2e9610638), 20),
    # 2^256 - 1053: the fold form at 16 limbs with its digit past 2^10
    "band16": (
        (1 << 256) - 1053,
        0x9a56acd64f31e54d30ff201bf9201bfa8ba605452db839c9d9e90ceaeac684c0,
        0x78ee8aefb331e12e025d5c44ffbf47e1da7d0d58ee3d06ecb4a7db04f8f175c7,
        (0xda62ee4d341bb59c3d5bc41b48c0db9ce1d692d412e0f796df23973b79f8a21f,
         0x7c02beb9b0c6c0128ffa1fed0c8df362d5a301e938b18adbc2cd240ca6540ed3),
        (0x35bf992dc9e9c616612e7696a6cecc1b78e510617311d8a3c2ce6f447ed4d57b,
         0xbd43f7a6711539d84b0701ca0a528608b3765cc4f6b8c4610d291119e08761ed),
        17),
    # CIOS at odd limb counts: R = 2^48 and 2^208, a 16-bit last round
    "cios3": (
        0xff8000000f, 0x3f2f3e08fa, 0x4c03da9c52,
        (0xaf6176c937, 0x15a9a765ad), (0xcdd8f16adf, 0x5c24f4ed43), 14),
    "cios13": (
        0xd9cd502d42af1ffe0de8d79f49af6d114c4a6f188a424e61cb,
        0x156425c5244c746cccfb5a1fbd51575e705dc17ec44fcecaa5,
        0x81a00041e06f254041685fa1d7ae8a674f95f1f82b8629da3b,
        (0x36fc711e2bab16219646077eda21fc4fb3380e7f230776583b,
         0x1f4c8606415d7202ee1dc7daa9045922f6e6eb5b26f25f6a08),
        (0x7e1e2feb89414c343c1027c4d1c386bbc4cd613e30d8f16adf,
         0xb5e528edf47a8687b256827cba3aee6d657c5a3e3dad290240), 17),
    # 64513 = 2^16 - 1023: one 16-bit limb, the "fold1" form (F = 1023,
    # slack 0); #E = 2^10 * 63, and the host's isogeny chain builds trees
    # up to n = 64 on this curve (phase 12)
    "fold1": (64513, 17298, 51821, (48076, 63964), (37303, 46450), 10),
}
# each field's path (phase 10): n, B, and what runs on both executors
# ("all": the eight algorithms; "enter": ENTER with its EXIT round trip
# and VANISH, whose OP_MUL steps launch mulss)
PATHS = {"cios16": (1 << 16, 256, "all"), "fold4": (1 << 16, 1024, "enter"),
         "stark": (1 << 10, 256, "all"), "band16": (1 << 10, 256, "all"),
         "cios3": (1 << 10, 256, "all"), "cios13": (1 << 10, 256, "all")}
GSPEC = {label: register_field(f"gp_{label}", *curve)
         for label, curve in CURVES.items()}
# the classical NTT (phase 11): the reference comparison's STARK prime at
# the main width, the one-limb fold prime 64513 at n = 2^10, and p = 97 at
# the JAX package's own test size: (label, p, generator, n, B)
NTT_PATHS = (("stark", STARK_P, STARK_GENERATOR, 1 << 16, 256),
             ("fold1 64513", 64513, 5, 1 << 10, 256),
             ("fold1 97", 97, 5, 32, 256))
# the one-limb fold prime's tree (phase 12): n = 64 (its curve's chain
# stops there), B = 256, the unrolled executor's tile at 8 rows so that
# n = 64 reaches every fused kernel
FOLD1_N, FOLD1_BATCH, FOLD1_TW = 64, 256, 8
FOLD1_EDGE_N = 1 << 10  # phase 4d's main shapes: the 64513 NTT's window
# phase 14, the host-side modules: the host oracle's child process (about
# two minutes of python ints at n = 2^16) and how long phase 14 waits for
# it at most; 14b's M31 EXIT at n = 4096 (the JAX package's
# tests/test_sched_chunk.py certifies its own there); 14d's curve
# y² = x³ + 8x + 81 and its order over M31; 14e's k for find_curve
HOST_TIMEOUT_S = 600
HOST_M31_N = 4096
SCHOOF_CURVE, SCHOOF_M31_ORDER = (8, 81), 2147489041
FIND_CURVE_K = 10
HBM_BYTES_PER_S = 3.35e12  # H100 SXM (the data sheet)
# sm_90, per SM and clock (the CUDA C++ Programming Guide's throughput
# table, compute capability 9.0): 64 results of "32-bit integer multiply,
# multiply-add, extended-precision multiply-add" (IMAD, IMAD.WIDE), the
# rate of the work bound's word products; for this design's issue bound,
# 64 lanes on the FMA pipe, 64 of integer add, logic, shift and compare
# on the ALU pipe beside it, and 4 warp instructions (128 lanes) issued
WORD_PRODUCTS_PER_SM, PIPE_LANES_PER_SM, ISSUE_LANES_PER_SM = 64, 64, 128
# warm-up before a kernel is timed: right after a plain run at the main
# shape (tens of GB of int64 temporaries freed) the next launches run up
# to 8% slower for a few tens of ms (tools/ab_step_kernels.py)
SETTLE_S = 0.25
# a cascade's threads per (128-row tile, group of lanes): CL and CT of
# fused_kernels.cu's cascade_kernel (three words or more), and a warp per
# wc::lanes(NW) lanes in the warp design of warp_cascade.cuh (M31 and the
# word forms of one word: 8 lanes; of two words: 4)
CASCADE_LANES, CASCADE_THREADS = 4, 512
WARP_CASCADE_LANES, WARP_CASCADE_THREADS = {1: 8, 2: 4}, 32
STEP_SRC = "ecfft_tpu_torch/csrc/step_kernels.cu"
FUSED_SRC = "ecfft_tpu_torch/csrc/fused_kernels.cu"
M31_SRC = "ecfft_tpu_torch/csrc/m31_kernels.cu"
KERNELS = {  # wrapper: (source, the TPU kernel it replaces)
    "aff1s_ip": (STEP_SRC, "ecfft_tpu/ops/pallas_step.py:298"),
    "aff1g_ip": (STEP_SRC, "ecfft_tpu/ops/pallas_step.py:311"),
    "aff2g_ip": (STEP_SRC, "ecfft_tpu/ops/pallas_step.py:324"),
    "muladd1": (STEP_SRC, "ecfft_tpu/ops/pallas_step.py:338"),
    "muladd2": (STEP_SRC, "ecfft_tpu/ops/pallas_step.py:364"),
    "fused_cascade": (FUSED_SRC, "ecfft_tpu/ops/unrolled.py:200"),
    "fused_bf1": (FUSED_SRC, "ecfft_tpu/ops/unrolled.py:272"),
    "fused_bf2": (FUSED_SRC, "ecfft_tpu/ops/unrolled.py:345"),
    # no TPU kernel: the JAX package leaves the state x state product to XLA
    "mulss": (STEP_SRC, "ecfft_tpu/ops/schedule.py:1357"),
}
WRAPPERS = {w.__name__: w
            for w in (*step.STEP_WRAPPERS, *unrolled.FUSED_WRAPPERS)}
SCAN_KERNELS = ("aff1s_ip", "aff1g_ip", "aff2g_ip")
UNROLLED_KERNELS = ("aff1s_ip", "muladd1", "muladd2", "fused_cascade",
                    "fused_bf1", "fused_bf2")
# the SASS function of each wrapper's kernel in a word form's library
# (step_kernels.cu, fused_kernels.cu: muladd1/2 launch step_kernel<1>/<2>,
# the kernels of aff1g/aff2g; the cascade of one or two words
# word_warp_cascade, :func:`sass_names`) and in the M31 form's
# (m31_kernels.cu); each form has a library of its own
# what every kernel function's name of the port holds (the device names
# in a profiler trace are demangled: ``void step_kernel<2>(...)``)
KERNEL_BASES = ("step_kernel", "pair_kernel", "cascade")
SASS_NAMES = {"aff1s_ip": "step_kernelILi0E", "aff1g_ip": "step_kernelILi1E",
              "aff2g_ip": "step_kernelILi2E", "muladd1": "step_kernelILi1E",
              "muladd2": "step_kernelILi2E", "mulss": "step_kernelILi3E",
              "fused_bf1": "pair_kernelILb0E", "fused_bf2": "pair_kernelILb1E",
              "fused_cascade": "cascade_kernel"}
M31_SASS_NAMES = {
    "aff1s_ip": "m31_step_kernelILi0E", "aff1g_ip": "m31_step_kernelILi1E",
    "aff2g_ip": "m31_step_kernelILi2E", "muladd1": "m31_step_kernelILi1E",
    "muladd2": "m31_step_kernelILi2E", "mulss": "m31_step_kernelILi3E",
    "fused_bf1": "m31_pair_kernelILb0E", "fused_bf2": "m31_pair_kernelILb1E",
    "fused_cascade": "m31_warp_cascade"}
# the forms phase 2 builds: secp256k1's, M31's, phase 10's and the
# one-limb fold form of phases 11 and 12
FORMS = ("fold16", "m31", "cios16", "fold4", "cios3", "cios13", "fold1")
SASS = {}  # form → {wrapper: its kernel's SASS instructions} (phase 2)
FORM_SPEC = {"fold16": SPEC, "m31": M31, "cios16": GSPEC["cios16"],
             "fold4": GSPEC["fold4"], "cios3": GSPEC["cios3"],
             "cios13": GSPEC["cios13"],
             "fold1": GSPEC["fold1"]}  # a field of each form


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


def rand_limbs(shape, gen, spec=SPEC):
    """Canonical values as (..., L) int32 limbs: uniform 16-bit limbs
    with a top limb below p's (so every value is < p), or M31 values."""
    if fd.is_m31(spec):
        return torch.randint(0, spec.p, (*shape, 1), generator=gen,
                             device=DEV, dtype=torch.int32)
    x = torch.randint(0, 1 << 16, (*shape, spec.num_limbs), generator=gen,
                      device=DEV, dtype=torch.int32)
    top = spec.to_limbs(spec.p)[-1]
    x[..., -1] = torch.randint(0, top, shape, generator=gen, device=DEV,
                               dtype=torch.int32)
    return x


def general_edges(spec):
    """A general prime's edge values: 0, 1, 2, p − 1, p − 2, (p − 1)/2,
    R mod p and R² mod p (1 and R in Montgomery form), p − (R mod p), and
    the largest values below 2^(16L − 1), 2^(16L) and p: the sums of two
    products of values near p − 1 reach the CIOS reduction's bound, and
    at one limb the fold's longest loop."""
    p, R = spec.p, spec.r
    return sorted({0, 1, 2, p - 1, p - 2, (p - 1) // 2, R % p, R * R % p,
                   p - R % p, ((1 << (16 * spec.num_limbs - 1)) - 1) % p,
                   (R - 1) % p, p - 3})


def edge_rows(A, B, shift=0, spec=SPEC):
    """(A, L, B) limbs cycling through the edge values, and (A, L) rows
    that pair every edge coefficient with every edge value."""
    edge = (M31_EDGE if fd.is_m31(spec) else EDGE if spec in (SPEC, ED)
            else general_edges(spec))
    E = len(edge)
    x = fd.encode(spec, [[edge[(i + b + shift) % E] for b in range(B)]
                         for i in range(A)], DEV)
    c = fd.encode(spec, [edge[(i // E + shift) % E] for i in range(A)], DEV)
    return x.permute(0, 2, 1).contiguous(), c


def cuda_ms(fn, reps, settle_s=0.0):
    """Mean device milliseconds of ``fn`` over ``reps`` runs (CUDA events),
    after one warm-up run and, with ``settle_s``, more of them until that
    many seconds have passed."""
    fn()
    torch.cuda.synchronize()
    end = time.perf_counter() + settle_s
    while time.perf_counter() < end:
        fn()
        torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def profiled_ms(fn, reps, tries=3):
    """Mean device milliseconds per run of the port's kernels that ``fn``
    launches, read from a ``torch.profiler`` trace of ``reps`` runs after
    one warm-up: the kernels' own durations, without the gaps in which the
    card waits for the host's next launch (which CUDA events over
    back-to-back launches include). A trace that holds none of them (CUPTI
    now and then hands back no kernel record) is taken again, up to
    ``tries`` traces in all; None where none of them holds one."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(1, tries + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        us = [e.time_range.end - e.time_range.start for e in dev
              if any(k in e.name for k in KERNEL_BASES)]
        log(f"profiled {len(us)} kernel runs over {reps} calls")
        if us:
            return sum(us) / 1e3 / reps
        log(f"trace {attempt} of {tries} holds none of the port's kernels "
            f"({len(dev)} device records: {sorted({e.name for e in dev})[:4]})")
    return None


def fenced_ms(fn, reps, sleep_cycles=2_000_000):
    """Mean device milliseconds of one run of ``fn`` between two CUDA
    events, the card held busy by a spin (``torch.cuda._sleep``, about a
    millisecond) while the host enqueues the events and the run, so that
    the host's work before the launch falls outside them. The time where
    no profiler trace holds the kernels; it counts every device operation
    that ``fn`` enqueues and the events' own few microseconds."""
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(sleep_cycles)
        t0.record()
        fn()
        t1.record()
        torch.cuda.synchronize()
        total += t0.elapsed_time(t1)
    return total / reps


def reset_counts():
    for w in WRAPPERS.values():
        w.launches.clear()


def read_counts(spec=SPEC):
    """Each wrapper's launches of the form that takes ``spec``."""
    form = step.kernel_form(spec)
    return {k: w.launches[form] for k, w in WRAPPERS.items()}


# ------------------------------------------------------------ the bounds


def warp_cascade(form: str) -> bool:
    """The form's cascade is the warp design of warp_cascade.cuh: M31's,
    and a word form's of one or two words (at most 4 limbs)."""
    return form == "m31" or int(form[4:]) <= 4


def sass_names(form: str) -> dict:
    """Each wrapper's kernel's SASS function name in ``form``'s library."""
    if form == "m31":
        return M31_SASS_NAMES
    if warp_cascade(form):
        return {**SASS_NAMES, "fused_cascade": "word_warp_cascade"}
    return SASS_NAMES


def kernel_sass(lib: str, form: str) -> dict:
    """Each wrapper's kernel in ``form``'s library as SASS instructions
    (``cuobjdump -sass``)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    funcs = sass_count.functions(subprocess.run(
        [tool, "-sass", lib], capture_output=True, text=True,
        check=True).stdout)
    names = sass_names(form)
    found = {k: insts for k, pat in names.items()
             for name, insts in funcs.items() if pat in name}
    check(set(found) == set(names), f"{form}: SASS functions found: "
                                     f"{sorted(found)}")
    return found


def kernel_resources(lib: str, form: str) -> list:
    """Registers, shared bytes, stack and spills of each kernel of
    ``form``'s library, one line each, as ``cuobjdump -res-usage`` prints
    them."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    lines = subprocess.run([tool, "-res-usage", lib], capture_output=True,
                           text=True, check=True).stdout.splitlines()
    names = sass_names(form)
    out = []
    for i, line in enumerate(lines[:-1]):
        if line.strip().startswith("Function ") and "REG:" in lines[i + 1]:
            name = line.strip()[len("Function "):].rstrip(":")
            short = next((k for k in names.values() if k in name), name)
            out.append(f"[{form}] {short}: {lines[i + 1].strip()}")
    check(len(out) >= len(set(names.values())),
          f"cuobjdump -res-usage named {len(out)} kernels of {form}")
    return out


def words(spec) -> int:
    return (spec.num_limbs + 1) // 2


def fold_nonzero(spec=SPEC) -> int:
    """Nonzero 32-bit words of the fold multiplier F = 2^(16L) mod p as
    the word kernels' fold reads them (the CIOS and M31 forms have none)."""
    if fd.is_m31(spec) or fd.is_mont(spec):
        return 0
    return sum(1 for v in step._field(spec).fw if v)


def fold_rounds(spec=SPEC) -> int:
    """Rounds of the fold loop (``csrc/word_arith.cuh::reduce``) that most
    of this run's values take: x + c·y over seeded uniform canonical
    values, folded as the loop folds them while the part above R =
    2^(16L) is not 0: two for the primes of 16 limbs (after one round the
    high part of a 16-limb product is below 2^35, after two it is 0 unless
    the low half lies within 2^68 of 2^256), one for M61 (two for about
    one value in 50), three for 64513 (2 to 4 for one value in five; up
    to five at most), 0 for 97 (x + c·y < 2^16), and 0 for the forms
    without a fold loop (CIOS, M31)."""
    if fd.is_m31(spec) or fd.is_mont(spec):
        return 0
    p, R = spec.p, 1 << (16 * spec.num_limbs)
    F, rng = R % p, random.Random(5)
    rounds = collections.Counter()
    for _ in range(1000):
        v, r = rng.randrange(p) + rng.randrange(p) * rng.randrange(p), 0
        while v >= R:
            v, r = v % R + (v // R) * F, r + 1
        rounds[r] += 1
    return rounds.most_common(1)[0][0]


def thread_work(kind, A, B, kinds=(), spec=SPEC):
    """(threads, instructions one thread issues per pipe) of one call
    on a window of A rows and B lanes, along the path this data takes
    (``tools/sass_count.py``: :func:`fold_rounds` rounds of the fold, one
    block per nonzero word of F in each)."""
    m31, form = fd.is_m31(spec), step.kernel_form(spec)
    per = sass_count.thread_counts(SASS[form][kind], fold_rounds(spec),
                                   fold_nonzero(spec), kinds,
                                   max(words(spec), 1))
    # one thread an element (an M31 pair level: a pair; the warp design's
    # cascade: 4 rows x 8 or 4 lanes): a cascade's blocks are always full, and
    # the idle threads of a ragged block issue next to nothing
    if kind == "fused_cascade":
        lanes, threads = ((WARP_CASCADE_LANES[max(words(spec), 1)],
                           WARP_CASCADE_THREADS) if warp_cascade(form)
                          else (CASCADE_LANES, CASCADE_THREADS))
        threads *= (A // unrolled.TW) * -(-B // lanes)
    elif m31 and kind in ("fused_bf1", "fused_bf2"):
        threads = A * B // 2
    else:
        threads = A * B
    return threads, per


def word_products(kind, kinds=(), spec=SPEC) -> int:
    """32x32->64-bit word products one element needs, whatever kernel
    computes it. For NW words an element: NW² per product; per reduction,
    in the fold form the products of F's nonzero words by the high part's
    NW words, then by the words left after one round (at most 2F: two
    words for secp256k1), in the CIOS form NW·(NW + 1) (NW rounds of m and
    m·p). One per M31 product, whose reduction is shifts and adds. A
    cascade sums its levels."""
    if fd.is_m31(spec):
        return (sum(1 + k for k in kinds) if kind == "fused_cascade"
                else 1 + (kind in ("aff2g_ip", "muladd2", "fused_bf2")))
    nw = words(spec)
    if fd.is_mont(spec):
        red = nw * (nw + 1)
    else:
        F = spec.r % spec.p
        red = fold_nonzero(spec) * (nw + -(-(2 * F).bit_length() // 32))
    if kind == "fused_cascade":
        return sum(nw * nw * (1 + k) + red for k in kinds)
    two = kind in ("aff2g_ip", "muladd2", "fused_bf2")
    return nw * nw * (1 + two) + red


def bound(kind, A, B, kinds=(), spec=SPEC):
    """The least time of one call: the larger of the bytes the function
    must move (each input read once and each output written once: 4L B
    per element per window, 4L B per row per coefficient row; L limbs, or
    1 for M31) over the memory rate, and its word products
    (:func:`word_products`) over the IMAD.WIDE rate. The same work
    whatever kernel computes it. Beside it, this design's issue bound: the
    instructions of its SASS along one thread's path, each pipe's count
    over its 64 lanes and all of them over the 128 issue lanes, per SM and
    clock. Returns {bound_ms, bound_by, bytes_bound_ms, ops_bound_ms,
    design_issue_bound_ms, design_issue_by}."""
    nl = spec.num_limbs
    E, el, row = A * B, nl * 4, A * nl * 4
    two = kind in ("aff2g_ip", "muladd2", "fused_bf2")
    if kind == "fused_cascade":
        nbytes = 2 * E * el + (len(kinds) + sum(kinds)) * row
    elif kind in ("fused_bf1", "fused_bf2"):
        nbytes = 2 * E * el + (1 + two) * row
    elif kind == "mulss":  # two factors in, the product out; no row
        nbytes = 3 * E * el
    else:
        nbytes = 3 * E * el + (1 + two) * row
    b_ms = nbytes / HBM_BYTES_PER_S * 1e3
    o_ms = (word_products(kind, kinds, spec) * E
            / (SM_CLOCKS * WORD_PRODUCTS_PER_SM) * 1e3)
    threads, per = thread_work(kind, A, B, kinds, spec)
    pipe = SM_CLOCKS * PIPE_LANES_PER_SM
    issue = {"fma pipe": per["fma"] * threads / pipe,
             "alu pipe": per["alu"] * threads / pipe,
             "issue": per["all"] * threads / (SM_CLOCKS * ISSUE_LANES_PER_SM)}
    issue_by = max(issue, key=issue.get)
    return {"bound_ms": max(b_ms, o_ms),
            "bound_by": "bytes" if b_ms >= o_ms else "operations",
            "bytes_bound_ms": b_ms, "ops_bound_ms": o_ms,
            "design_issue_bound_ms": issue[issue_by] * 1e3,
            "design_issue_by": issue_by}


def clock_now() -> str:
    """The card's SM clock and power draw as ``nvidia-smi`` reads them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


# ------------------------------------------- the kernels and their plain


def step_args(kind, A, B, gen, edge, W, start, spec=SPEC):
    """Operands of a step kernel: coefficient rows, windows x1, x2 and a
    state of W rows with its window at ``start``. x1 is None where the
    step reads the state's own window, as the main paths' aff1s and
    muladd1 (OP_AFF1S) steps do."""
    n_coef = {"aff2g_ip": 2, "muladd2": 2, "mulss": 0}.get(kind, 1)
    if edge:
        x1, c = edge_rows(A, B, 0, spec)
        x2, c2 = edge_rows(A, B, 3, spec)
        coeffs = [c, c2][:n_coef]
    else:
        coeffs = [rand_limbs((A,), gen, spec) for _ in range(n_coef)]
        x1, x2 = (rand_limbs((A, B), gen, spec).permute(0, 2, 1).contiguous()
                  for _ in range(2))
    state = rand_limbs((W, B), gen, spec).permute(0, 2, 1).contiguous()
    if kind in ("aff1s_ip", "muladd1"):
        if edge:  # the edge values in the window it reads
            state[start:start + A] = x1
        x1 = None
    return coeffs, state, x1, x2


def run_step(kind, coeffs, state, x1, x2, start, plain, spec=SPEC):
    """The kernel, or its plain version, on these operands: the state
    with its window [start, start + A) written."""
    A = x2.shape[0]
    if x1 is None:
        x1 = state[start:start + A]
    if plain:
        if not coeffs:
            new = step._mulss_cols(spec, x1, x2)
        elif len(coeffs) == 2:
            new = step._muladd2_cols(spec, coeffs[0].unsqueeze(-1), x1,
                                     coeffs[1].unsqueeze(-1), x2)
        else:
            new = step._muladd1_cols(spec, coeffs[0].unsqueeze(-1), x1, x2)
        state[start:start + A] = new
        return state
    w = WRAPPERS[kind]
    if kind.startswith("mul"):  # muladd1, muladd2, mulss
        w(spec, *coeffs, x1, x2, state, start)
    elif kind == "aff1s_ip":
        w(spec, coeffs[0], state, x2, start)
    else:
        w(spec, *coeffs, state, x1, x2, start)
    return state


def int64_step(kind, coeffs, state, x1, x2, start):
    """The M31 step as one int64 PyTorch expression with ``%`` (the
    yardstick beside the kernel: what PyTorch computes without it)."""
    A = x2.shape[0]
    win = state[start:start + A]
    x1 = win if x1 is None else x1
    y = x2.long()
    if not coeffs:
        new = x1.long() * y
    elif len(coeffs) == 2:
        new = coeffs[0].long()[..., None] * x1.long() \
            + coeffs[1].long()[..., None] * y
    else:
        new = x1.long() + coeffs[0].long()[..., None] * y
    win.copy_(new % M31.p)
    return state


def fused_args(kind, W, A, B, gen, edge, levels, start, spec=SPEC):
    """Operands of a fused kernel: a random state of W rows (its window
    [start, start + A) cycling through the edge values where ``edge``),
    and its coefficient rows (edge or random)."""
    state = rand_limbs((W, B), gen, spec).permute(0, 2, 1).contiguous()
    n = (2 if kind == "fused_bf2" else 1) if levels is None else (
        len(levels[0]) + max(sum(levels[1]), 1))
    if edge:
        state[start:start + A] = edge_rows(A, B, 0, spec)[0]
        rows = [edge_rows(A, 1, 3 + i, spec)[1] for i in range(n)]
    else:
        rows = [rand_limbs((A,), gen, spec) for _ in range(n)]
    if levels is None:
        return state, tuple(rows)
    k = len(levels[0])
    return state, (torch.stack(rows[:k]), torch.stack(rows[k:]))


def run_fused(kind, state, rows, start, half, levels, plain, spec=SPEC):
    """The kernel, or its plain version, on ``state`` in place."""
    if kind == "fused_cascade":
        if plain:
            unrolled._cascade_plain(spec, state, *rows, start, *levels)
        else:
            unrolled.fused_cascade(spec, state, *rows, start, *levels)
    elif plain:
        awin = rows[0] if kind == "fused_bf2" else None
        unrolled._pair_plain(spec, state, awin, rows[-1], start, half)
    else:
        WRAPPERS[kind](spec, state, *rows, start, half)
    return state


def int64_fused(kind, state, rows, start, half, levels):
    """An M31 fused level (or cascade) as int64 PyTorch expressions with
    ``%``, level by level (the yardstick beside the kernel)."""
    if kind == "fused_cascade":
        (cw, aw), (halves, kinds) = rows, levels
    else:
        cw, aw = rows[-1:], rows[:1]
        halves, kinds = (half,), (int(kind == "fused_bf2"),)
    A = cw.shape[1] if kind == "fused_cascade" else cw[0].shape[0]
    win = state[start:start + A]
    x, ai = win.long(), 0
    for li, (h, k) in enumerate(zip(halves, kinds)):
        part = x.index_select(0, unrolled._partner(start, A, h, x.device))
        c = cw[li].long()[..., None]
        if k:
            x = (aw[ai].long()[..., None] * x + c * part) % M31.p
            ai += 1
        else:
            x = (x + c * part) % M31.p
    win.copy_(x)
    return state


def held_to_plain(kernel, plain, state, start, A):
    """max |kernel - plain| over the window, each run on a copy of the
    state; rows outside the window must come back untouched."""
    want, got = plain(state.clone()), kernel(state.clone())
    torch.cuda.synchronize()
    check(torch.equal(got[:start], state[:start])
          and torch.equal(got[start + A:], state[start + A:]),
          "rows outside the window changed")
    got, want = got[start:start + A], want[start:start + A]
    err = int((got.long() - want.long()).abs_().max())
    del want, got
    return err


# the kernels phase 4 also holds on inputs that stress the word reduction
WORD_EDGE_KERNELS = ("aff1s_ip", "fused_bf1", "fused_bf2", "fused_cascade",
                     "mulss")


def kernels_against_plain(gen, sched, cascade_run, spec=SPEC, batch=BATCH,
                          label="", small_only=False, profiled=False):
    """Phase 4, for the form that takes ``spec`` at its main shapes
    (``sched``'s window, ``batch`` lanes; none with ``small_only``).
    Returns {kind: stats}; max_abs_err is the largest over every
    comparison of that kernel; an M31 form is also timed as the int64
    PyTorch expression with ``%`` (``library_ms``). ``label`` names the
    form in the log. With ``profiled`` (main shapes whose launch is
    shorter than the host's work between launches) ``ms`` is the kernel's
    device time from a profiler trace (:func:`profiled_ms`; where no trace
    holds the kernel, from events around one launch, :func:`fenced_ms`,
    named in ``ms_source``), and ``events_ms`` the CUDA-event time of
    back-to-back launches beside it."""
    W, A, bsx = sched.W, sched.A, sched.bs_max
    m31, nl = fd.is_m31(spec), spec.num_limbs
    res = {}
    for kind in KERNELS:
        name = kind + (f"[{label}]" if label else "")
        fused = kind.startswith("fused")
        err = 0
        # small shapes: edge and random values at B = 1 and 256
        small = ([(128, None), (256, None)] if kind != "fused_cascade"
                 else [(None, ((64, 1, 64), (0, 0, 1)))]) if fused else [
            (None, None)]
        for half, levels in small:
            for B, edge in ((1, True), (256, True), (1, False),
                            (256, False)):
                if fused:
                    a = 512 if half is None else 4 * half
                    s0 = 384 if half is None else 4 * half
                    st, rows = fused_args(kind, s0 + a + 128, a, B, gen,
                                          edge, levels, s0, spec)
                    e = held_to_plain(
                        lambda s: run_fused(kind, s, rows, s0, half,
                                            levels, False, spec),
                        lambda s: run_fused(kind, s, rows, s0, half,
                                            levels, True, spec), st, s0, a)
                else:
                    a, s0 = 512, 384
                    cf, st, x1, x2 = step_args(kind, a, B, gen, edge, 1024,
                                               s0, spec)
                    e = held_to_plain(
                        lambda s: run_step(kind, cf, s, x1, x2, s0, False,
                                           spec),
                        lambda s: run_step(kind, cf, s, x1, x2, s0, True,
                                           spec), st, s0, a)
                    if edge and B == 1:  # and the plain version vs ints
                        plain_vs_ints(kind, cf, st, x1, x2, s0, spec)
                err = max(err, e)
                log(f"{name} B={B} {'edge' if edge else 'random'}"
                    f"{'' if half is None else f' half={half}'}: "
                    f"max |kernel - plain| = {e}")
        if kind == "mulss":  # one buffer as both factors: a square
            for B, edge in ((1, True), (256, False)):
                _, st, _, x2 = step_args(kind, 512, B, gen, edge, 1024, 384,
                                         spec)
                e = held_to_plain(
                    lambda s: run_step(kind, [], s, x2, x2, 384, False,
                                       spec),
                    lambda s: run_step(kind, [], s, x2, x2, 384, True, spec),
                    st, 384, 512)
                err = max(err, e)
                log(f"{name} B={B} {'edge' if edge else 'random'}, x1 "
                    f"is x2: max |kernel - plain| = {e}")
        # the main paths' shapes
        if small_only:
            mains = []
        elif kind == "fused_cascade":
            start, halves, kinds = cascade_run
            mains = [(None, (tuple(halves), tuple(kinds)), start)]
        elif fused:  # one tile apart, and (A/4 = 16384) a quarter window
            mains = [(h, None, A) for h in sorted(
                {unrolled.TW, max(unrolled.TW, A // 4)})]
        else:
            mains = [(None, None, W - A - 128)]
        for half, levels, start in mains:
            if fused:
                st, rows = fused_args(kind, W, A, batch, gen, False,
                                      levels, start, spec)
                kern = (lambda s: run_fused(kind, s, rows, start, half,
                                            levels, False, spec))
                plain = (lambda s: run_fused(kind, s, rows, start, half,
                                             levels, True, spec))
                lib = (lambda s: int64_fused(kind, s, rows, start, half,
                                             levels))
            else:
                cf, st, x1, x2 = step_args(kind, A, batch, gen, False, W,
                                           start, spec)
                kern = (lambda s: run_step(kind, cf, s, x1, x2, start,
                                           False, spec))
                plain = (lambda s: run_step(kind, cf, s, x1, x2, start,
                                            True, spec))
                lib = lambda s: int64_step(kind, cf, s, x1, x2, start)
            e = held_to_plain(kern, plain, st, start, A)
            err = max(err, e)
            what = (f"(W={W}, A={A}, L={nl}, B={batch}"
                    + ("" if half is None else f", half={half}")
                    + ("" if levels is None else
                       f", {len(levels[0])} levels {levels}") + ")")
            log(f"{name} at {what}: max |kernel - plain| = {e}")
            if m31:  # and the int64 expression, the yardstick
                e = held_to_plain(kern, lib, st, start, A)
                check(e == 0, f"{name}: the int64 expression differs")
            torch.cuda.empty_cache()
            if kind not in res:  # timed at its first main shape
                ms = cuda_ms(lambda: kern(st), 20, SETTLE_S)
                clk = clock_now()
                events_ms = ms
                if profiled:
                    ms, source = profiled_ms(lambda: kern(st), 20), \
                        "torch.profiler"
                    if ms is None:  # no trace held it: events, fenced
                        ms, source = fenced_ms(lambda: kern(st), 20), \
                            "CUDA events around one launch behind a spin"
                    check(ms > 0, f"{name}: no device time measured")
                    log(f"{name} at {what}: device time {ms:.4f} ms a "
                        f"launch ({source}), CUDA events over "
                        f"back-to-back launches {events_ms:.4f} ms")
                plain_ms = cuda_ms(lambda: plain(st), 3)
                lib_ms = cuda_ms(lambda: lib(st), 3) if m31 else None
                b = bound(kind, A, batch, levels[1] if levels else (), spec)
                log(f"{name} at {what}: kernel {ms:.3f} ms (then {clk}), "
                    f"plain {plain_ms:.3f} ms, bound {b['bound_ms']:.3f} ms "
                    f"by {b['bound_by']} (bytes {b['bytes_bound_ms']:.3f} "
                    f"ms, word products {b['ops_bound_ms']:.3f} ms); the "
                    f"kernel takes {ms / b['bound_ms']:.3f}x the bound; "
                    f"this design's issue bound "
                    f"{b['design_issue_bound_ms']:.3f} ms by "
                    f"{b['design_issue_by']} "
                    f"({ms / b['design_issue_bound_ms']:.3f}x)"
                    + (f"; int64 expression {lib_ms:.3f} ms" if m31 else ""))
                res[kind] = {"ms": ms, "plain_ms": plain_ms, **b,
                             "library_ms": lib_ms, "shape": what}
                if profiled:
                    res[kind].update(events_ms=events_ms, ms_source=source)
            elif fused:
                ms = cuda_ms(lambda: kern(st), 20, SETTLE_S)
                log(f"{name} at {what}: kernel {ms:.3f} ms (then "
                    f"{clock_now()})")
            del st
            torch.cuda.empty_cache()
        if kind == "aff1s_ip":  # the D-engine's one-lane row products
            a, b = rand_limbs((bsx,), gen, spec), rand_limbs((bsx,), gen, spec)
            got = step.mul_rows(spec, a, b)
            want = step._muladd1_cols(
                spec, a.unsqueeze(-1), torch.zeros_like(a).unsqueeze(-1),
                b.unsqueeze(-1)).squeeze(-1)
            e = int((got.long() - want).abs_().max())
            err = max(err, e)
            log(f"{name} one-lane row products (mul_rows) at ({bsx}, "
                f"{nl}, 1): max |kernel - plain| = {e}")
        if kind in WORD_EDGE_KERNELS and spec is SPEC:
            err = max(err, word_edges(kind, gen))
        check(err == 0, f"{name} disagrees with its plain version")
        res.setdefault(kind, {})["max_abs_err"] = err
    return res


def word_edge_triples(spec, rng):
    """(x, c, y) for x + c·y that stress the word kernels' reduction:
    values near p and non-canonical ones up to 2^256 − 1, sums that lie
    in [p, 2^256) before the final subtraction, products whose low half
    lies within 2^70 of 2^256, and sums whose fold runs a third round."""
    p, M = spec.p, (1 << 256) - 1
    F = (1 << 256) % p
    near = [0, 1, p - 2, p - 1, p, p + 1, (p - 1) // 2, M - 1, M]
    out = [(x, c, y) for x in (0, p - 1, M) for c in near for y in near]
    while len(out) < 3 * 81 + 48:
        target = M - rng.randrange(M - p + 1)  # in [p, 2^256)
        c = rng.randrange(2, 1 << 16)
        y = target // c - rng.randrange(1 << 8)
        out.append((target - c * y, c, y))
        c = rng.randrange(1, p) | 1
        y = (M + 1 - rng.randrange(1, 1 << 70)) * pow(c, -1, M + 1) % (M + 1)
        if y < p:
            out.append((rng.randrange(p), c, y))
        c, y = rng.randrange(p), rng.randrange(p)
        v = c * y
        x = (M - rng.randrange(F) - (v & M) - (v >> 256) * F) % (M + 1)
        if x < p:
            out.append((x, c, y))
    return out


def int_limbs(values) -> torch.Tensor:
    """Python ints below 2^256, not reduced, as (..., L) int32 limbs."""
    flat = [[(v >> 16 * j) & 0xFFFF for j in range(L)] for v in values]
    return torch.tensor(flat, dtype=torch.int32, device=DEV)


def word_edges(kind, gen) -> int:
    """The kernels on 32-bit words (aff1s, mulss, the pair levels, the
    cascade) against their plain versions on :func:`word_edge_triples`,
    for secp256k1 and 2^255 − 19, at B = 1 and 256; aff1s, mulss and bf1
    also against Python ints. Returns the largest |kernel − plain|."""
    A, s0, W, err = 512, 384, 1152, 0
    for spec in (SPEC, ED):
        tri = word_edge_triples(spec, random.Random(spec.p % 997))
        for B in (1, 256):
            state = rand_limbs((W, B), gen, spec).permute(0, 2, 1).contiguous()
            if kind == "aff1s_ip":
                rows = [tri[q % len(tri)] for q in range(A)]
                xs, cs, ys = (int_limbs([t[i] for t in rows])
                              for i in range(3))
                state[s0:s0 + A] = xs.unsqueeze(-1).expand(A, L, B)
                x2 = ys.unsqueeze(-1).expand(A, L, B).contiguous()
                e = held_to_plain(
                    lambda st: (step.aff1s_ip(spec, cs, st, x2, s0), st)[1],
                    lambda st: (st[s0:s0 + A].copy_(step._muladd1_cols(
                        spec, cs.unsqueeze(-1), st[s0:s0 + A], x2)), st)[1],
                    state, s0, A)
                got = state.clone()
                step.aff1s_ip(spec, cs, got, x2, s0)
                dec = fd.decode(spec, got[s0:s0 + A, :, 0])
                check(all(int(dec[q]) == (x + c * y) % spec.p
                          for q, (x, c, y) in enumerate(rows)),
                      f"aff1s on the word edge values vs ints ({spec.name})")
                err = max(err, e)
                log(f"aff1s_ip word edges, {spec.name}, B={B}: "
                    f"max |kernel - plain| = {e}")
                continue
            if kind in ("fused_bf1", "fused_bf2"):
                err = max(err, pair_word_edges(kind, spec, tri, state, A, B,
                                               gen))
                continue
            if kind == "mulss":  # c·y of each triple, and y·y
                rows = [tri[q % len(tri)] for q in range(A)]
                cs, ys = (int_limbs([t[i] for t in rows])
                          .unsqueeze(-1).expand(A, L, B).contiguous()
                          for i in (1, 2))
                for x1, what in ((cs, "x1·x2"), (ys, "x2·x2")):
                    e = held_to_plain(
                        lambda st: (step.mulss(spec, x1, ys, st, s0), st)[1],
                        lambda st: (st[s0:s0 + A].copy_(step._mulss_cols(
                            spec, x1, ys)), st)[1], state, s0, A)
                    got = state.clone()
                    step.mulss(spec, x1, ys, got, s0)
                    dec = fd.decode(spec, got[s0:s0 + A, :, B - 1])
                    check(all(int(dec[q]) == (y if x1 is ys else c) * y
                              % spec.p for q, (_, c, y) in enumerate(rows)),
                          f"mulss on the word edge values vs ints "
                          f"({spec.name})")
                    err = max(err, e)
                    log(f"mulss word edges ({what}), {spec.name}, B={B}: "
                        f"max |kernel - plain| = {e}")
                continue
            for halves, kinds in (((64, 1, 64), (0, 0, 1)),
                                  ((32, 2, 16), (1, 0, 1))):
                h = halves[0]
                cw = rand_limbs((len(halves), A), gen, spec)
                aw = rand_limbs((sum(kinds), A), gen, spec)
                win = state[s0:s0 + A]
                firsts = [r for r in range(A) if not r & h]
                for i, r in enumerate(firsts):  # level 1 computes x + c·y
                    x, c, y = tri[i % len(tri)]
                    win[r] = int_limbs([x]).T
                    win[r ^ h] = int_limbs([y]).T
                    cw[0, r] = int_limbs([c])[0]
                    if kinds[0]:  # 1·x + c·y, and M·y + M·x at r ^ h
                        aw[0, r] = int_limbs([1])[0]
                        aw[0, r ^ h] = cw[0, r ^ h] = int_limbs(
                            [(1 << 256) - 1])[0]
                e = held_to_plain(
                    lambda st: (unrolled.fused_cascade(
                        spec, st, cw, aw, s0, halves, kinds), st)[1],
                    lambda st: (unrolled._cascade_plain(
                        spec, st, cw, aw, s0, halves, kinds), st)[1],
                    state, s0, A)
                err = max(err, e)
                log(f"fused_cascade word edges, {spec.name}, B={B}, "
                    f"levels {halves} kinds {kinds}: max |kernel - plain| "
                    f"= {e}")
    return err


def pair_word_edges(kind, spec, tri, state, A, B, gen) -> int:
    """One pair level (half 128, window [512, 512 + A)) whose rows t with
    t & half == 0 compute x + c·y (bf2: 1·x + c·y, and (2^256 − 1)·(y + x)
    at t ^ half) on the word edge triples, against the plain version; bf1
    also against Python ints. Returns max |kernel − plain|."""
    h, s0, M = 128, 512, (1 << 256) - 1
    two = kind == "fused_bf2"
    cw, aw = rand_limbs((A,), gen, spec), rand_limbs((A,), gen, spec)
    firsts = torch.tensor([r for r in range(A) if not r & h], device=DEV)
    rows = [tri[i % len(tri)] for i in range(len(firsts))]
    xs, cs, ys = (int_limbs([t[i] for t in rows]) for i in range(3))
    win = state[s0:s0 + A]
    win[firsts] = xs.unsqueeze(-1).expand(-1, L, B)
    win[firsts ^ h] = ys.unsqueeze(-1).expand(-1, L, B)
    cw[firsts] = cs
    if two:
        aw[firsts] = int_limbs([1])
        aw[firsts ^ h] = cw[firsts ^ h] = int_limbs([M])
    coeffs = (aw, cw) if two else (cw,)
    e = held_to_plain(
        lambda st: (WRAPPERS[kind](spec, st, *coeffs, s0, h), st)[1],
        lambda st: (unrolled._pair_plain(spec, st, aw if two else None, cw,
                                         s0, h), st)[1],
        state, s0, A)
    if not two:
        got = state.clone()
        unrolled.fused_bf1(spec, got, cw, s0, h)
        dec = fd.decode(spec, got[s0:s0 + A, :, 0][firsts])
        check(all(int(dec[i]) == (x + c * y) % spec.p
                  for i, (x, c, y) in enumerate(rows)),
              f"bf1 on the word edge values vs ints ({spec.name})")
    log(f"{kind} word edges, {spec.name}, B={B}: max |kernel - plain| = {e}")
    return e


def plain_vs_ints(kind, coeffs, state, x1, x2, start, spec=SPEC):
    """The plain version of a step against python ints on 64 rows (for
    Montgomery residents each product is a Montgomery product, ·R⁻¹)."""
    p = spec.p
    r = pow(spec.r, -1, p) if fd.is_mont(spec) else 1
    want = run_step(kind, coeffs, state.clone(), x1, x2, start, True, spec)
    want = want[start:]
    dec = fd.decode(spec, want[:64, :, 0])
    if not coeffs:  # the state x state product
        v1, v2 = (fd.decode(spec, x[:64, :, 0]) for x in (x1, x2))
        check(all(dec[q] == v1[q] * v2[q] * r % p for q in range(64)),
              f"{kind} plain version vs ints")
        return
    cb = fd.decode(spec, coeffs[-1][:64])
    ca = fd.decode(spec, coeffs[0][:64])
    xv = fd.decode(spec, x2[:64, :, 0])
    sv = fd.decode(spec, (x1 if x1 is not None else state[start:])
                   [:64, :, 0])
    for q in range(64):
        two = len(coeffs) == 2
        want_q = ((cb[q] * xv[q] + ca[q] * sv[q]) * r if two
                  else cb[q] * xv[q] * r + sv[q])
        check(dec[q] == want_q % p, f"{kind} plain version vs ints")


# ---------------------------------------------------------- the analysis


def analysis_counts(sched, meta):
    """Per transform, the launches the fusion analysis predicts for each
    unrolled kernel (with the OP_MUL steps as mulss, and the OP_CMPSEL
    steps, which launch no kernel of the port, as cmpsel), and the runs of
    in-tile levels (start, halves, kinds) as the executor flushes them
    before splitting."""
    ops = sched.xs[0]
    starts = sched.xs[1]
    tw = unrolled.TW
    c = collections.Counter()
    runs, cur = [], None
    for t, h in enumerate(meta.fusable):
        if int(ops[t]) in (emit.OP_MUL, emit.OP_CMPSEL):
            cur = None
            c["mulss" if int(ops[t]) == emit.OP_MUL else "cmpsel"] += 1
            continue
        two = int(ops[t]) in (emit.OP_AFFINE, emit.OP_AFFINE_C)
        if 0 < h < tw:
            if cur is not None and cur[0] == int(starts[t]):
                cur[1].append(h)
                cur[2].append(int(two))
                continue
            cur = [int(starts[t]), [h], [int(two)]]
            runs.append(cur)
            continue
        cur = None
        if h:
            c["fused_bf2" if two else "fused_bf1"] += 1
        else:
            c["muladd2" if two else "muladd1"] += 1
    c["fused_cascade"] = sum(-(-len(r[1]) // unrolled.MAX_LEVELS)
                             for r in runs)
    c["levels"] = sum(len(r[1]) for r in runs)
    return c, runs


# ------------------------------------------------------------ main path


def in_range(out, spec=SPEC) -> bool:
    """Every limb below 2^16, or every M31 value below p."""
    top = spec.p if fd.is_m31(spec) else 1 << 16
    return bool(((out >= 0) & (out < top)).all())


def gate(tree, coeffs, nt_out, nt, label):
    """ENTER of the batch, then an EXIT of poly 0, each with the counts
    set to 0 just before and read just after. Returns (ENTER output,
    ENTER counts, EXIT counts)."""
    spec, (batch, n) = tree.spec, coeffs.shape[:2]
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    out = tree.enter(coeffs)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    enter_counts = read_counts(spec)
    check(out.shape == coeffs.shape and out.dtype == torch.int32,
          f"{label} ENTER output shape")
    check(in_range(out, spec), f"{label} ENTER output limbs out of range")
    for bi in (0, batch // 2, batch - 1):
        got = [int(v) for v in fd.decode(spec, out[bi])]
        if bi not in nt_out:
            nt_out[bi] = nt.enter([int(v) for v in
                                   fd.decode(spec, coeffs[bi])])
        check(got == nt_out[bi],
              f"{label} ENTER does not match the native engine (poly {bi})")
    torch.cuda.synchronize()
    reset_counts()
    back = tree.exit(out[:1].contiguous())
    torch.cuda.synchronize()
    exit_counts = read_counts(spec)
    check(torch.equal(back, coeffs[:1]),
          f"{label} EXIT does not round-trip ENTER (poly 0)")
    log(f"{label}: first ENTER (B={batch}, n={n}) {first_s:.3f} s; gate "
        f"passed: ENTER == native on polys 0, {batch // 2}, {batch - 1}; "
        f"EXIT(ENTER(poly 0)) == poly 0")
    log(f"{label} launches per ENTER: {enter_counts}")
    log(f"{label} launches per EXIT: {exit_counts}")
    return out, enter_counts, exit_counts


def timed_reps(tree, gen, label, batch=BATCH):
    """Best of REPS warm ENTERs on fresh inputs, and the peak device
    memory over them."""
    times = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(DEV)
    for _ in range(REPS):
        fresh = rand_limbs((batch, tree.n), gen, tree.spec)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tree.enter(fresh)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        del fresh
    best = min(times)
    peak = torch.cuda.max_memory_allocated(DEV)
    log(f"{label} warm ENTER reps (s): {[round(t, 4) for t in times]}")
    log(f"{label} ENTER throughput: {batch / best:.3f} polys/s "
        f"({best / batch * 1e3:.4f} ms/poly); peak device memory "
        f"{peak / 1e9:.3f} GB")
    return batch / best, peak


# ------------------------------------------------- the other algorithms


def scan_counts(sched):
    """The launches the schedule's opcodes ask of the scan executor: one
    per step by its kind (aff1s also runs the D-engine's row products, so
    its count is a floor)."""
    ops = collections.Counter(int(op) for op in sched.xs[0])
    return {"aff1g_ip": ops[emit.OP_AFF1] + ops[emit.OP_AFF1_C],
            "aff2g_ip": ops[emit.OP_AFFINE] + ops[emit.OP_AFFINE_C],
            "mulss": ops[emit.OP_MUL],
            "aff1s_ip": ops[emit.OP_AFF1S] + ops[emit.OP_AFF1S_C]}


def native_redc(nt, evals, a, moiety):
    """The engine's REDC by Z0 (moiety 0) or Z1 (1) with modulus table a."""
    out = ctypes.create_string_buffer(32 * len(evals))
    native.lib().ecn_redc(nt._h, native._pack(evals), native._pack(a),
                          len(evals), moiety, out)
    return native._unpack(out.raw)


def degree_batch(tree, gen, rng, batch=BATCH):
    """Evaluations of ``batch`` polynomials of known, different degrees
    (the edge degrees first, the last lane the largest), and the
    degrees."""
    n, spec = tree.n, tree.spec
    special = [d for d in (0, 1, 2, 255, 256, n // 2 - 1, n // 2, n - 2)
               if d < n]
    degs = [special[b] if b < len(special) else rng.randrange(n)
            for b in range(batch)]
    degs[-1] = n - 1
    d = torch.tensor(degs, device=DEV)
    coeffs = rand_limbs((batch, n), gen, spec)
    idx = torch.arange(n, device=DEV)
    coeffs *= (idx[None, :] <= d[:, None]).unsqueeze(-1)
    lanes = torch.arange(batch, device=DEV)
    lead = coeffs[lanes, d, 0]  # made nonzero: a leading term
    coeffs[lanes, d, 0] = lead.clamp(min=1) if fd.is_m31(spec) else lead | 1
    return tree.enter(coeffs), degs


def other_algorithms(tree, nt, gen, batch=BATCH, only=None):
    """Phase 8 (and 9 and 10 for the other fields): the six other
    algorithms (``only``: the names of those to run). Returns (the
    launches of each kernel summed over its gated calls, rows for the
    log's table)."""
    S0, S1 = emit.S0, emit.S1
    rng = random.Random(8)
    N, spec = tree.n, tree.spec
    h = N // 2

    def ints(t):
        return [int(v) for v in fd.decode(spec, t)]

    a_can, c_can = nt.table(N, "xnn_s"), nt.table(N, "z0z0_rem_xnn_s")
    ga, gc = rand_limbs((N,), gen, spec), rand_limbs((N,), gen, spec)
    # no zero entry to invert
    ga = ga.clamp(min=1) if fd.is_m31(spec) else ga | 1
    gai, gci = ints(ga), ints(gc)
    ev, degs = degree_batch(tree, gen, rng, batch)
    # name, method, its arguments after the batch, the schedule's key, the
    # batch (an int: a fresh random one of that many points), the engine
    algs = [
        ("EXTEND onto S0", "extend", (S0,), ("extend", h, S0), h,
         lambda x: nt.extend(x, S0)),
        ("EXTEND onto S1", "extend", (S1,), ("extend", h, S1), h,
         lambda x: nt.extend(x, S1)),
        ("MEXTEND onto S0", "mextend", (S0,), ("mextend", h, S0), h,
         lambda x: nt.mextend(x, S0)),
        ("MEXTEND onto S1", "mextend", (S1,), ("mextend", h, S1), h,
         lambda x: nt.mextend(x, S1)),
        ("DEGREE", "degree", (), ("degree", N), ev, nt.degree),
        ("REDC by Z0, a = X^(n/2)", "redc_z0", (), ("redc", N), N,
         lambda x: nt.redc_z0(x, a_can)),
        ("REDC by Z1, a = X^(n/2)", "redc_z1", (), ("redc1", N), N,
         lambda x: native_redc(nt, x, a_can, 1)),
        ("MOD, a = X^(n/2)", "modular_reduce", (), ("mod", N), N,
         lambda x: nt.modular_reduce(x, a_can, c_can)),
        ("VANISH", "vanish", (), ("vanish", h), h, nt.vanish),
        ("REDC by Z0, general modulus", "redc_z0", (ga,),
         ("gredc", N, S0), N, lambda x: nt.redc_z0(x, gai)),
        ("MOD, general modulus", "modular_reduce", (ga, gc), ("gmod", N),
         N, lambda x: nt.modular_reduce(x, gai, gci)),
    ]
    totals, rows = collections.Counter(), []
    for name, method, args, key, size, engine in algs:
        if only is not None and name not in only:
            continue
        x = rand_limbs((batch, size), gen, spec) if isinstance(size, int) \
            else size
        m = x.shape[1]
        want = {b: engine(ints(x[b])) for b in (0, batch - 1)}
        outs = {}
        for ex in ("scan", "unrolled"):
            os.environ.pop("ECFFT_EXECUTOR", None)
            if ex == "unrolled":
                os.environ["ECFFT_EXECUTOR"] = "unrolled"
            t0 = time.perf_counter()
            sched, _, meta = tree._schedule(*key)
            setup_s = time.perf_counter() - t0

            def run():
                return getattr(tree, method)(x, *args)
            torch.cuda.synchronize()
            reset_counts()
            out = run()
            torch.cuda.synchronize()
            counts = read_counts(spec)
            for b, w in want.items():
                got = int(out[b]) if method == "degree" else ints(out[b])
                check(got == w, f"{name} ({ex}) does not match the native "
                                f"engine on lane {b}")
            if method == "degree":
                check(out.tolist() == degs, f"{name} ({ex}): the degrees")
            else:
                check(in_range(out, spec),
                      f"{name} ({ex}) output limbs out of range")
            check_counts(f"{name} ({ex})", counts, sched,
                         meta if ex == "unrolled" else None)
            totals.update(counts)
            times = []
            for _ in range(2):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                run()
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            best = min(times)
            launched = {k: v for k, v in counts.items() if v}
            n_cmp = int((sched.xs[0] == emit.OP_CMPSEL).sum())
            cmpsel = f", {n_cmp} cmpsel steps in plain PyTorch" * bool(n_cmp)
            log(f"{name} ({ex}), {m} points, B={batch}: W={sched.W} "
                f"A={sched.A} steps={len(sched.xs[0])}; schedule"
                f"{' and analysis' if ex == 'unrolled' else ''} "
                f"{setup_s:.3f} s; gate passed (== native on lanes 0, "
                f"{batch - 1}); launches {launched} = {sum(counts.values())}"
                f"{cmpsel}"
                f"; warm reps (s) {[round(t, 4) for t in times]}: "
                f"{batch / best:.3f} polys/s")
            rows.append((name, ex, m, len(sched.xs[0]),
                         sum(counts.values()), counts["mulss"],
                         batch / best))
            outs[ex] = out
            del out
        check(torch.equal(outs["scan"], outs["unrolled"]),
              f"{name}: the unrolled executor differs from the scan one")
        del outs, x
        torch.cuda.empty_cache()
    os.environ.pop("ECFFT_EXECUTOR", None)
    return totals, rows


def check_counts(what, counts, sched, meta):
    """A call's launches against its schedule's steps (scan executor,
    ``meta`` None) or the fusion analysis (unrolled)."""
    if meta is None:
        pred = scan_counts(sched)
        check(all(counts[k] == v for k, v in pred.items()
                  if k != "aff1s_ip")
              and counts["aff1s_ip"] >= pred["aff1s_ip"],
              f"{what} launches {counts} against the schedule's steps "
              f"{pred}")
    else:
        pred, _ = analysis_counts(sched, meta)
        check(all(counts[k] == pred[k] for k in (
            "muladd1", "muladd2", "fused_bf1", "fused_bf2",
            "fused_cascade", "mulss")),
              f"{what} launches {counts} against the analysis {dict(pred)}")


def print_table(rows, batch):
    log("algorithm | executor | points | steps | launches (mulss) | "
        f"polys/s at B={batch}")
    for alg, ex, m, steps, launches, mul, tput in rows:
        log(f"{alg} | {ex} | {m} | {steps} | {launches} ({mul}) | "
            f"{tput:.3f}")


def field_path(tree, nt, gen, label, batch, phase, only=None):
    """One field's main path on both executors, on a tree of phase 3b or
    3c (phase 9: M31; phase 10: a general prime): ENTER of ``batch``
    polynomials gated against the native engine with its EXIT round trip,
    timed warm, the executors compared; then the six other algorithms, or
    those named in ``only``. Every kernel of the field's form must launch.
    Returns the form's launches over its gated calls."""
    totals = collections.Counter()
    n = tree.n
    with Phase(f"{phase}a {label}: ENTER and its EXIT round trip on both "
               "executors"):
        coeffs = rand_limbs((batch, n), gen, tree.spec)
        nt_out, outs = {}, {}
        for ex in ("scan", "unrolled"):
            os.environ.pop("ECFFT_EXECUTOR", None)
            if ex == "unrolled":
                os.environ["ECFFT_EXECUTOR"] = "unrolled"
            outs[ex], enter, exit_ = gate(tree, coeffs, nt_out, nt,
                                          f"{label} {ex}")
            for alg, got in (("enter", enter), ("exit", exit_)):
                sched, _, meta = tree._schedule(alg, n)
                check_counts(f"{label} {alg} ({ex})", got, sched,
                             meta if ex == "unrolled" else None)
            totals.update(enter)
            totals.update(exit_)
            timed_reps(tree, gen, f"{label} {ex}", batch)
        check(torch.equal(outs["scan"], outs["unrolled"]),
              f"{label}: the unrolled ENTER differs from the scan ENTER")
        os.environ.pop("ECFFT_EXECUTOR", None)
        del outs, coeffs
        torch.cuda.empty_cache()
    with Phase(f"{phase}b {label}: "
               + ("the six other algorithms" if only is None
                  else ", ".join(only)) + ", each on both executors"):
        other, rows = other_algorithms(tree, nt, gen, batch, only)
        totals.update(other)
        print_table(rows, batch)
    check(all(totals[k] > 0 for k in KERNELS),
          f"a {label} form was not launched on its path: {dict(totals)}")
    log(f"{label} launches over phase {phase}: {dict(totals)}")
    return totals


# ---------------------------------------------- the NTT and persistence


def ntt_counts_ok(what, counts, sched, meta, spec):
    """An NTT call's launches: one 2-mul step a stage (aff2g on the scan
    executor; muladd2 on the unrolled one, as its analysis predicts), the
    two Montgomery conversions of the state (aff1s) for a prime without a
    fold, and nothing else."""
    steps = len(sched.xs[0])
    two = "aff2g_ip" if meta is None else "muladd2"
    want = {k: 0 for k in KERNELS}
    want[two] = steps
    want["aff1s_ip"] = 2 * fd.is_mont(spec)
    if meta is not None:
        check(analysis_counts(sched, meta)[0]["muladd2"] == steps,
              f"{what}: the analysis fuses an NTT stage")
    check(counts == want, f"{what} launches {counts}, want {want}")


def ntt_path(label, p, g, n, batch, gen):
    """Phase 11, one prime: ``NTTPlan(n, p, g)`` on the card, a batch of
    ``batch`` polynomials on both executors. Gates: intt(ntt(x)) == x on
    the whole batch, ntt against Horner evaluation in Python ints on
    lanes 0 and B − 1 (at 8 root powers, or all n where n ≤ 2^10), the
    executors equal on the whole batch, the launches against the
    schedule's stages and the analysis. Returns (the form's launches over
    the gated calls, {(executor, direction): polys/s}, best of 5 warm)."""
    t0 = time.perf_counter()
    plan = NTTPlan(n, p=p, generator=g, device=DEV)
    spec = plan.spec
    log(f"NTT {label}: p = {p:#x} ({spec.num_limbs} limbs, form "
        f"{step.kernel_form(spec)}), n = {n}, B = {batch}; plan (pool of "
        f"{plan.pool.shape[0]} rows, {len(plan._fwd.xs[0])} + "
        f"{len(plan._inv.xs[0])} steps, W={plan._fwd.W} A={plan._fwd.A}): "
        f"{time.perf_counter() - t0:.3f} s")
    x = rand_limbs((batch, n), gen, spec)
    w = pow(g, (p - 1) // n, p)
    idx = (range(n) if n <= 1 << 10 else
           sorted({0, 1, 2, 3, n // 4, n // 2, n - 2, n - 1}))
    want = {}
    for b in (0, batch - 1):
        cs = [int(v) for v in fd.decode(spec, x[b])]
        want[b] = [evaluate(cs, pow(w, i, p), p) for i in idx]
    totals, outs, rates = collections.Counter(), {}, {}
    for ex in ("scan", "unrolled"):
        os.environ.pop("ECFFT_EXECUTOR", None)
        if ex == "unrolled":
            os.environ["ECFFT_EXECUTOR"] = "unrolled"
        calls = {}
        for inverse in (False, True):
            sched, _, meta = plan.schedule(inverse)
            torch.cuda.synchronize()
            reset_counts()
            out = plan.intt(outs[ex]) if inverse else plan.ntt(x)
            torch.cuda.synchronize()
            counts = read_counts(spec)
            ntt_counts_ok(f"NTT {label} {'intt' if inverse else 'ntt'} "
                          f"({ex})", counts, sched,
                          meta if ex == "unrolled" else None, spec)
            totals.update(counts)
            calls[inverse] = {k: v for k, v in counts.items() if v}
            if inverse:
                check(torch.equal(out, x), f"NTT {label} ({ex}): intt(ntt(x))"
                                           " != x")
            else:
                outs[ex] = out
                check(in_range(out, spec), f"NTT {label} ({ex}) limbs out of "
                                           "range")
                for b, vals in want.items():
                    got = fd.decode(spec, out[b])
                    check([int(got[i]) for i in idx] == vals,
                          f"NTT {label} ({ex}) differs from naive evaluation "
                          f"on lane {b}")
        for inverse, fn in ((False, plan.ntt), (True, plan.intt)):
            arg = outs[ex] if inverse else x
            times = []
            for _ in range(REPS):
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                fn(arg)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t1)
            rates[(ex, "intt" if inverse else "ntt")] = batch / min(times)
            log(f"NTT {label} {'intt' if inverse else 'ntt'} ({ex}): "
                f"launches {calls[inverse]}; warm reps (s) "
                f"{[round(t, 5) for t in times]}: "
                f"{batch / min(times):.3f} polys/s")
        log(f"NTT {label} ({ex}): gates passed: intt(ntt(x)) == x on the "
            f"whole batch; ntt == naive evaluation at {len(idx)} root "
            f"powers on lanes 0 and {batch - 1}")
    os.environ.pop("ECFFT_EXECUTOR", None)
    check(torch.equal(outs["scan"], outs["unrolled"]),
          f"NTT {label}: the unrolled executor differs from the scan one")
    return totals, rates


def persistence(tree, gen, batch=BATCH):
    """Phase 8c on phase 3's tree: serialize in both modes and reserialize
    after a deserialize (the bytes identical); the deserialized tree's
    ENTER of the whole batch equals the tree's; the npz tables the same;
    ``prepare(cache_dir=…)`` on a temporary directory by the deserialized
    tree (it builds and writes) and by the npz tree (it must read the
    pool and both schedules: the pool builder and the emitters are taken
    away meanwhile), whose ENTER and EXIT equal the tree's; a tree built
    on the CPU, prepared there and moved by ``place_on``, whose ENTER
    equals the tree's. Each step printed with its seconds."""
    import tempfile

    from ecfft_tpu_torch import fftree as tfftree

    def timed(what, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        log(f"{what}: {time.perf_counter() - t0:.3f} s")
        return out

    x = rand_limbs((batch, tree.n), gen)
    want = tree.enter(x)
    data = {}
    for compress in (True, False):
        mode = "compressed" if compress else "uncompressed"
        data[compress] = timed(f"serialize ({mode})",
                               lambda: serialize_fftree(tree, compress))
        t2 = timed(f"deserialize ({mode}, {len(data[compress])} bytes)",
                   lambda: deserialize_fftree(FIELD, data[compress],
                                              compress, device=DEV))
        again = timed(f"reserialize ({mode})",
                      lambda: serialize_fftree(t2, compress))
        check(again == data[compress], f"reserialized bytes differ ({mode})")
    check(len(data[True]) < len(data[False]), "compressed is not smaller")
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "tree.npz")
        timed("save_tables_npz", lambda: save_tables_npz(tree, path))
        t4 = timed(f"load_tables_npz ({os.path.getsize(path)} bytes)",
                   lambda: load_tables_npz(path, device=DEV))
        timed("prepare(cache_dir) of the deserialized tree (builds the "
              "pool and the ENTER/EXIT schedules, writes them)",
              lambda: t2.prepare(cache_dir=d))
        files = sorted(f for f in os.listdir(d) if f.startswith("."))
        log(f"cache files: {[(f, os.path.getsize(os.path.join(d, f))) for f in files]}")
        check(len(files) == 3, f"cache files {files}")
        got = timed("the deserialized tree's ENTER",
                    lambda: t2.enter(x))
        check(torch.equal(got, want), "the deserialized tree's ENTER "
                                      "differs")
        pool_builder, emitters = tfftree.build_pool, tfftree._EMITTERS
        tfftree.build_pool, tfftree._EMITTERS = None, {}
        try:
            timed("prepare(cache_dir) of the npz tree (reads the pool and "
                  "the schedules)", lambda: t4.prepare(cache_dir=d))
        finally:
            tfftree.build_pool, tfftree._EMITTERS = pool_builder, emitters
        check(torch.equal(t4._pool, tree._pool), "the cached pool differs")
        got = timed("the cached npz tree's ENTER", lambda: t4.enter(x))
        check(torch.equal(got, want), "the cached tree's ENTER differs")
        got = timed("the cached npz tree's EXIT", lambda: t4.exit(want))
        check(torch.equal(got, x), "the cached tree's EXIT differs")
    del t2, t4, got
    cpu = timed("a native-built tree on the CPU, prepared there",
                lambda: build_fftree_native(FIELD, tree.n,
                                            device="cpu").prepare())
    timed("place_on(cuda)", lambda: cpu.place_on(DEV))
    got = timed("the moved tree's ENTER", lambda: cpu.enter(x))
    check(torch.equal(got, want), "the moved tree's ENTER differs")
    log(f"persistence gates passed: bytes identical after a round trip "
        f"(compressed {len(data[True])}, uncompressed {len(data[False])} "
        f"bytes); ENTER of B={batch} equal on the deserialized, npz + cache "
        f"and moved trees; EXIT equal on the cached one")


# ------------------ the bootstrap, the unscheduled forms and sharding

# the kernels' plain versions (and the plain field product): phase 8d
# counts their calls with a CUDA tensor among the arguments, which must
# stay 0 (a product on the card is a kernel launch)
PLAIN = ((step, "_mulss_cols"), (step, "_muladd1_cols"),
         (step, "_muladd2_cols"), (fd, "mul"))


class PlainOnCard:
    """While active, count each plain version's calls on CUDA tensors."""

    def __enter__(self):
        self.calls = collections.Counter()
        self.saved = [(mod, name, getattr(mod, name)) for mod, name in PLAIN]
        for mod, name, fn in self.saved:
            def spy(*a, _fn=fn, _name=name, **k):
                if any(isinstance(t, torch.Tensor) and t.is_cuda for t in a):
                    self.calls[_name] += 1
                return _fn(*a, **k)
            setattr(mod, name, spy)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)


def same_tables(got, want, label) -> int:
    """Every table of every size and each plane of every ``mats`` depth
    equal bit for bit; returns how many tensors were compared."""
    check(sorted(got) == sorted(want), f"{label}: the bootstrap's sizes")
    count = 0
    for m, t in want.items():
        check(sorted(got[m]) == sorted(t), f"{label}: size {m}'s tables")
        for name, v in t.items():
            if name == "mats":
                check(len(got[m][name]) == len(v),
                      f"{label}: size {m}'s mats depths")
                pairs = [(g, w) for gq, wq in zip(got[m][name], v)
                         for g, w in zip(gq, wq)]
            else:
                pairs = [(got[m][name], v)]
            for g, w in pairs:
                check(torch.equal(g, w), f"{label}: the bootstrap's {name} "
                                         f"of size {m} differs from the "
                                         "native engine's")
                count += 1
    return count


def bootstrap(label, spec, n, native_tree, native_build_s):
    """``FFTree.build`` on the card, its tables held to ``native_tree``'s
    (the native engine's); its seconds beside the native build's, its
    launches per kernel. Returns (the tree, its launches)."""
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    tree = FFTree.build(spec, n, device=DEV)
    torch.cuda.synchronize()
    boot_s = time.perf_counter() - t0
    counts = read_counts(spec)
    compared = same_tables(tree.tables, native_tree.tables, label)
    log(f"bootstrap {label} (n = {n}, form {step.kernel_form(spec)}): "
        f"{boot_s:.3f} s, the native engine's tables {native_build_s:.3f} "
        f"s; {compared} tables and mats planes equal the native engine's "
        f"bit for bit; launches "
        f"{ {k: v for k, v in counts.items() if v} } = "
        f"{sum(counts.values())}")
    return tree, counts


def timed_best(fn, reps=2):
    """Best of ``reps`` warm calls, fenced by ``torch.cuda.synchronize()``."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return min(times)


def unscheduled(tree, gen, label, batch, stree=None):
    """Each ``*_unscheduled`` algorithm on ``batch`` lanes, equal on the
    whole batch to the scheduled method on the same input (which phases
    6–9 hold to the native engine); ENTER's output is EXIT's input, and
    EXIT's output must be ENTER's input; REDC and MOD by the tree's own
    tables xnn_s and z0z0_rem_xnn_s. Each timed warm, best of 2, beside
    the scheduled method. With ``stree`` (a ShardedFFTree of the tree) the
    sharded method runs on the same input too: its shards, concatenated,
    equal the scheduled output, each shard on its device. Returns the
    launches of the unscheduled calls."""
    S0, S1 = emit.S0, emit.S1
    N, spec = tree.n, tree.spec
    h = N // 2
    a, c = (tree.tables[N][k].to(DEV) for k in ("xnn_s", "z0z0_rem_xnn_s"))
    ev, degs = degree_batch(tree, gen, random.Random(14), batch)
    algs = [  # name, unscheduled, scheduled, its input (points or a batch)
        ("ENTER", lambda x: tree.enter_unscheduled(x), "enter", (), N),
        ("EXIT", lambda x: tree.exit_unscheduled(x), "exit", (), None),
        ("EXTEND onto S0", lambda x: tree.extend_unscheduled(x, S0),
         "extend", (S0,), h),
        ("EXTEND onto S1", lambda x: tree.extend_unscheduled(x, S1),
         "extend", (S1,), h),
        ("MEXTEND onto S0", lambda x: tree.mextend_unscheduled(x, S0),
         "mextend", (S0,), h),
        ("MEXTEND onto S1", lambda x: tree.mextend_unscheduled(x, S1),
         "mextend", (S1,), h),
        ("DEGREE", lambda x: tree.degree_unscheduled(x), "degree", (), ev),
        ("REDC by Z0, a = X^(n/2)",
         lambda x: tree._redc_unscheduled(x, a, S0), "redc_z0", (), N),
        ("REDC by Z1, a = X^(n/2)",
         lambda x: tree._redc_unscheduled(x, a, S1), "redc_z1", (), N),
        ("MOD, a = X^(n/2)",
         lambda x: tree.modular_reduce_unscheduled(x, a, c),
         "modular_reduce", (), N),
        ("VANISH", lambda x: tree.vanish_unscheduled(x), "vanish", (), h),
    ]
    totals, rows, coeffs = collections.Counter(), [], None
    for name, run, method, args, size in algs:
        if size is None:  # EXIT: ENTER's output
            x = entered
        elif isinstance(size, int):
            x = rand_limbs((batch, size), gen, spec)
        else:
            x = size
        torch.cuda.synchronize()
        reset_counts()
        out = run(x)
        torch.cuda.synchronize()
        counts = read_counts(spec)
        totals.update(counts)
        want = getattr(tree, method)(x, *args)
        check(torch.equal(out, want), f"{label} {name}: the unscheduled "
                                      "form differs from the scheduled one")
        if method == "degree":
            check(out.tolist() == degs, f"{label} {name}: the degrees")
        if method == "enter":
            coeffs, entered = x, out
        if method == "exit":
            check(torch.equal(out, coeffs), f"{label}: EXIT does not "
                                            "round-trip ENTER")
        best_u = timed_best(lambda: run(x))
        best_s = timed_best(lambda: getattr(tree, method)(x, *args))
        shard_note = ""
        if stree is not None:
            shards = getattr(stree, method)(x, *args)
            check(len(shards) == len(stree.mesh)
                  and all(o.device == d and o.shape[0] == batch // len(
                      stree.mesh) for o, d in zip(shards, stree.mesh))
                  and torch.equal(torch.cat(shards), want),
                  f"{label} {name}: the sharded output differs")
            shard_note = f"; sharded over {len(stree.mesh)} equal"
            del shards
        log(f"{label} {name} unscheduled, B={batch}: == scheduled on the "
            f"whole batch{shard_note}; launches "
            f"{ {k: v for k, v in counts.items() if v} } = "
            f"{sum(counts.values())}; {batch / best_u:.3f} polys/s "
            f"unscheduled, {batch / best_s:.3f} scheduled (scan)")
        rows.append((name, sum(counts.values()), batch / best_u,
                     batch / best_s))
        del out, want
        torch.cuda.empty_cache()
    del coeffs, entered
    log(f"algorithm | launches (unscheduled) | polys/s unscheduled | "
        f"polys/s scheduled (scan) at B={batch}")
    for name, launches, tu, ts in rows:
        log(f"{name} | {launches} | {tu:.3f} | {ts:.3f}")
    return totals


def sharded_by_tables(tree, stree, gen, batch):
    """REDC and MOD by tables given at run time, sharded: the shards,
    concatenated, equal the unsharded tree's output."""
    N, spec = tree.n, tree.spec
    ga, gc = rand_limbs((N,), gen, spec), rand_limbs((N,), gen, spec)
    ga = ga.clamp(min=1) if fd.is_m31(spec) else ga | 1
    x = rand_limbs((batch, N), gen, spec)
    for name, method, args in (
            ("REDC by Z0, general modulus", "redc_z0", (ga,)),
            ("REDC by Z1, general modulus", "redc_z1", (ga,)),
            ("MOD, general modulus", "modular_reduce", (ga, gc))):
        want = getattr(tree, method)(x, *args)
        shards = getattr(stree, method)(x, *args)
        check(all(o.device == d for o, d in zip(shards, stree.mesh))
              and torch.equal(torch.cat(shards), want),
              f"{name}: the sharded output differs")
        log(f"{name} sharded over {len(stree.mesh)}, B={batch}: equal to "
            "the unsharded output, each shard on its device")


def run_module(module, args) -> None:
    """``python -m ecfft_tpu_torch.<module>`` with ``args`` in a process
    of its own, as a user runs it; it must exit 0. Prints its output."""
    env = {k: v for k, v in os.environ.items() if k != "ECFFT_EXECUTOR"}
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", f"ecfft_tpu_torch.{module}", *args],
        capture_output=True, text=True, timeout=400, env=env,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    log(f"{module} {' '.join(args)}: exit {res.returncode} in "
        f"{time.perf_counter() - t0:.3f} s")
    log(res.stderr.strip())
    log(res.stdout.strip())
    check(res.returncode == 0, f"{module} {args} failed")


# ------------------------------------------------ the host-side modules


def main_bench():
    """Phase 15: ``ecfft_tpu_torch.bench.main()`` at the flagship shape on
    the default executor, then on the unrolled one, each with the counts
    set to 0 just before and read just after and the plain versions
    watched; returns (the launches of both runs, polys/s by executor)."""
    knobs = {"ECFFT_BENCH_FIELD": FIELD, "ECFFT_BENCH_N": str(N),
             "ECFFT_BENCH_BATCH": str(BATCH), "ECFFT_BENCH_REPS": str(REPS)}
    saved = {k: os.environ.pop(k, None)
             for k in (*knobs, "ECFFT_EXECUTOR", "ECFFT_BENCH_DEVICE")}
    os.environ.update(knobs)
    counts, rates = collections.Counter(), {}
    try:
        for executor in ("scan", "unrolled"):
            if executor == "unrolled":
                os.environ["ECFFT_EXECUTOR"] = "unrolled"
            out = io.StringIO()
            torch.cuda.synchronize()
            reset_counts()
            with PlainOnCard() as plain, contextlib.redirect_stdout(out):
                res = bench.main()
            torch.cuda.synchronize()
            got = read_counts()
            lines = out.getvalue().splitlines()
            log(f"{executor} bench: {out.getvalue().strip()}")
            check(len(lines) == 1, f"the {executor} bench printed "
                                   f"{len(lines)} lines on stdout")
            check(json.loads(lines[0]) == res,
                  f"the {executor} bench's line is not its result")
            check(res["executor"] == executor,
                  f"the bench ran {res['executor']}, not {executor}")
            check(res["value"] > 0, f"the {executor} bench's value")
            check(not plain.calls, f"a plain version ran on the card in "
                                   f"the {executor} bench: "
                                   f"{dict(plain.calls)}")
            kinds = SCAN_KERNELS if executor == "scan" else UNROLLED_KERNELS
            check(all(got[k] > 0 for k in kinds),
                  f"the {executor} bench did not launch each of {kinds}: "
                  f"{got}")
            log(f"{executor} bench launches: {got}")
            counts.update(got)
            rates[executor] = res["value"]
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return counts, rates


def host_enter(field, n, coeffs, conn) -> None:
    """Phase 14a's child process: the host oracle's tree of size ``n``
    over ``field`` and its ENTER of ``coeffs`` (python ints), sent back as
    ("ok", the evaluations, build s, ENTER s) or ("error", what)."""
    try:
        t0 = time.perf_counter()
        ht = build_host_fftree(field, n)
        t1 = time.perf_counter()
        out = ht.enter(coeffs)
        conn.send(("ok", out, t1 - t0, time.perf_counter() - t1))
    except Exception as e:  # the parent fails the run on it
        conn.send(("error", repr(e)))
    finally:
        conn.close()


def start_host_enter(coeffs):
    """:func:`host_enter` of ``coeffs`` at the main width in a spawned
    process, which overlaps phases 7–13 on another core. Returns (the
    process, the pipe its answer comes on). The process is daemonic:
    whatever way this run ends, ``multiprocessing`` stops it on exit."""
    ctx = multiprocessing.get_context("spawn")
    recv, send = ctx.Pipe(duplex=False)
    proc = ctx.Process(target=host_enter, args=(FIELD, N, coeffs, send),
                       daemon=True)
    proc.start()
    send.close()
    return proc, recv


def host_side(child, want) -> collections.Counter:
    """Phase 14: the host oracle as a third witness of the card's ENTER at
    the main width (``want``: phase 6a's lane 0) and of M31's EXIT at
    n = 4096 on both executors, the binary-field tree, Schoof's counts and
    the examples as users run them. Returns the M31 launches of 14b."""
    proc, recv = child
    with Phase(f"14a the host oracle's ENTER of phase 6a's lane 0 (n = {N}, "
               f"{FIELD}) against the card's"):
        t0 = time.perf_counter()
        try:
            msg = recv.recv() if recv.poll(HOST_TIMEOUT_S) else None
        except EOFError:
            msg = None
        log(f"waited {time.perf_counter() - t0:.3f} s for the child")
        proc.join(30)
        what = ("no answer" if msg is None else msg[1]
                if msg[0] == "error" else "its exit code")
        check(msg is not None and msg[0] == "ok" and proc.exitcode == 0,
              f"the host oracle's child failed (exit {proc.exitcode}): "
              f"{what}")
        _, got, build_s, enter_s = msg
        first = next((i for i, (g, w) in enumerate(zip(got, want))
                      if g != w), None)
        check(len(got) == len(want) and first is None,
              f"the host oracle's ENTER differs from the card's (first at "
              f"{first})")
        log(f"host oracle (python ints, a process of its own): tree "
            f"{build_s:.3f} s, ENTER {enter_s:.3f} s; its {len(got)} "
            "evaluations equal the scan executor's ENTER of lane 0")

    counts = collections.Counter()
    with Phase(f"14b M31 EXIT at n = {HOST_M31_N} of the host oracle's "
               "evaluations, both executors"):
        t0 = time.perf_counter()
        ht = build_host_fftree("m31", HOST_M31_N)
        rng = np.random.RandomState(5)
        coeffs = [[int(v) for v in row] for row in
                  rng.randint(0, M31.p, size=(2, HOST_M31_N))]
        evals = [ht.enter(c) for c in coeffs]
        log(f"host oracle: tree and two ENTERs {time.perf_counter() - t0:.3f}"
            " s")
        tree = build_fftree_native("m31", HOST_M31_N, device=DEV).prepare()
        x = tree.encode(evals)
        for ex in ("scan", "unrolled"):
            if ex == "unrolled":
                os.environ["ECFFT_EXECUTOR"] = "unrolled"
            try:
                torch.cuda.synchronize()
                reset_counts()
                out = tree.exit(x)
                torch.cuda.synchronize()
                got = read_counts(M31)
            finally:
                os.environ.pop("ECFFT_EXECUTOR", None)
            check([[int(v) for v in row] for row in tree.decode(out)]
                  == coeffs, f"{ex} M31 EXIT of the host oracle's "
                             "evaluations does not give the coefficients")
            check(any(got.values()), f"{ex} M31 EXIT launched no kernel")
            log(f"{ex}: EXIT == the coefficients on both lanes; launches "
                f"{got}")
            counts.update(got)
        del tree, x, out

    with Phase("14c the binary-field tree: GF(2^9) at n = 16 (host)"):
        bt = build_host_fftree_even(GF512, 16)
        check(bt is not None, "no GF(2^9) tree at n = 16")
        rng = random.Random(3)
        cs = [rng.randrange(GF512.order) for _ in range(16)]
        ev = bt.enter(cs)
        check(ev == [_evaluate(GF512, cs, x) for x in bt.eval_domain()],
              "the GF(2^9) ENTER differs from naive evaluation")
        check(bt.exit(ev) == cs, "the GF(2^9) EXIT does not round-trip")
        log("GF(2^9), n = 16: ENTER == naive evaluation, EXIT round-trips")

    with Phase("14d Schoof through the native engine: M31 and 2^61 - 1"):
        a, b = SCHOOF_CURVE
        t0 = time.perf_counter()
        n31 = cardinality_native(ShortWeierstrass(a, b, M31.p))
        log(f"#E(M31) = {n31} in {time.perf_counter() - t0:.3f} s")
        check(n31 == SCHOOF_M31_ORDER, f"#E(M31) = {n31}, not "
                                       f"{SCHOOF_M31_ORDER}")
        p = (1 << 61) - 1
        curve = ShortWeierstrass(a, b, p)
        t0 = time.perf_counter()
        n61 = cardinality_native(curve)
        log(f"#E(2^61 - 1) = {n61} in {time.perf_counter() - t0:.3f} s")
        check(abs(p + 1 - n61) <= 2 * math.isqrt(p) + 1,
              "#E(2^61 - 1) breaks Hasse's bound")
        rng, held = random.Random(7), 0
        while held < 2:
            x = rng.randrange(p)
            y = sqrt_mod((x * x * x + a * x + b) % p, p)
            if y is not None:
                check((Point(x, y, curve) * n61).is_zero(),
                      f"#E(2^61 - 1)·P is not O at x = {x}")
                held += 1
        log("#E(2^61 - 1): within Hasse's bound, N·P = O on two points")

    with Phase("14e the examples as users run them"):
        run_module("examples.interp_eval", [])
        run_module("examples.find_curve", [str(FIND_CURVE_K)])
        run_module("examples.schoof_large", ["61"])
    return counts


def main() -> int:
    global SM_CLOCKS
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.cuda.set_device(DEV)
    os.environ.pop("ECFFT_EXECUTOR", None)

    with Phase("1 device report"):
        name = torch.cuda.get_device_name(0)
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
        clock = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, check=True).stdout.strip().splitlines()[0]
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        SM_CLOCKS = sms * float(clock) * 1e6  # SM clocks per second
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
        log(f"{sms} SMs, top SM clock {clock} MHz: "
            f"{SM_CLOCKS * PIPE_LANES_PER_SM / 1e12:.3f} T lanes/s per "
            f"integer pipe, {SM_CLOCKS * ISSUE_LANES_PER_SM / 1e12:.3f} T "
            f"issued; memory {HBM_BYTES_PER_S / 1e12} TB/s")
        log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
            f"nvcc {nvcc}, triton {triton_v}")

    with Phase("2 build"):
        t0 = time.perf_counter()
        libs = _build.build_kernels(FORMS)
        for form in FORMS:
            step.load_kernels(form)
        log(f"kernel forms {', '.join(FORMS)} built (one nvcc each, all "
            f"at once) and loaded in {time.perf_counter() - t0:.3f} s")
        t0 = time.perf_counter()
        native_library()
        log(f"native engine built in {time.perf_counter() - t0:.3f} s")
        for form in FORMS:
            SASS[form] = kernel_sass(libs[form], form)
            spec = FORM_SPEC[form]
            nz, blocks = fold_nonzero(spec), max(words(spec), 1)
            rounds = fold_rounds(spec)
            log(f"[{form}] fold rounds of this run's values: {rounds}")
            for k in KERNELS:
                if k != "fused_cascade":
                    per = sass_count.thread_counts(SASS[form][k], rounds,
                                                   nz, (), blocks)
                    log(f"{k}[{form}]: one thread issues {per}")
            cas = SASS[form]["fused_cascade"]
            base = sass_count.thread_counts(cas, rounds, nz, (), blocks)
            for kind in (0, 1):
                one = sass_count.thread_counts(cas, rounds, nz, [kind],
                                               blocks)
                log(f"fused_cascade[{form}]: one thread issues {base} "
                    f"outside the levels, and per level of kind {kind} "
                    f"{ {x: one[x] - base[x] for x in one} }")
            for line in kernel_resources(libs[form], form):
                log(line)
        for k in ("fused_bf1", "fused_bf2"):
            ahead, loads = sass_count.loads_before_first_product(
                SASS["fold16"][k])
            log(f"{k}: {ahead} of its {loads} device loads stand ahead of "
                f"the first IMAD.WIDE.U32")

    gen = torch.Generator(device=DEV)
    gen.manual_seed(1)
    with Phase("3 tree, pool, schedules and the unrolled analysis (set-up)"):
        t0 = time.perf_counter()
        tree = build_fftree_native(FIELD, N, device=DEV)
        build_s = {FIELD: time.perf_counter() - t0}
        tree.prepare()
        log(f"tree (the native engine's tables: {build_s[FIELD]:.3f} s), "
            f"pool and schedules: {time.perf_counter() - t0:.3f} s")
        t0 = time.perf_counter()
        os.environ["ECFFT_EXECUTOR"] = "unrolled"
        tree.prepare()
        os.environ.pop("ECFFT_EXECUTOR")
        log(f"unrolled analysis: {time.perf_counter() - t0:.3f} s")
        sched, _, meta = tree._schedule("enter", N)
        predicted = {}
        for alg in ("enter", "exit"):
            s, _, m = tree._schedule(alg, N)
            predicted[alg], runs = analysis_counts(s, m)
            if alg == "enter":
                cascade_run = max(runs, key=lambda r: len(r[1]))
            log(f"{alg}: W={s.W} A={s.A} steps={len(s.xs[0])}; the "
                f"analysis predicts {dict(predicted[alg])} "
                f"(longest in-tile run {max(len(r[1]) for r in runs)})")
        log(f"pool rows={tree._pool.shape[0]}; ENTER's longest in-tile run: "
            f"start {cascade_run[0]}, halves {cascade_run[1]}, kinds "
            f"{cascade_run[2]}")
    with Phase("3b M31: tree, pool, schedules and the unrolled analysis"):
        t0 = time.perf_counter()
        tree31 = build_fftree_native("m31", M31_N, device=DEV)
        build_s["m31"] = time.perf_counter() - t0
        tree31.prepare()
        log(f"M31 tree (the native engine's tables: {build_s['m31']:.3f} "
            f"s), pool ({tree31._pool.shape[0]} rows) and schedules: "
            f"{time.perf_counter() - t0:.3f} s")
        t0 = time.perf_counter()
        os.environ["ECFFT_EXECUTOR"] = "unrolled"
        tree31.prepare()
        os.environ.pop("ECFFT_EXECUTOR")
        log(f"M31 unrolled analysis: {time.perf_counter() - t0:.3f} s")
        sched31, _, meta31 = tree31._schedule("enter", M31_N)
        run31 = max(analysis_counts(sched31, meta31)[1],
                    key=lambda r: len(r[1]))
        nt31 = NativeFFTree("m31", M31_N)
    with Phase("3c the general prime: trees, pools, schedules and the "
               "unrolled analysis"):
        gtrees = {}
        for label, (n, _, _) in PATHS.items():
            t0 = time.perf_counter()
            gtree = build_fftree_native(GSPEC[label], n, device=DEV)
            build_s[label] = time.perf_counter() - t0
            gtree.prepare()
            os.environ["ECFFT_EXECUTOR"] = "unrolled"
            gtree.prepare()
            os.environ.pop("ECFFT_EXECUTOR")
            gsched, _, gmeta = gtree._schedule("enter", n)
            grun = max(analysis_counts(gsched, gmeta)[1],
                       key=lambda r: len(r[1]))
            gtrees[label] = (gtree, NativeFFTree(GSPEC[label], n), gsched,
                             grun)
            spec = GSPEC[label]
            log(f"{label}: p = {spec.p:#x} ({spec.num_limbs} limbs, form "
                f"{step.kernel_form(spec)}, slack "
                f"{16 * spec.num_limbs - spec.p.bit_length()}); tree at n = "
                f"{n}, pool ({gtree._pool.shape[0]} rows), schedules and "
                f"analysis: {time.perf_counter() - t0:.3f} s")

    with Phase("4 kernels against their plain versions"):
        kstats = kernels_against_plain(gen, sched, cascade_run)
    with Phase("4b the M31 forms against their plain versions"):
        m31_stats = kernels_against_plain(gen, sched31, run31, M31,
                                          M31_BATCH, "m31")
    with Phase("4c the general prime's forms against their plain versions"):
        gstats = {}
        for label, (_, batch, _) in PATHS.items():
            if label == "stark":  # its form is held with cios16's
                continue
            _, _, gsched, grun = gtrees[label]
            if label == "cios16":  # the STARK prime at the full width
                gstats[label] = kernels_against_plain(
                    gen, gsched, grun, GSPEC["stark"], batch, "cios16 stark")
                kernels_against_plain(gen, gsched, grun, GSPEC[label], batch,
                                      "cios16 slack 0", small_only=True)
            else:  # a launch at n = 2^10 is shorter than the host's work
                # between launches: the kernels' times from a trace
                gstats[label] = kernels_against_plain(
                    gen, gsched, grun, GSPEC[label], batch, label,
                    profiled=PATHS[label][0] < N)
            torch.cuda.empty_cache()

    with Phase("4d the one-limb fold form against its plain versions"):
        # the 64513 NTT's window (A = 2^10 rows, B = 256) in a state of
        # 2A + 256 rows (the pair levels' main window starts at row A);
        # the cascade runs phase 3's ENTER levels there
        shape = types.SimpleNamespace(W=2 * FOLD1_EDGE_N + 256,
                                      A=FOLD1_EDGE_N, bs_max=64)
        # a launch there (about a microsecond of bound) is shorter than
        # the host's work between launches: the kernels' times are read
        # from a profiler trace
        fold1_stats = kernels_against_plain(
            gen, shape, (0, cascade_run[1], cascade_run[2]), GSPEC["fold1"],
            256, "fold1", profiled=True)
        for label, p in (("fold1 97", 97), ("fold1 65521", 65521)):
            kernels_against_plain(gen, shape, None, spec_for_prime(p), 256,
                                  label, small_only=True)

    with Phase("5 native single-core ENTER baseline"):
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

    coeffs = rand_limbs((BATCH, N), gen)
    nt_out = {}
    with Phase("6a scan executor: ENTER gated against the native engine"):
        scan_out, scan_enter, scan_exit = gate(tree, coeffs, nt_out, nt,
                                               "scan")
        scan_launches = {k: scan_enter[k] + scan_exit[k] for k in KERNELS}
        check(all(scan_launches[k] > 0 for k in SCAN_KERNELS),
              f"a scan kernel was not launched: {scan_launches}")

    with Phase("6b scan executor: ENTER timing, fresh inputs per rep"):
        scan_tput, scan_peak = timed_reps(tree, gen, "scan")
        log(f"native single-core {native_s:.4f} s/poly = "
            f"{1 / native_s:.3f} polys/s; ratio "
            f"{scan_tput * native_s:.2f}x")
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
        del D, iD

    # the host oracle's ENTER of lane 0 starts now, beside phases 7-13
    host_child = start_host_enter([int(v) for v in
                                   fd.decode(SPEC, coeffs[0])])
    host_want = [int(v) for v in fd.decode(SPEC, scan_out[0])]

    os.environ["ECFFT_EXECUTOR"] = "unrolled"
    with Phase("7a unrolled executor: ENTER gated against the native engine"):
        out, un_enter, un_exit = gate(tree, coeffs, nt_out, nt, "unrolled")
        check(torch.equal(out, scan_out),
              "the unrolled ENTER differs from the scan ENTER")
        del out, scan_out
        for alg, got in (("enter", un_enter), ("exit", un_exit)):
            want = predicted[alg]
            log(f"unrolled {alg}: launches / analysis: " + ", ".join(
                f"{k} {got[k]}/{want[k]}" for k in UNROLLED_KERNELS[1:])
                + f"; aff1s_ip (D-engine) {got['aff1s_ip']}")
        un_launches = {k: un_enter[k] + un_exit[k] for k in KERNELS}
        check(all(un_launches[k] > 0 for k in UNROLLED_KERNELS),
              f"an unrolled kernel was not launched: {un_launches}")

    with Phase("7b unrolled executor: ENTER timing, fresh inputs per rep"):
        un_tput, un_peak = timed_reps(tree, gen, "unrolled")
        log(f"ENTER throughput, this run: scan {scan_tput:.3f} polys/s "
            f"(peak {scan_peak / 1e9:.3f} GB), unrolled {un_tput:.3f} "
            f"polys/s (peak {un_peak / 1e9:.3f} GB); unrolled / scan "
            f"{un_tput / scan_tput:.3f}")
    os.environ.pop("ECFFT_EXECUTOR")

    with Phase("8 the six other algorithms, each on both executors"):
        totals, rows = other_algorithms(tree, nt, gen)
        check(totals["mulss"] > 0, "mulss was not launched")
        print_table(rows, BATCH)
    scan_launches["mulss"] = un_launches["mulss"] = totals["mulss"]
    with Phase("8c persistence on phase 3's tree: serialize, npz tables, "
               "the cache directory and place_on"):
        persistence(tree, gen)

    # 8d: launches per form of the bootstrap, the unscheduled forms and
    # sharding, and the plain versions' calls on the card (none allowed)
    new_launches = collections.defaultdict(collections.Counter)
    with PlainOnCard() as plain:
        with Phase("8d-a the device bootstrap on the card against the "
                   "native engine's tables"):
            t0 = time.perf_counter()
            ftree = build_fftree_native(GSPEC["fold1"], FOLD1_N, device=DEV)
            build_s["fold1"] = time.perf_counter() - t0
            for label, spec, n, native_tree in (
                    (FIELD, SPEC, N, tree), ("m31", M31, M31_N, tree31),
                    ("cios16", GSPEC["cios16"], PATHS["cios16"][0],
                     gtrees["cios16"][0]),
                    ("stark", GSPEC["stark"], PATHS["stark"][0],
                     gtrees["stark"][0]),
                    ("fold1", GSPEC["fold1"], FOLD1_N, ftree)):
                btree, counts = bootstrap(label, spec, n, native_tree,
                                          build_s[label])
                new_launches[step.kernel_form(spec)].update(counts)
                del btree
                torch.cuda.empty_cache()
            del ftree
        with Phase(f"8d-b the unscheduled algorithms on phase 3's tree "
                   f"(n = {N}, B = {BATCH}) against the scheduled ones, "
                   "and sharded over two shards of one card"):
            stree = ShardedFFTree(tree, make_mesh([DEV, DEV])).prepare()
            new_launches["fold16"].update(
                unscheduled(tree, gen, FIELD, BATCH, stree))
            sharded_by_tables(tree, stree, gen, BATCH)
            del stree
        with Phase(f"8d-c the unscheduled algorithms on phase 3b's M31 tree "
                   f"(n = {M31_N}, B = {BATCH}) against the scheduled "
                   "ones"):
            new_launches["m31"].update(
                unscheduled(tree31, gen, "M31", BATCH))
    log(f"phase 8d: plain-version calls on CUDA tensors {dict(plain.calls)}"
        f"; launches {({f: dict(c) for f, c in new_launches.items()})}")
    check(not plain.calls, f"a plain version ran on the card in phase 8d: "
                           f"{dict(plain.calls)}")
    for form in ("fold16", "m31"):
        check(all(new_launches[form][k] > 0
                  for k in ("mulss", "muladd1", "muladd2")),
              f"phase 8d launched no mulss, muladd1 or muladd2 of {form}")
    # phase 15's bench loads this tree instead of building it
    save_tables_npz(tree, os.path.join(bench.CACHE_DIR,
                                       f".bench_tree_{FIELD}_{N}.npz"))
    del tree, nt
    torch.cuda.empty_cache()

    m31_launches = field_path(tree31, nt31, gen, "M31", M31_BATCH, 9)
    del tree31, nt31
    torch.cuda.empty_cache()

    glaunches = {}
    for label, (_, batch, what) in PATHS.items():
        gtree, gnt, _, _ = gtrees.pop(label)
        glaunches[label] = field_path(
            gtree, gnt, gen, label, batch, 10,
            None if what == "all" else ("VANISH",))
        del gtree, gnt
        torch.cuda.empty_cache()

    nlaunch, nrates = {}, {}
    for label, p, g, n, batch in NTT_PATHS:
        with Phase(f"11 the classical NTT, {label}: n = {n}, B = {batch}, "
                   "both executors"):
            nlaunch[label], nrates[label] = ntt_path(label, p, g, n, batch,
                                                     gen)
            torch.cuda.empty_cache()
    log("NTT (STARK prime) against ECFFT (secp256k1) at n = 2^16, B = 256, "
        "polys/s, this run (benches/comparison.rs's comparison):")
    log("transform | scan | unrolled")
    for what, scan, unr in (
            ("NTT forward", nrates["stark"][("scan", "ntt")],
             nrates["stark"][("unrolled", "ntt")]),
            ("NTT inverse", nrates["stark"][("scan", "intt")],
             nrates["stark"][("unrolled", "intt")]),
            ("ECFFT ENTER (phases 6b, 7b)", scan_tput, un_tput)):
        log(f"{what} | {scan:.3f} | {unr:.3f}")

    old_tw = unrolled.TW
    unrolled.TW = FOLD1_TW
    try:
        with Phase(f"12 the one-limb fold prime's tree: n = {FOLD1_N}, "
                   f"unrolled tile {FOLD1_TW} rows (set-up)"):
            ftree = build_fftree_native(GSPEC["fold1"], FOLD1_N,
                                        device=DEV).prepare()
            os.environ["ECFFT_EXECUTOR"] = "unrolled"
            ftree.prepare()
            os.environ.pop("ECFFT_EXECUTOR")
        fold1_launches = field_path(ftree, NativeFFTree(GSPEC["fold1"],
                                                        FOLD1_N),
                                    gen, "fold1", FOLD1_BATCH, 12)
    finally:
        unrolled.TW = old_tw
        os.environ.pop("ECFFT_EXECUTOR", None)
    del ftree

    with Phase("13 the per-op bench suite, two runs"):
        run_module("bench_suite",
                   ["--field", "m31", "--n", "2048", "--batch", "256"])
        run_module("bench_suite", ["--comparison", "--batch", "128"])

    new_launches["m31"].update(host_side(host_child, host_want))

    with Phase(f"15 the main bench (ecfft_tpu_torch.bench) in this process: "
               f"{FIELD}, n = {N}, B = {BATCH}, {REPS} reps, both "
               "executors"):
        bench_counts, bench_rates = main_bench()
        new_launches["fold16"].update(bench_counts)
        log("ENTER polys/s, this run: bench scan "
            f"{bench_rates['scan']:.3f} (phase 6b {scan_tput:.3f}), bench "
            f"unrolled {bench_rates['unrolled']:.3f} (phase 7b "
            f"{un_tput:.3f})")

    kernels = []
    for k, (src, replaces) in KERNELS.items():
        launches = (scan_launches if k in SCAN_KERNELS
                    else un_launches)[k] + new_launches["fold16"][k]
        kernels.append({"name": k, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": launches,
                        **kstats[k]})
    for k, (_, replaces) in KERNELS.items():
        kernels.append({"name": f"{k}[m31]", "route": "cuda",
                        "source": M31_SRC, "replaces": replaces,
                        "launches": m31_launches[k] + new_launches["m31"][k],
                        **m31_stats[k]})
    for label, stats in gstats.items():
        for k, (src, replaces) in KERNELS.items():
            launches = glaunches[label][k] + (
                glaunches["stark"][k] + nlaunch["stark"][k]
                + new_launches["cios16"][k] if label == "cios16" else 0)
            kernels.append({"name": f"{k}[{label}]", "route": "cuda",
                            "source": src, "replaces": replaces,
                            "launches": launches, **stats[k]})
    for k, (src, replaces) in KERNELS.items():
        launches = (fold1_launches[k] + nlaunch["fold1 64513"][k]
                    + nlaunch["fold1 97"][k] + new_launches["fold1"][k])
        kernels.append({"name": f"{k}[fold1]", "route": "cuda",
                        "source": src, "replaces": replaces,
                        "launches": launches, **fold1_stats[k]})
    check(len(kernels) == 72, f"{len(kernels)} kernels in the line")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
