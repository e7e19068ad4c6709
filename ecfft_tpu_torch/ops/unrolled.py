"""The unrolled executor: the schedule machine with fused butterfly levels.

The port's counterpart of ``ecfft_tpu/ops/unrolled.py``, reached through
``ops.schedule.run_schedule`` with ``ECFFT_EXECUTOR=unrolled``. Like the
scan executor it is a Python loop over the steps with every parameter
read from the schedule's host arrays; it differs in what a step does.

A step that :class:`_SchedMeta` finds to be an in-place butterfly level
(both rows of each pair in the window, the partner the global xor
``p ^ half``, inactive rows carried by the passthrough coefficient row
0) gathers nothing:

- a level with half ≥ TW goes to :func:`fused_bf1` (``x[p] + C[p]·x[p^h]``)
  or :func:`fused_bf2` (``A[p]·x[p] + B[p]·x[p^h]``), which read each
  window row once and write it once;
- consecutive in-tile levels (half < TW) of the same window join one run,
  flushed as one :func:`fused_cascade`: each TW-row tile is closed under
  all the run's xors, so the tile stays on chip for the whole run.

Every other step gathers its windows as the scan executor does and goes
to :func:`ops.step.muladd1` / :func:`ops.step.muladd2`, which write the
window of the state directly (the JAX package computes a new window and
writes it with ``dynamic_update_slice``; each thread here reads the
elements it writes before it writes them, so no copy is needed). An
OP_MUL step goes to :func:`ops.step.mulss` and an OP_CMPSEL step to
:func:`ops.schedule.cmpsel`, as in the scan executor, behind the flush of
any pending run like every generic step. Every step produces canonical residues, so the outputs equal the scan
executor's bit for bit.

Each fused wrapper launches its hand-written kernel on a CUDA tensor (or
raises): the word form of ``csrc/fused_kernels.cu`` that takes the field,
or ``csrc/m31_kernels.cu`` for M31 (``ops.step.kernel_form``). On a CPU
tensor it runs its plain int64 PyTorch version; each counts its launches
per form as the step wrappers do (``launches``). The plain versions
compute the new window from a copy of the old one, then write it.

On a card the step loop runs as a CUDA graph, captured at the first call
of its key and replayed after (``ops/graphs.py``), where the JAX package
compiles runs of steps into jitted segments. Left out, as plumbing for
the TPU: the segmentation itself (``SEG_STEPS``, ``_SEG_CACHE``,
``ECFFT_UNROLL_DEBUG``: one graph holds the whole loop), the scoped-VMEM compiler
parameters, the trace-time index synthesis (the scan executor's
``_synth`` serves) and static plane slices (the D-engine's plane gather
serves), the lane tile ``tb`` and the ``fuse_ok`` test that Mosaic's
128-lane DMA alignment forced (the port fuses every step the analysis
accepts, at any batch size and on the CPU too), and the cascade's VMEM
budget (a GPU cascade keeps its tile in shared memory whatever its
length). A cascade launch takes at most :data:`MAX_LEVELS` levels (the
kernel takes its levels in a fixed-size parameter array); a longer run
is split, as the reference splits at its budget.
"""

from __future__ import annotations

import collections
import ctypes

import numpy as np
import torch

from ecfft_tpu_torch.fields.registry import FieldSpec
from ecfft_tpu_torch.ops import schedule as sch
from ecfft_tpu_torch.ops import step
from ecfft_tpu_torch.ops.emit import (
    CP_DC, CP_DK, DOP_NONE, DP_DOP, DP_HALF, OP_AFF1S, OP_AFF1S_C,
    OP_AFFINE, OP_AFFINE_C, OP_CMPSEL, OP_MUL, Schedule, _synth_np)

TW = 128  # fused row tile: pair levels need TW | half, in-tile 2·half | TW
MAX_LEVELS = 16  # levels per cascade launch (MAX_LEVELS in levels.cuh)
_KERNEL_TW = 128  # the cascade kernels' largest tile (MAX_TW, M31_TW)


# -------------------------------------------------------------- analysis


def _col_np(xs_np, t: int, ci: int, W: int) -> np.ndarray:
    """Full-width numpy ground truth of column ci of step t."""
    rid = int(xs_np["rid"][t, ci])
    if rid >= 0:
        start, A = int(xs_np["starts"][t]), xs_np["bank"].shape[1]
        dk, dc = int(xs_np["colp"][t, ci, CP_DK]), int(
            xs_np["colp"][t, ci, CP_DC])
        base = (np.arange(W, dtype=np.int32) if dk == 0
                else np.full(W, dc, np.int32))
        base[start:start + A] = xs_np["bank"][rid]
        return base
    return _synth_np(xs_np["colp"][t, ci], W)


class _SchedMeta:
    """Host-side view of a Schedule plus per-step fusion analysis (numpy
    over full-width columns: set-up work, which ``FFTree`` caches beside
    the schedule)."""

    __slots__ = ("xs", "W", "A", "bs_max", "fusable")

    def __init__(self, sched: Schedule):
        ops_a, starts, colp, dp, rid, bank = (np.asarray(a)
                                              for a in sched.xs)
        self.xs = dict(ops=ops_a, starts=starts, colp=colp, dp=dp,
                       rid=rid, bank=bank)
        self.W = sched.W
        self.A = int(bank.shape[1])
        self.bs_max = sched.bs_max
        self.fusable = [self._analyze(t) for t in range(len(ops_a))]

    def _analyze(self, t: int):
        """Return half if step t is a fusable in-place butterfly
        (both halves of each pair in-window, partner = global xor,
        inactive rows carried by C = scratch row 0), else 0."""
        xs = self.xs
        op = int(xs["ops"][t])
        if op not in (OP_AFF1S_C, OP_AFFINE_C):
            return 0
        dop = int(xs["dp"][t, DP_DOP])
        if dop == DOP_NONE:
            return 0
        half = int(xs["dp"][t, DP_HALF])
        if half < 1:
            return 0
        start, A, W = int(xs["starts"][t]), self.A, self.W
        if start % TW or A % TW:
            return 0
        # the xor pairing must partition the window: pair variant groups
        # tiles in blocks of 2·half rows, in-tile variant needs the whole
        # pair group inside one tile
        if half >= TW and A % (2 * half):
            return 0
        if half < TW and TW % (2 * half):
            return 0
        p = np.arange(start, start + A, dtype=np.int64)
        brow = _col_np(xs, t, 2, W)[start:start + A]
        g2 = _col_np(xs, t, 3, W)[start:start + A]
        active = brow != 0
        if not np.array_equal(g2[active], (p ^ half)[active]):
            return 0
        if op == OP_AFFINE_C:
            g1 = _col_np(xs, t, 1, W)[start:start + A]
            arow = _col_np(xs, t, 0, W)[start:start + A]
            # inactive rows of a 2-mul step pass through via A=one, B=zero
            if not np.array_equal(g1[active], p[active]):
                return 0
            if not (np.all(arow[~active] == 0) and np.all(brow[~active] == 0)
                    and np.all(arow[active] > 0)):
                return 0
        if half >= TW:
            if half % TW:
                return 0
            tiles = np.arange(start, start + A, TW, dtype=np.int64)
            part = tiles ^ half
            if part.min() < 0 or part.max() + TW > W:
                return 0
        return half


# ------------------------------------------------------- fused wrappers


class _Levels(ctypes.Structure):
    """Mirror of ``struct Levels`` in csrc/levels.cuh."""
    _fields_ = [("k", ctypes.c_int),
                ("half", ctypes.c_int * MAX_LEVELS),
                ("kind", ctypes.c_int * MAX_LEVELS)]


def _check_fused(spec: FieldSpec, state, start: int, A: int, tensors,
                 coeffs) -> None:
    step.check_state(spec, state, start, A)
    step.check_operands(spec, state.device, (state, *tensors), coeffs, (),
                        A, state.shape[2])
    if start % TW or A % TW:
        raise ValueError(f"window [{start}, {start + A}) is not aligned to "
                         f"the {TW}-row tile")


def _check_pair(spec: FieldSpec, state, start: int, half: int, coeffs) -> int:
    """Validate a pair level's operands; returns the window height A."""
    A = coeffs[0].shape[0]
    _check_fused(spec, state, start, A, (), coeffs)
    if half < TW or half % TW or A % (2 * half) or start % (2 * half):
        raise ValueError(f"half {half} does not pair the window [{start}, "
                         f"{start + A}) in {TW}-row tiles at t + half")
    return A


def _partner(start: int, A: int, half: int, device):
    """Window row of each window row's partner (start + r) ^ half."""
    r = torch.arange(start, start + A, device=device)
    return (r ^ half) - start


def _pair_plain(spec: FieldSpec, state, awin, cwin, start: int,
                half: int) -> None:
    """Plain version of both pair levels (``awin`` None: the 1-mul form):
    the new window from a copy of the old, then written."""
    A = cwin.shape[0]
    win = state[start:start + A]
    part = win.index_select(0, _partner(start, A, half, state.device))
    if awin is None:
        new = step._muladd1_cols(spec, cwin.unsqueeze(-1), win, part)
    else:
        new = step._muladd2_cols(spec, awin.unsqueeze(-1), win,
                                 cwin.unsqueeze(-1), part)
    win.copy_(new)


def _cascade_plain(spec: FieldSpec, state, cwins, awins, start: int,
                   halves, kinds) -> None:
    """Plain version of a cascade, level by level on a copy of the
    window, then written."""
    A = cwins.shape[1]
    win = state[start:start + A]
    x, ai = win.clone(), 0
    for li, (h, kind) in enumerate(zip(halves, kinds)):
        part = x.index_select(0, _partner(start, A, h, state.device))
        if kind:
            x = step._muladd2_cols(spec, awins[ai].unsqueeze(-1), x,
                                   cwins[li].unsqueeze(-1), part)
            ai += 1
        else:
            x = step._muladd1_cols(spec, cwins[li].unsqueeze(-1), x, part)
    win.copy_(x)


def fused_bf1(spec: FieldSpec, state, cwin, start: int, half: int) -> None:
    """x[p] ← x[p] + C[p]·x[p ^ half] on the window [start, start + A),
    in place (one 1-mul pair level, half ≥ TW)."""
    A = _check_pair(spec, state, start, half, (cwin,))
    if state.is_cuda:
        step.launch("ecfft_fused_bf1", spec, state.device, cwin, state,
                    start, half, A, state.shape[2])
        step.count(fused_bf1, spec, A, state.shape[2])
        return
    _pair_plain(spec, state, None, cwin, start, half)


def fused_bf2(spec: FieldSpec, state, awin, bwin, start: int,
              half: int) -> None:
    """x[p] ← A[p]·x[p] + B[p]·x[p ^ half] on the window, in place (one
    2-mul pair level, half ≥ TW)."""
    A = _check_pair(spec, state, start, half, (awin, bwin))
    if state.is_cuda:
        step.launch("ecfft_fused_bf2", spec, state.device, awin, bwin, state,
                    start, half, A, state.shape[2])
        step.count(fused_bf2, spec, A, state.shape[2])
        return
    _pair_plain(spec, state, awin, bwin, start, half)


def fused_cascade(spec: FieldSpec, state, cwins, awins, start: int,
                  halves, kinds) -> None:
    """A run of in-tile levels on the window, in place: for level li,
    x[p] ← x[p] + C_li[p]·x[p ^ h_li] (kind 0) or
    A_ai[p]·x[p] + C_li[p]·x[p ^ h_li] (kind 1, ai counting the kind-1
    levels). cwins: (k, A, L); awins: (k2, A, L) with k2 the number of
    kind-1 levels, or 1 (a dummy row, never read) when there are none."""
    halves, kinds = [int(h) for h in halves], [int(v) for v in kinds]
    k, n2 = len(halves), sum(kinds)
    if cwins.dim() != 3 or awins.dim() != 3:
        raise ValueError("cwins and awins must be (k, A, L)")
    A, L = cwins.shape[1], spec.num_limbs
    _check_fused(spec, state, start, A, (cwins, awins), ())
    if (tuple(cwins.shape) != (k, A, L) or len(kinds) != k
            or tuple(awins.shape) != (max(n2, 1), A, L)
            or not set(kinds) <= {0, 1}):
        raise ValueError(f"{k} levels with {n2} of kind 1 need cwins "
                         f"({k}, {A}, {L}) and awins ({max(n2, 1)}, {A}, "
                         f"{L}); got {tuple(cwins.shape)}, "
                         f"{tuple(awins.shape)}")
    if k == 0 or any(h < 1 or TW % (2 * h) for h in halves):
        raise ValueError(f"halves {halves} are not in-tile levels of the "
                         f"{TW}-row tile")
    if state.is_cuda:
        if k > MAX_LEVELS or TW > _KERNEL_TW:
            raise ValueError(f"the cascade kernel takes at most "
                             f"{MAX_LEVELS} levels on tiles of at most "
                             f"{_KERNEL_TW} rows; got {k} levels, TW {TW}")
        lv = _Levels(k, (ctypes.c_int * MAX_LEVELS)(*halves),
                     (ctypes.c_int * MAX_LEVELS)(*kinds))
        step.launch("ecfft_fused_cascade", spec, state.device,
                    ctypes.byref(lv), cwins, awins, state, start, TW, A,
                    state.shape[2])
        step.count(fused_cascade, spec, A, state.shape[2])
        return
    _cascade_plain(spec, state, cwins, awins, start, halves, kinds)


FUSED_WRAPPERS = (fused_bf1, fused_bf2, fused_cascade)
for _w in FUSED_WRAPPERS:
    _w.launches = collections.Counter()
    _w.shapes = collections.Counter()


# --------------------------------------------------------------- executor


def run_unrolled(spec: FieldSpec, pool, sched: Schedule, bank, batch,
                 one_pos: int, m_out: int, meta: _SchedMeta | None = None,
                 max_levels: int = MAX_LEVELS, cache=None):
    """Execute a schedule with fused butterfly levels (see the module
    docstring): (B, m, L) int32 ``batch`` → (B, m_out, L), as
    ``ops.schedule.run_schedule``, whose ``cache`` keeps the step loop's
    graphs on a card (the key holds ``max_levels`` and the tile
    :data:`TW`). ``meta``: the cached :class:`_SchedMeta` of ``sched``,
    made here when None; runs of in-tile levels longer than
    ``max_levels`` are split."""
    if meta is None:
        meta = _SchedMeta(sched)
    return sch.run_chunks(
        spec, sched, batch, one_pos, m_out,
        lambda x: _run_steps(spec, pool, sched, meta, bank, x, max_levels),
        cache, ("unrolled", max_levels, TW), (pool, bank, meta))


def _run_steps(spec: FieldSpec, pool, sched: Schedule, meta: _SchedMeta,
               bank, x, max_levels: int):
    """Step the (W, L, B) state ``x`` through the schedule, in place."""
    ops_a, starts, _, dp, _, _ = sched.xs
    W, A = sched.W, sched.A
    dev = x.device
    q = torch.arange(A, device=dev)
    bsx = max(sched.bs_max, 1)
    D = torch.zeros((bsx, spec.num_limbs), dtype=torch.int32, device=dev)
    iD = torch.zeros_like(D)
    one_row, zero_row = pool[1:2], pool[0:1]
    # the pending run of in-tile levels: [start, halves, kinds, C rows,
    # A rows of the kind-1 levels]
    pend = None

    def flush():
        nonlocal pend
        if pend is None:
            return
        p_start, halves, kinds, cwins, awins = pend
        pend = None
        ai = 0
        for c0 in range(0, len(halves), max_levels):
            c1 = min(c0 + max_levels, len(halves))
            n2 = sum(kinds[c0:c1])
            cw = torch.stack(cwins[c0:c1])
            aw = torch.stack(awins[ai:ai + n2]) if n2 else cw[:1]
            ai += n2
            fused_cascade(spec, x, cw, aw, p_start, halves[c0:c1],
                          kinds[c0:c1])

    for t in range(ops_a.shape[0]):
        op = int(ops_a[t])
        sch.check_opcode(op)
        start = int(starts[t])
        p = q + start

        def gather(ci):
            return x.index_select(0, sch.col_row(sched, bank, t, ci, p)
                                  .clamp(0, W - 1))

        def coeffs(ci, scratch_rows, pad_row):
            return sch.coeff_rows(pool, sch.col_row(sched, bank, t, ci, p),
                                  scratch_rows, pad_row, bsx)

        CA, CB, D, iD = sch._d_engine(spec, pool, dp[t], D, iD, op)
        half = meta.fusable[t]
        if half:
            cwin = coeffs(2, CB, zero_row)
            awin = coeffs(0, CA, one_row) if op == OP_AFFINE_C else None
            if half >= TW:  # a pair level: a kernel of its own
                flush()
                if awin is None:
                    fused_bf1(spec, x, cwin, start, half)
                else:
                    fused_bf2(spec, x, awin, cwin, start, half)
                continue
            # an in-tile level: join (or open) the pending run
            if pend is not None and pend[0] != start:
                flush()
            if pend is None:
                pend = [start, [], [], [], []]
            pend[1].append(half)
            pend[2].append(0 if awin is None else 1)
            pend[3].append(cwin)
            if awin is not None:
                pend[4].append(awin)
            continue

        flush()
        if op == OP_CMPSEL:
            sch.cmpsel(x, gather, start)
            continue
        x2 = gather(3)
        x1 = (x[start:start + A] if op in (OP_AFF1S, OP_AFF1S_C)
              else gather(1))
        if op == OP_MUL:
            step.mulss(spec, x1, x2, x, start)
        elif op in (OP_AFFINE, OP_AFFINE_C):
            step.muladd2(spec, coeffs(0, CA, one_row),
                         coeffs(2, CB, zero_row), x1, x2, x, start)
        else:
            step.muladd1(spec, coeffs(2, CB, zero_row), x1, x2, x, start)
    flush()
