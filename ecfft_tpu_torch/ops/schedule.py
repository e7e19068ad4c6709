"""The schedule machine's pool and executor, in PyTorch.

The port's counterpart of the device half of ``ecfft_tpu/ops/schedule.py``
(the numpy half is ``ops/emit.py``):

- :func:`build_pool` concatenates every table row a schedule references
  into one (P, L) int32 tensor, with the same rows and offsets as the JAX
  package's ``build_pool`` (tested);
- :func:`run_schedule` runs a schedule over a (B, m, L) batch: it packs
  the (W, L, B) state (with the unbatched extras of a general-modulus
  REDC/MOD behind the batch's rows), steps through the schedule, and
  unpacks the first rows or the rows its ``out_perm`` names. For a prime
  without a pseudo-Mersenne fold the state is in Montgomery form from the
  pack to the unpack, as in the JAX package (``_pack_state``,
  ``_unpack_state``): the packed rows are converted once on the way in
  (the constant 1 becomes R mod p) and the output once on the way out,
  each by the self-read step (a kernel launch on the card). The constant
  1 sits where the JAX package's ``to_state`` puts it (:func:`one_row`).

The executor is a Python loop over the steps of a :class:`StepPlan`: what
a step reads besides the state depends only on the tree and the
schedule, so it is made once per schedule and device (its owner's
``graphs.GraphCache`` keeps it) and every call reads it. Making it runs
the per-step work of the JAX package's scan body once, in step order:
each column's index row synthesised in torch (a mirror of
``_synth_jnp``, or a residual bank row), clamped as ``jnp.clip`` clamps
it in the reference (``index_select`` would raise where ``jnp.take``
clips), and the running-diagonal coefficient engine for the branch each
step's DOP needs (one-lane step launches on the card); it keeps the
index rows as int32 and those of the engine's rows that a step reads.
Per step the loop then gathers x1/x2 with ``index_select`` into buffers
of their own, gathers the coefficient rows from the pool or the plan's
table, and hands the window to one of the three in-place step wrappers
of ``ops/step.py``. A self-read or two-product step whose x2 row reads,
at each window row q, the partner row q XOR h or row q itself (and whose
x1 row, for the latter, is the window itself) is a pair step: the plan
marks it with its h where the field's kernels have the pair form (every
word form, not M31's), and the loop hands it to the pair wrapper, which
reads the rows in place, with no gather of x1 or x2. An OP_MUL step goes
to ``step.mulss`` (a kernel of its own on the card); an OP_CMPSEL step is
plain PyTorch on either device, as the JAX package leaves it to XLA: two
gathers compared into one bool per batch lane, which stays on the device,
and a select written into the window.

``ECFFT_EXECUTOR=unrolled`` hands a schedule to the unrolled executor
(``ops/unrolled.py``), which fuses the butterfly levels instead.

On a card either executor's step loop runs as a CUDA graph, captured at
the first call of its key and replayed after (``ops/graphs.py``): the
counterpart of the JAX package's jitted executors. :func:`run_chunks`
packs each chunk into the graph's static state and unpacks a fresh
output around the replay. A CPU tensor runs the loop eagerly.

Left out, as plumbing for the TPU: the step-row envelope segmentation,
the run-split/``lax.switch`` choice with buffer donation, ``lax.map``
chunking inside segments and the TPU tile-padding preflight. Batch
chunking stays, budgeted from ``torch.cuda.mem_get_info``.
"""

from __future__ import annotations

import contextlib
import os
import weakref

import numpy as np
import torch

from ecfft_tpu_torch.errors import SizeError
from ecfft_tpu_torch.fields import device as fd
from ecfft_tpu_torch.fields.registry import FieldSpec
from ecfft_tpu_torch.native import batch_inv_limbs
from ecfft_tpu_torch.ops import graphs, step
from ecfft_tpu_torch.ops.emit import (
    CP_ALO, CP_AHI, CP_C0, CP_C1, CP_DC, CP_DD, CP_DK, CP_KM, CP_M1, CP_M2,
    CP_M3, CP_OFF, CP_S2, CP_SB, CP_SPAN, CP_XX, DOP_FINAL, DOP_LEVEL,
    DOP_LEVEL0, DOP_NONE, DP_DOP, DP_HALF, DP_HM, DP_MP0, DP_MP1, DP_MS0,
    DP_MS1, DP_MSI0, DP_MSI1, DP_SHALF, OP_AFF1, OP_AFF1_C, OP_AFF1S,
    OP_AFF1S_C, OP_AFFINE, OP_AFFINE_C, OP_CMPSEL, OP_MUL, Schedule, _ilog2)
from ecfft_tpu_torch.utils import profiling

# ----------------------------------------------------------------- pool

_TABLES = ("xnn_s", "xnn_s_inv", "z0_s1", "z1_s0", "z0_inv_s1", "z1_inv_s0",
           "z0z0_rem_xnn_s")


def _plane_meta(sizes: tuple) -> list:
    """(k, d, pi, half) for every compact matrix plane block, in pool
    order (as ``ecfft_tpu.ops.schedule._plane_meta``)."""
    return [(k, d, pi, k >> (d + 2))
            for k in sizes if k >= 4
            for d in range(_ilog2(k) - 1)
            for pi in range(4)]


def build_pool(spec: FieldSpec, tables: dict) -> tuple[torch.Tensor, dict]:
    """Every table row a schedule can reference, as one (P, L) int32
    tensor on the tables' device, and its offsets dict: per (size, depth,
    matrix kind) a 6·half-row plane block [ms0 ‖ ms1 ‖ mp0 ‖ mp1 ‖ msi0 ‖
    msi1], then per size the seven z/xnn tables and the fused EXIT/MOD
    vectors, then the negated 2-leaf domain.

    Sets ``offsets["unscaled"] = True`` when a Lemma-3.2 diagonal entry
    is zero (the emitters then use exact 2-mul butterflies). The
    diagonals' inverses come from the native engine (16-bit limbs) or, for
    a one-limb field (M31, a prime below 2^16), from Fermat's a^(p−2) in
    int64 (``fields.device.inv``); inverses
    are unique, so either equals the JAX package's product-scan inverse."""
    sizes = tuple(sorted(tables))
    meta = _plane_meta(sizes)
    off = {}
    cursor = 2
    for k, d, pi, half in meta:
        off[f"bm_{k}_{d}_{pi}"] = cursor
        cursor += 6 * half
    for k in sizes:
        for name in _TABLES:
            off[f"{name}_{k}"] = cursor
            cursor += tables[k][name].shape[0]
        half = k // 2
        for name, cnt in (("neg_a1_z0inv", half), ("neg_a1_z1inv", half),
                          ("c0_a0inv", half), ("zc1", half),
                          ("neg_xnninv", k), ("neg_z0_inv_s1", half),
                          ("neg_z1_inv_s0", half), ("half_const", 1)):
            off[f"{name}_{k}"] = cursor
            cursor += cnt
    off["neg_leaf2"] = cursor

    quads = [tables[k]["mats"][d][pi] for k, d, pi, _ in meta]
    diags = [q[:, i, i, :] for q in quads for i in (0, 1)]
    L = spec.num_limbs
    dev = tables[sizes[0]]["leaves"].device
    if diags:
        diags = torch.cat(diags)
        if bool((diags == 0).all(dim=-1).any()):
            off["unscaled"] = True
            msi = torch.zeros_like(diags)
        elif spec.num_limbs == 1:  # M31, a prime below 2^16: Fermat
            msi = fd.inv(spec, diags)
        else:
            msi = torch.from_numpy(batch_inv_limbs(
                spec, diags.cpu().numpy()).astype(np.int32)).to(dev)
    rows = [torch.zeros((1, L), dtype=torch.int32, device=dev),
            fd.ones(spec, (1,), dev)]
    cur = 0
    for q, (_, _, _, half) in zip(quads, meta):
        rows += [q[:, 0, 0, :], q[:, 1, 1, :], q[:, 0, 1, :], q[:, 1, 0, :],
                 msi[cur:cur + 2 * half]]
        cur += 2 * half
    for k in sizes:
        t = tables[k]
        rows += [t[name] for name in _TABLES]
        # fused vectors for the EXIT/MOD pipeline with a = X^(k/2),
        # c = <Z0² mod a ≀ S> (fftree.rs:200-289)
        xnn, xnninv = t["xnn_s"], t["xnn_s_inv"]
        z0inv, z00 = t["z0_inv_s1"], t["z0z0_rem_xnn_s"]
        rows += [
            fd.neg(spec, fd.mul(spec, xnn[1::2], z0inv)),
            fd.neg(spec, fd.mul(spec, xnn[1::2], t["z1_inv_s0"])),
            fd.mul(spec, z00[0::2], xnninv[0::2]),
            fd.mul(spec, z0inv, z00[1::2]),
            fd.neg(spec, xnninv),
            fd.neg(spec, z0inv),
            fd.neg(spec, t["z1_inv_s0"]),
            fd.encode(spec, [k // 2], dev),
        ]
    rows.append(fd.neg(spec, tables[2]["leaves"]))
    return torch.cat(rows), off


# ------------------------------------------------------------- executor

_OPS = (OP_AFFINE, OP_AFFINE_C, OP_AFF1, OP_AFF1_C, OP_AFF1S, OP_AFF1S_C,
        OP_MUL, OP_CMPSEL)
_FROM_SCRATCH = (OP_AFFINE_C, OP_AFF1_C, OP_AFF1S_C)
_TWO = (OP_AFFINE, OP_AFFINE_C)
_PAIRED = (OP_AFF1S, OP_AFF1S_C, *_TWO)  # the opcodes with a pair form


def one_row(W: int, m: int, one_pos: int):
    """The state row that holds the constant 1, as the JAX package's
    ``to_state`` places it: pad row ``one_pos - m`` behind the m packed
    rows, which Python's indexing takes from the end where one_pos < m
    (the NTT's one_pos = m - 1 is row W - 1); None when the state has no
    pad rows or the index lies outside them (a scatter drops it there)."""
    pad, i = W - m, one_pos - m
    if not -pad <= i < pad:
        return None
    return m + i % pad


def to_state(batch, W: int, one_pos: int, out=None):
    """(B, m, L) batch → (W, L, B) state with a constant 1 at
    :func:`one_row`: a new tensor, or ``out`` (a graph's static state, of
    B or more lanes: the batch fills its low lanes, the others hold zeros
    and the 1) overwritten.

    ``batch`` may be a tuple of parts laid one after the other along the
    position axis (the general-modulus REDC/MOD pack [evals ‖ a ‖ c]): the
    first is the (B, m, L) batch, the others unbatched (rows, L) tables
    that every lane gets."""
    batch, *extras = batch if isinstance(batch, (tuple, list)) else (batch,)
    B, m, L = batch.shape
    x = batch.new_zeros((W, L, B)) if out is None else out.zero_()
    x[:m, :, :B] = batch.permute(1, 2, 0)
    for part in extras:
        x[m:m + part.shape[0]] = part.unsqueeze(-1)
        m += part.shape[0]
    row = one_row(W, m, one_pos)
    if row is not None:
        x[row, 0, :] = 1
    return x


def from_state(state, m: int, out_perm=None):
    """(W, L, B) state → (B, m, L): a view of the value lane, or with
    ``out_perm`` (an index tensor of m state rows) those rows."""
    rows = state[:m] if out_perm is None else state.index_select(0, out_perm)
    return rows.permute(2, 0, 1)


def lane_chunks(batch, chunk: int):
    """The payload of each run of at most ``chunk`` batch lanes, with its
    slice: the batch cut along its first axis, the unbatched extras of a
    tuple payload whole in every chunk."""
    first, *extras = batch if isinstance(batch, (tuple, list)) else (batch,)
    for c0 in range(0, first.shape[0], chunk):
        sl = slice(c0, c0 + chunk)
        yield sl, ((first[sl], *extras) if extras else first[sl])


def cmpsel(x, gather, start: int) -> None:
    """The OP_CMPSEL step on the window at ``start`` of the state ``x``,
    with ``gather(ci)`` the state's rows at index column ci:
    x[start+q] ← x[g1[q]] where x[a[q]] equals x[b[q]] on every row and
    limb of the lane, else x[g2[q]]. Every row of the window is compared
    (inactive rows have a = b = the row itself), and limbs are canonical,
    so equal limbs mean equal values. The bool per lane stays on the
    device; the compared windows are free before the other two are
    gathered."""
    comp = (gather(0) == gather(2)).all(dim=0).all(dim=0)  # (B,)
    x1 = gather(1)
    torch.where(comp, x1, gather(3), out=x[start:start + x1.shape[0]])


def _synth(cp, p):
    """One column's index row from its 16 formula scalars (host ints) at
    positions ``p`` (the mirror of ``_synth_jnp``; terms whose mask is
    zero, or an activity test the span already implies, are skipped)."""
    cp = [int(v) for v in cp]
    dflt = p if cp[CP_DK] == 0 else torch.full_like(p, cp[CP_DC])
    span = cp[CP_SPAN]
    if span <= 0:  # never active
        return dflt
    t = p - cp[CP_OFF]
    s2 = cp[CP_S2]
    u = t >> s2 if s2 >= 0 else t << -s2
    act = (t >= 0) & (t < span)
    if not (cp[CP_KM] == -1 and cp[CP_ALO] <= 0 and cp[CP_AHI] >= span):
        inb = t & cp[CP_KM]
        act &= (inb >= cp[CP_ALO]) & (inb < cp[CP_AHI])
    if cp[CP_C0] == cp[CP_C1]:
        v = torch.full_like(p, cp[CP_C0])
    else:
        v = torch.where(((t >> cp[CP_SB]) & 1) == 1, cp[CP_C1], cp[CP_C0])
    if cp[CP_M1]:
        v = v + (t & cp[CP_M1])
    if cp[CP_M2]:
        v = v + (u & cp[CP_M2])
    if cp[CP_M3]:
        v = v + (((u + cp[CP_DD]) ^ cp[CP_XX]) & cp[CP_M3])
    return torch.where(act, v, dflt)


def _d_engine(spec: FieldSpec, pool, dps, D, iD, op: int):
    """The running-diagonal coefficient engine for one step (the mirror of
    ``_run_segment_impl``'s engine): returns (CA, CB, D, iD) with CA/CB
    None where the opcode reads no scratch coefficient. Only what the
    step's DOP and opcode need is computed; every row product is a
    one-lane step-kernel launch (``step.mul_rows``)."""
    dop = int(dps[DP_DOP])
    scratch = op in _FROM_SCRATCH
    if dop == DOP_NONE and not scratch:
        return None, None, D, iD
    bsx = D.shape[0]
    P = pool.shape[0]
    r = torch.arange(bsx, device=D.device)
    bitv = ((r >> int(dps[DP_SHALF])) & 1) == 1
    io = r & int(dps[DP_HM])

    def plane(s0, s1):
        idx = torch.where(bitv, int(dps[s1]), int(dps[s0])) + io
        return pool.index_select(0, idx.clamp(0, P - 1))

    def mul(a, b):
        return step.mul_rows(spec, a, b)

    Ms, Msi = plane(DP_MS0, DP_MS1), plane(DP_MSI0, DP_MSI1)
    CA = CB = None
    if op == OP_AFFINE_C:
        CA = mul(Ms, D)
    if scratch:
        Mp = plane(DP_MP0, DP_MP1)
        Dp = D.index_select(0, (r ^ int(dps[DP_HALF])).clamp(0, bsx - 1))
        if dop == DOP_FINAL:
            CB = mul(Mp, Dp)
        elif dop == DOP_LEVEL0:
            CB = mul(Mp, Msi)
        else:  # DOP_LEVEL (and the reference's formula for DOP_NONE)
            CB = mul(mul(mul(Mp, Msi), Dp), iD)
    if dop == DOP_LEVEL0:
        D, iD = Ms, Msi
    elif dop == DOP_LEVEL:
        D, iD = mul(Ms, D), mul(Msi, iD)
    return CA, CB, D, iD


def col_row(sched: Schedule, bank, t: int, ci: int, p):
    """Index row of column ci of step t at window positions ``p``: its
    residual bank row, or its formula synthesised."""
    rid = sched.xs[4]
    if rid[t, ci] >= 0:
        return bank[int(rid[t, ci])]
    return _synth(sched.xs[2][t, ci], p)


def coeff_rows(pool, rows, scratch_rows, pad_row, bsx: int):
    """Coefficient rows at index ``rows``: from the pool, or (where the
    step reads the D-engine's scratch) from ``scratch_rows`` behind the
    passthrough row 0 (one for A, zero for B/C; emitters index
    coefficients at 1 + r)."""
    if scratch_rows is None:
        return pool.index_select(0, rows.clamp(0, pool.shape[0] - 1))
    tab = torch.cat([pad_row, scratch_rows])
    return tab.index_select(0, rows.clamp(0, bsx))


def check_opcode(op: int) -> None:
    if op not in _OPS:
        raise ValueError(f"unknown opcode {op}")


# the columns each opcode reads: (state columns, coefficient columns)
_READS = {OP_CMPSEL: ((0, 1, 2, 3), ()), OP_MUL: ((1, 3), ()),
          OP_AFFINE: ((1, 3), (0, 2)), OP_AFFINE_C: ((1, 3), (0, 2)),
          OP_AFF1: ((1, 3), (2,)), OP_AFF1_C: ((1, 3), (2,)),
          OP_AFF1S: ((3,), (2,)), OP_AFF1S_C: ((3,), (2,))}
_STATE, _POOL, _TABLE = range(3)  # where a kept index row points


class StepPlan:
    """What the scan executor's step loop reads besides the state, made
    once per schedule, pool and residual bank (so once per device) by
    :func:`step_plan`.

    ``steps``: per step (opcode, window start, columns), where column ci
    is (source, int32 index row) for each column the opcode reads (None
    for the others): the source is the state, the pool or ``table``, and
    ``source.index_select(0, row)`` gives the rows the step reads. The
    index rows are what the formulas or the residual bank give, clamped
    as the unplanned loop clamps them (:func:`col_row`); a never-active
    column (span ≤ 0) keeps no row of its own: it reads the window itself
    (a slice of ``window``, one kept ``arange`` of the state's rows) or a
    constant row that every column of that constant shares, and columns
    with one formula at one start share one row. ``table``: the pool's
    zero and one rows (a scratch column's pad rows), then those of the
    D-engine's product rows that some scratch column reads, each column's
    row pointing into it. ``pairs``: per step its partner distance h
    where the step is a pair step (:func:`pair_h`) and the field's
    kernels have the pair form (``ops.step.pair_form``), else 0.

    Made by running :func:`_synth` (through :func:`col_row`) and
    :func:`_d_engine` over the schedule once, in step order, so a step of
    the plan reads the values the unplanned loop computed at every call.
    ``nbytes``: the device bytes the plan holds (the pool, the tree's, not
    counted); ``kept``: whether its owner keeps it for later calls."""

    __slots__ = ("steps", "pairs", "pool", "table", "window", "nbytes",
                 "kept", "pins")

    def __init__(self, spec: FieldSpec, pool, sched: Schedule, bank,
                 kept: bool = False):
        ops_a, starts, colp, dp, rid, _ = sched.xs
        W, A, P = sched.W, sched.A, pool.shape[0]
        dev = pool.device
        q = torch.arange(A, device=dev)
        window = torch.arange(W, dtype=torch.int32, device=dev)
        bsx = max(sched.bs_max, 1)
        D = torch.zeros((bsx, spec.num_limbs), dtype=torch.int32,
                        device=dev)
        iD = torch.zeros_like(D)
        rows = {}  # (what, …, clamp) → an index row that columns share
        kept_rows, n_kept = [pool[0:1], pool[1:2]], 2

        def index(t, ci, start, p, hi):
            r = int(rid[t, ci])
            cp = [int(v) for v in colp[t, ci]]
            if r >= 0:
                key = ("bank", r, hi)
            elif cp[CP_SPAN] > 0:
                key = ("synth", tuple(cp), start, hi)
            elif cp[CP_DK]:
                key = ("const", min(max(cp[CP_DC], 0), hi))
            elif start + A - 1 <= hi:
                return window[start:start + A]
            else:
                key = ("window", start, hi)
            row = rows.get(key)
            if row is None:
                row = rows[key] = (col_row(sched, bank, t, ci, p)
                                   .clamp(0, hi).to(torch.int32))
            return row

        steps, pairs, paired = [], [], step.pair_form(spec)
        for t in range(ops_a.shape[0]):
            op = int(ops_a[t])
            check_opcode(op)
            start = int(starts[t])
            p = q + start
            CA, CB, D, iD = _d_engine(spec, pool, dp[t], D, iD, op)
            state_cols, coeff_cols = _READS[op]
            cols = [None] * 4
            for ci in state_cols:
                cols[ci] = (_STATE, index(t, ci, start, p, W - 1))
            for ci in coeff_cols:
                scratch = CA if ci == 0 else CB
                if scratch is None:
                    cols[ci] = (_POOL, index(t, ci, start, p, P - 1))
                    continue
                # coeff_rows' [pad row ‖ scratch] at rows clamped to bsx,
                # with the pad row (one for A, zero for B) at 1 or 0
                r = index(t, ci, start, p, bsx)
                used = torch.unique(r)
                used = used[used > 0]
                kept_rows.append(scratch.index_select(0, used - 1))
                at = torch.searchsorted(used, r) + n_kept
                cols[ci] = (_TABLE, torch.where(
                    r == 0, int(ci == 0), at).to(torch.int32))
                n_kept += used.shape[0]
            steps.append((op, start, tuple(cols)))
            pairs.append(pair_h(op, start, cols, q) if paired else 0)
        self.steps, self.pool, self.window = steps, pool, window
        self.pairs = pairs
        self.table = torch.cat(kept_rows)
        self.kept, self.pins = kept, (sched, pool, bank)
        held = {self.table.untyped_storage().data_ptr():
                self.table.untyped_storage().nbytes()}
        for _, _, cols in steps:
            for col in cols:
                if col is not None:
                    s = col[1].untyped_storage()
                    held[s.data_ptr()] = s.nbytes()
        self.nbytes = sum(held.values())


def pair_h(op: int, start: int, cols, q) -> int:
    """The partner distance h of a pair step, else 0: a self-read or
    two-product step whose x2 index row (the clamped row) reads, at every
    window position ``q``, row ``start + (q XOR h)`` or row ``start + q``,
    at least once the former, for one power of two h with the window's
    height a multiple of 2h, and whose x1 row, for a two-product step, is
    the window itself. Each pair of rows {q, q XOR h} is then read and
    written by that step alone."""
    if op not in _PAIRED:
        return 0
    d = (cols[3][1] - start) ^ q
    h = int(d.max())
    if h < 1 or h & (h - 1) or q.shape[0] % (2 * h) or \
            not bool(((d == 0) | (d == h)).all()):
        return 0
    if op in _TWO and not torch.equal(cols[1][1].long(), start + q):
        return 0
    return h


def step_plan(spec: FieldSpec, pool, sched: Schedule, bank,
              cache=None) -> StepPlan:
    """The :class:`StepPlan` of ``sched`` over ``pool`` and ``bank``: the
    one ``cache`` (the owner's ``graphs.GraphCache``) keeps, made there
    at its first use (span ``ecfft.plan``; before any warm-up or capture,
    so a graph records only the loop), or without a cache one for this
    call alone."""
    key = (id(sched), id(pool), id(bank))
    plan = None if cache is None else cache.plans.get(key)
    if plan is None:
        with profiling.span("ecfft.plan"):
            plan = StepPlan(spec, pool, sched, bank, kept=cache is not None)
        if cache is not None:
            cache.plans[key] = plan
    return plan


def _run_steps(spec: FieldSpec, plan: StepPlan, x):
    """Step the (W, L, B) state ``x`` through the plan's steps, in place:
    per step the gathers of the rows it reads and its step kernel; a pair
    step gathers its coefficient rows alone."""
    srcs = (x, plan.pool, plan.table)
    for (op, start, cols), h in zip(plan.steps, plan.pairs):
        def take(ci):
            src, row = cols[ci]
            return srcs[src].index_select(0, row)

        if h:
            if op in _TWO:
                step.aff2g_pair_ip(spec, take(0), take(2), x, h, start,
                                   cols[3][1])
            else:
                step.aff1s_pair_ip(spec, take(2), x, h, start, cols[3][1])
            continue
        if op == OP_CMPSEL:
            cmpsel(x, take, start)
            continue
        x2 = take(3)
        if op == OP_MUL:
            step.mulss(spec, take(1), x2, x, start)
        elif op in _TWO:
            step.aff2g_ip(spec, take(0), take(2), x, take(1), x2, start)
        elif op in (OP_AFF1, OP_AFF1_C):
            step.aff1g_ip(spec, take(2), x, take(1), x2, start)
        else:
            step.aff1s_ip(spec, take(2), x, x2, start)


_ALLOC_MARGIN = 256 << 20  # room for the caching allocator's fragmentation


def _chunk_bytes(sched: Schedule, L: int, B: int, m_out: int,
                 m_in: int = 0, planned: bool = True):
    """(per-lane bytes, fixed bytes) of running ``sched`` on a batch of B
    by either executor. Per lane: the int32 state (the extras of a tuple
    payload are rows of it) and two gathered windows, or the m_out rows an
    ``out_perm`` gathers once the windows are free, or the m_in packed rows
    a Montgomery conversion copies, whichever is larger; an
    OP_CMPSEL step frees its two compared windows before it gathers the two
    it selects from, and its (A, L, B) bool is covered by the margin.
    Fixed: the whole (B, m_out, L) output, the two coefficient windows of
    a step, and a margin for the allocator. A loop that reads a
    :class:`StepPlan` (``planned``, the scan executor's) makes no other
    temporaries: the plan is made before the budget is read, so its bytes
    are allocated, held, and out of what the budget finds free. The
    unrolled loop makes its index rows and D-engine rows at every call:
    for it the fixed part also counts two more coefficient windows, int64
    index rows and the D-engine's planes and row products. On a card the
    state is a graph's static buffer and the step temporaries live in the
    graphs' pool, both held after the call: the same bytes, counted by
    :func:`_lanes_per_chunk` as taken once held."""
    per_lane = (sched.W + max(2 * sched.A, m_out, m_in)) * L * 4
    fixed = B * m_out * L * 4 + 2 * sched.A * L * 4 + _ALLOC_MARGIN
    if not planned:
        bsx = max(sched.bs_max, 1)
        fixed += 2 * sched.A * L * 4 + 32 * sched.A * 8 + 16 * bsx * L * 4
    return per_lane, fixed


def _lanes_per_chunk(sched: Schedule, L: int, B: int, m_out: int,
                     device, m_in: int = 0, planned: bool = True) -> int:
    """Batch lanes that fit on the card at once (see :func:`_chunk_bytes`),
    budgeted from what the card and the caching allocator hold free; the
    graphs' pool (``graphs.pool_bytes``) is reserved but free to no other
    allocation, and the graphs' static states are allocated. On the CPU
    the batch runs whole."""
    if device.type != "cuda":
        return B
    free, _ = torch.cuda.mem_get_info(device)
    free += (torch.cuda.memory_reserved(device)
             - torch.cuda.memory_allocated(device)
             - graphs.pool_bytes(device))
    per_lane, fixed = _chunk_bytes(sched, L, B, m_out, m_in, planned)
    lanes = (free - fixed) // per_lane
    if lanes < 1:
        raise SizeError(
            f"one lane of a (W={sched.W}, L={L}) state with its window "
            f"temps needs {per_lane / 1e9:.2f} GB beside "
            f"{fixed / 1e9:.2f} GB of output and step temporaries; "
            f"{free / 1e9:.2f} GB free")
    return min(B, int(lanes))


def unrolled_selected() -> bool:
    """Whether ``ECFFT_EXECUTOR=unrolled`` picks the unrolled executor."""
    return os.environ.get("ECFFT_EXECUTOR") == "unrolled"


def schedule_entry(sched: Schedule, device) -> list:
    """[schedule, residual bank as int64 on ``device``, None]: a schedule
    as trees and plans keep it; :func:`with_analysis` fills the last slot."""
    return [sched, torch.from_numpy(sched.xs[5]).to(device, torch.int64),
            None]


def with_analysis(entry: list) -> list:
    """``entry`` with the unrolled executor's fusion analysis of its
    schedule, made at first use where that executor is selected."""
    if entry[2] is None and unrolled_selected():
        from ecfft_tpu_torch.ops.unrolled import _SchedMeta

        entry[2] = _SchedMeta(entry[0])
    return entry


def run_schedule(spec: FieldSpec, pool, sched: Schedule, bank, batch,
                 one_pos: int, m_out: int, meta=None, cache=None):
    """Execute a schedule: (B, m, L) int32 ``batch`` → (B, m_out, L), the
    first m_out rows of the final state or the rows ``sched.out_perm``
    names. ``batch`` may be a tuple (batch, *extras) with unbatched
    (rows, L) extras (see :func:`to_state`).

    ``pool``: (P, L) int32 on the batch's device; ``bank``: the
    schedule's residual row bank as an int64 tensor on that device;
    ``cache``: the ``graphs.GraphCache`` that keeps the step loop's
    graphs on a card (trees and plans keep one beside their schedules;
    None: the eager loop, since no graph would outlive the call).

    Dispatch, as in the JAX package: this scan executor is the default;
    ``ECFFT_EXECUTOR=unrolled`` hands the schedule to
    ``ops.unrolled.run_unrolled`` with ``meta``, its fusion analysis of
    ``sched`` (made there when None)."""
    if unrolled_selected():
        from ecfft_tpu_torch.ops.unrolled import run_unrolled

        return run_unrolled(spec, pool, sched, bank, batch, one_pos, m_out,
                            meta, cache=cache)
    plan = step_plan(spec, pool, sched, bank, cache)
    return run_chunks(
        spec, sched, batch, one_pos, m_out,
        lambda x: _run_steps(spec, plan, x), cache,
        ("scan",), (plan,), plan)


def _redc_rows(spec: FieldSpec, x, m: int, src, factor: int) -> None:
    """x[:m] ← factor·src·R⁻¹ mod p for (m, L, B) rows ``src`` in a buffer
    of their own: the self-read step with coefficient rows ``factor`` on
    zeroed rows. Factor R² mod p turns canonical values into Montgomery
    form, factor 1 turns them back."""
    C = fd.encode(spec, factor, x.device).expand(m, spec.num_limbs)
    x[:m].zero_()
    step.aff1s_ip(spec, C.contiguous(), x, src, 0)


@contextlib.contextmanager
def _converting(call, name: str, rows: int, lanes: int, converts: list):
    """The span ``name`` of a Montgomery conversion of ``rows`` state rows
    in ``lanes`` lanes. Where a call record ``call`` is open, with an
    event before and after, and the conversion noted in ``converts`` with
    the ``aff1s_ip`` launches its wrapper counted."""
    if call is None:
        with profiling.span(name):
            yield
        return
    before = step.aff1s_ip.launches.total()
    call.mark()
    with profiling.span(name):
        yield
    call.mark()
    k = len(call.marks)
    converts.append(profiling.Convert(
        name, rows, lanes, step.aff1s_ip.launches.total() - before,
        (k - 2, k - 1)))


def _chunk_loop(call, x, lanes: int, run_steps, cache, key, pins,
                plan=None, converts=()) -> None:
    """Run a chunk's step loop on its state ``x`` in place: the replay of
    its graph under ``key`` in ``cache`` (or the warm-up and the capture),
    or without a key the eager loop (span ``ecfft.steps``). Where a call
    record ``call`` is open, with an event before and after, and the chunk
    noted in it, with whether the loop read a kept :class:`StepPlan`
    (``plan``) and its bytes, its Montgomery ``converts``, and its step
    launches' shapes with those of the pair form apart."""
    if call is not None:
        call.mark()
    if key is not None:
        rec = cache.run(key, x, run_steps, pins)
        how = "replay" if rec.replays else "capture"
        graph, shapes = weakref.ref(rec), rec.shapes
    else:
        before = graphs._counts_now() if call is not None else None
        with profiling.span("ecfft.steps"):
            run_steps(x)
        how, graph = "steps", None
        shapes = None if call is None else graphs._added(before)[1]
    if call is not None:
        call.mark()
        kept = plan is not None and plan.kept
        pairs = [(w, c) for w, c in shapes if w in step.PAIR_WRAPPERS]
        if pairs:
            shapes = [(w, c) for w, c in shapes
                      if w not in step.PAIR_WRAPPERS]
        call.chunks.append(profiling.Chunk(
            lanes, x.shape[2], how, graph, shapes, kept,
            plan.nbytes if kept else 0, converts, pairs))


def run_chunks(spec: FieldSpec, sched: Schedule, batch, one_pos: int,
               m_out: int, run_steps, cache=None, executor: tuple = ("scan",),
               pins: tuple = (), plan: StepPlan | None = None):
    """Pack, run (``run_steps(state)``, in place) and unpack ``batch`` in
    as many lane chunks as the device's memory asks for. With Montgomery
    residents (:func:`fields.device.is_mont`) the packed rows go into
    Montgomery form after the pack, the constant 1 at ``one_pos`` (a row
    past them) becomes R mod p, and the output rows leave it before the
    unpack: the bits of the JAX package's state, which converts the whole
    state (its other rows are zero, and 0·R = 0). The 1 sits at
    :func:`one_row`, a pad row behind the packed ones. The open call
    record notes each conversion's rows, lanes and launches in the
    chunk's entry, with an event before and after it.

    On a card, given a ``cache`` (``graphs.GraphCache``), the step loop
    of each chunk is a replay of its graph there (captured at the key's
    first call), keyed by the schedule, ``executor`` (its name and
    parameters), what the loop reads besides (``pins``), the chunk's
    lanes rounded up to a power of two (``graphs.bucket``) and the device;
    the chunk is packed into the low lanes of the graph's static state
    and its output copied out. ``run_steps`` is the loop the graph
    records; without a cache it runs eagerly. Each chunk's phases are
    spans (``utils.profiling``), and the chunk is noted in the open call
    record. ``plan``: the :class:`StepPlan` that ``run_steps`` reads (made
    before the budget, which then finds its bytes held); None for a loop
    that makes its own step temporaries."""
    first, *extras = batch if isinstance(batch, (tuple, list)) else (batch,)
    B, _, L = first.shape
    dev = first.device
    m_in = first.shape[1] + sum(e.shape[0] for e in extras)
    out = first.new_empty((B, m_out, L))
    perm = (None if sched.out_perm is None else
            torch.from_numpy(sched.out_perm).to(dev, torch.int64))
    mont = fd.is_mont(spec)

    def budget(lanes):
        return _lanes_per_chunk(sched, L, lanes, m_out, dev,
                                m_in if mont else 0, plan is not None)

    replay = cache is not None and graphs.replays(first)
    if replay:
        pins = (sched, *pins)
        loop = graphs.loop_key(executor, pins)
        chunk = cache.lanes(loop, B, dev, budget)
    else:
        chunk = budget(B)
    call = profiling.current()
    for sl, part in lane_chunks(batch, chunk):
        with profiling.span("ecfft.chunk"):
            x, key, lanes = None, None, first[sl].shape[0]
            with profiling.span("ecfft.pack"):
                if replay:
                    key = (loop, graphs.bucket(lanes), dev)
                    x = cache.state(key, sched.W, L)
                x = to_state(part, sched.W, one_pos, x)
            converts = [] if mont else ()
            if mont:
                with _converting(call, "ecfft.to_mont", m_in, x.shape[2],
                                 converts):
                    _redc_rows(spec, x, m_in, x[:m_in].clone(),
                               spec.r2_mod_p)
                    row = one_row(sched.W, m_in, one_pos)
                    if row is not None:
                        x[row] = fd.encode(spec, spec.r_mod_p,
                                           x.device)[:, None]
            _chunk_loop(call, x, lanes, run_steps, cache, key, pins, plan,
                        converts)
            if mont:
                with _converting(call, "ecfft.from_mont", m_out, x.shape[2],
                                 converts):
                    src = (x[:m_out].clone() if perm is None
                           else x.index_select(0, perm))
                    _redc_rows(spec, x, m_out, src, 1)
                    del src
            with profiling.span("ecfft.unpack"):
                out[sl] = from_state(x, m_out, None if mont else perm)[:lanes]
    return out
