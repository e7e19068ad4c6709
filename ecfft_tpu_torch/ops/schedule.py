"""The schedule machine's pool and executor, in PyTorch.

The port's counterpart of the device half of ``ecfft_tpu/ops/schedule.py``
(the numpy half is ``ops/emit.py``):

- :func:`build_pool` concatenates every table row a schedule references
  into one (P, L) int32 tensor, with the same rows and offsets as the JAX
  package's ``build_pool`` (tested);
- :func:`run_schedule` runs a schedule over a (B, m, L) batch: it packs
  the (W, L, B) state, steps through the schedule, and unpacks.

The executor is a Python loop over the steps. Each step's opcode, window
start, formula scalars and D-engine parameters come from the schedule's
host numpy arrays, so no step waits for the device. Per step it
synthesises the index rows in torch (a mirror of ``_synth_jnp``, or a
residual bank row), gathers x1/x2 with ``index_select`` into buffers of
their own, runs the running-diagonal coefficient engine for the branch
the step's DOP needs, and hands the window to one of the three in-place
step wrappers of ``ops/step.py``. Every index is clamped as ``jnp.clip``
clamps it in the reference (``index_select`` would raise where
``jnp.take`` clips).

Left out, as plumbing for the TPU: the step-row envelope segmentation,
the run-split/``lax.switch`` choice with buffer donation, ``lax.map``
chunking inside segments and the TPU tile-padding preflight. Batch
chunking stays, budgeted from ``torch.cuda.mem_get_info``.
"""

from __future__ import annotations

import numpy as np
import torch

from ecfft_tpu_torch.errors import SizeError
from ecfft_tpu_torch.fields import device as fd
from ecfft_tpu_torch.fields.registry import FieldSpec
from ecfft_tpu_torch.native import batch_inv_limbs
from ecfft_tpu_torch.ops import step
from ecfft_tpu_torch.ops.emit import (
    CP_ALO, CP_AHI, CP_C0, CP_C1, CP_DC, CP_DD, CP_DK, CP_KM, CP_M1, CP_M2,
    CP_M3, CP_OFF, CP_S2, CP_SB, CP_SPAN, CP_XX, DOP_FINAL, DOP_LEVEL,
    DOP_LEVEL0, DOP_NONE, DP_DOP, DP_HALF, DP_HM, DP_MP0, DP_MP1, DP_MS0,
    DP_MS1, DP_MSI0, DP_MSI1, DP_SHALF, OP_AFF1, OP_AFF1_C, OP_AFF1S,
    OP_AFF1S_C, OP_AFFINE, OP_AFFINE_C, Schedule, _ilog2)

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
    is zero (the emitters then use exact 2-mul butterflies)."""
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

_OPS = (OP_AFFINE, OP_AFFINE_C, OP_AFF1, OP_AFF1_C, OP_AFF1S, OP_AFF1S_C)
_FROM_SCRATCH = (OP_AFFINE_C, OP_AFF1_C, OP_AFF1S_C)


def to_state(batch, W: int, one_pos: int):
    """(B, m, L) batch → (W, L, B) state with a constant 1 at one_pos."""
    B, m, L = batch.shape
    x = batch.new_zeros((W, L, B))
    x[:m] = batch.permute(1, 2, 0)
    if W > m:
        x[one_pos, 0, :] = 1
    return x


def from_state(state, m: int):
    """(W, L, B) state → (B, m, L) view of the value lane."""
    return state[:m].permute(2, 0, 1)


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


def _run_steps(spec: FieldSpec, pool, sched: Schedule, bank, x):
    """Step the (W, L, B) state ``x`` through the schedule, in place."""
    ops_a, starts, colp, dp, rid, _ = sched.xs
    W, A = sched.W, sched.A
    P = pool.shape[0]
    dev = x.device
    q = torch.arange(A, device=dev)
    bsx = max(sched.bs_max, 1)
    D = torch.zeros((bsx, spec.num_limbs), dtype=torch.int32, device=dev)
    iD = torch.zeros_like(D)
    one_row, zero_row = pool[1:2], pool[0:1]
    for t in range(ops_a.shape[0]):
        op = int(ops_a[t])
        if op not in _OPS:
            raise NotImplementedError(
                f"opcode {op} (OP_MUL / OP_CMPSEL) is not on the ENTER/EXIT "
                "path and not ported yet (ROADMAP.md, Queue 1)")
        start = int(starts[t])
        p = q + start

        def col(ci):
            if rid[t, ci] >= 0:
                return bank[int(rid[t, ci])]
            return _synth(colp[t, ci], p)

        def gather(ci):
            return x.index_select(0, col(ci).clamp(0, W - 1))

        def coeffs(ci, scratch_rows, pad_row):
            if scratch_rows is None:
                return pool.index_select(0, col(ci).clamp(0, P - 1))
            # scratch row 0 is the passthrough constant: one for A,
            # zero for B/C; emitters index coefficients at 1 + r
            tab = torch.cat([pad_row, scratch_rows])
            return tab.index_select(0, col(ci).clamp(0, bsx))

        x2 = gather(3)
        CA, CB, D, iD = _d_engine(spec, pool, dp[t], D, iD, op)
        if op in (OP_AFFINE, OP_AFFINE_C):
            step.aff2g_ip(spec, coeffs(0, CA, one_row),
                          coeffs(2, CB, zero_row), x, gather(1), x2, start)
        elif op in (OP_AFF1, OP_AFF1_C):
            step.aff1g_ip(spec, coeffs(2, CB, zero_row), x, gather(1), x2,
                          start)
        else:
            step.aff1s_ip(spec, coeffs(2, CB, zero_row), x, x2, start)


_ALLOC_MARGIN = 256 << 20  # room for the caching allocator's fragmentation


def _chunk_bytes(sched: Schedule, L: int, B: int, m_out: int):
    """(per-lane bytes, fixed bytes) of running ``sched`` on a batch of B.
    Per lane: the int32 state and the two gather temps. Fixed: the whole
    (B, m_out, L) output, and the per-step temporaries that do not grow
    with the batch (coefficient rows, int64 index rows, the D-engine's
    planes and row products), with a margin for the allocator."""
    bsx = max(sched.bs_max, 1)
    per_lane = (sched.W + 2 * sched.A) * L * 4
    fixed = (B * m_out * L * 4 + 4 * sched.A * L * 4 + 32 * sched.A * 8
             + 16 * bsx * L * 4 + _ALLOC_MARGIN)
    return per_lane, fixed


def _lanes_per_chunk(sched: Schedule, L: int, B: int, m_out: int,
                     device) -> int:
    """Batch lanes that fit on the card at once (see :func:`_chunk_bytes`),
    budgeted from what the card and the caching allocator hold free. On
    the CPU the batch runs whole."""
    if device.type != "cuda":
        return B
    free, _ = torch.cuda.mem_get_info(device)
    free += (torch.cuda.memory_reserved(device)
             - torch.cuda.memory_allocated(device))
    per_lane, fixed = _chunk_bytes(sched, L, B, m_out)
    lanes = (free - fixed) // per_lane
    if lanes < 1:
        raise SizeError(
            f"one lane of a (W={sched.W}, L={L}) state with its gather "
            f"temps needs {per_lane / 1e9:.2f} GB beside "
            f"{fixed / 1e9:.2f} GB of output and step temporaries; "
            f"{free / 1e9:.2f} GB free")
    return min(B, int(lanes))


def run_schedule(spec: FieldSpec, pool, sched: Schedule, bank, batch,
                 one_pos: int, m_out: int):
    """Execute a schedule: (B, m, L) int32 ``batch`` → (B, m_out, L).

    ``pool``: (P, L) int32 on the batch's device; ``bank``: the
    schedule's residual row bank as an int64 tensor on that device."""
    B, _, L = batch.shape
    out = batch.new_empty((B, m_out, L))
    chunk = _lanes_per_chunk(sched, L, B, m_out, batch.device)
    for c0 in range(0, B, chunk):
        x = to_state(batch[c0:c0 + chunk], sched.W, one_pos)
        _run_steps(spec, pool, sched, bank, x)
        out[c0:c0 + chunk] = from_state(x, m_out)
    return out
