"""The schedules of the eight FFTree algorithms as data, in numpy.

A jax-free copy of the numpy half of ``ecfft_tpu/ops/schedule.py``: the
opcode and formula-slot constants, :class:`Schedule`, the builder that
verifies each step's closed-form index formula against the emitted row,
the EXTEND butterfly emitter and the emitters of ENTER, EXIT, EXTEND and
MEXTEND, REDC and MOD (by the tree's own X^(k/2) and by a modulus given
at run time), DEGREE and VANISH. The emitters take the pool offsets dict
(``ops.schedule.build_pool``) where the original takes a tree, and the
general-modulus one the field's prime beside it; their arrays equal the
original's (tested).

Each step of a schedule computes, on a window [start, start + A) of the
(W, L, B) state,

    out[p] = A[p] · x[g1[p]]  +  B[p] · x[g2[p]]

(or its 1-mul forms), with the four index rows a, g1, b, g2 synthesised
at run time from 16 scalars per column (see ``_synth_np``) and the
butterfly coefficients computed by the running-diagonal engine from the
DP_* micro-op parameters. Two more step kinds read no coefficient:
OP_MUL, out[p] = x[g1[p]] · x[g2[p]], and OP_CMPSEL, which selects
x[g1[p]] or x[g2[p]] per batch lane by whether x[a[p]] = x[b[p]] on every
row of the window. The executor is ``ops.schedule.run_schedule``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

S0 = 0
S1 = 1


def _ilog2(n: int) -> int:
    return n.bit_length() - 1


ZERO = 0  # pool row of zeros
ONE = 1   # pool row of one

OP_AFFINE = 0
OP_MUL = 1
OP_CMPSEL = 2
OP_AFF1 = 3    # out[p] = x[g1[p]] + pool[b[p]]·x[g2[p]] — 1-mul step
OP_AFF1S = 4   # same, but x1 = the window slice itself (g1 ≡ identity)
OP_AFF1S_C = 5  # OP_AFF1S with C from the in-scan coefficient scratch
OP_AFF1_C = 6   # OP_AFF1 with C from the scratch
OP_AFFINE_C = 7  # OP_AFFINE with (A, B) from the scratch

# universal column-formula parameter slots (16 int32 per column)
(CP_OFF, CP_SPAN, CP_KM, CP_ALO, CP_AHI, CP_SB, CP_C0, CP_C1, CP_M1,
 CP_S2, CP_M2, CP_DD, CP_XX, CP_M3, CP_DK, CP_DC) = range(16)
NCP = 16

# running-diagonal (D-engine) step parameter slots
(DP_DOP, DP_SHALF, DP_HM, DP_HALF, DP_MS0, DP_MS1, DP_MP0, DP_MP1,
 DP_MSI0, DP_MSI1) = range(10)
NDP = 10
DOP_NONE = 0
DOP_LEVEL = 1   # C = ratio·D[perm]·invD;  D ← Ms·D,  invD ← Msi·invD
DOP_LEVEL0 = 2  # first level of an extend: C = ratio; D ← Ms, invD ← Msi
DOP_FINAL = 3   # A = Ms·D, B = Mp·D[perm] (the unscaling 2-mul level)

COLS = ("a", "g1", "b", "g2")


class Schedule(NamedTuple):
    """A compiled-to-data transform.

    ``W``: full state width (python int). ``A``: per-step window
    width — each step computes only rows [start, start+A) and writes
    them in place. ``bs_max``: D-engine
    scratch rows (0 = no in-scan coefficients, e.g. the NTT). ``xs`` =
    (op, start, colp, dp, rid, bank): per-step opcode and window start
    (steps,), per-column formula parameters (steps, 4, 16), D-engine
    parameters (steps, 10), residual bank row ids (steps, 4; −1 = use
    the formula), and the shared residual row bank (rows, A).
    ``out_perm`` optionally maps output rows to state rows post-scan."""

    W: int
    A: int
    bs_max: int
    xs: tuple
    out_perm: np.ndarray | None = None


def _synth_np(cp, W: int) -> np.ndarray:
    """Numpy mirror of the in-scan column-formula synthesis, over the
    FULL state width (used to verify hints against emitted rows)."""
    p = np.arange(W, dtype=np.int64)
    t = p - int(cp[CP_OFF])
    s2 = int(cp[CP_S2])
    u = (t >> s2) if s2 >= 0 else (t << -s2)
    inb = t & int(cp[CP_KM])
    act = ((t >= 0) & (t < int(cp[CP_SPAN]))
           & (inb >= int(cp[CP_ALO])) & (inb < int(cp[CP_AHI])))
    sel = np.where((t >> int(cp[CP_SB])) & 1 == 1,
                   int(cp[CP_C1]), int(cp[CP_C0]))
    v = (sel + (t & int(cp[CP_M1])) + (u & int(cp[CP_M2]))
         + (((u + int(cp[CP_DD])) ^ int(cp[CP_XX])) & int(cp[CP_M3])))
    dflt = p if int(cp[CP_DK]) == 0 else np.full(W, int(cp[CP_DC]),
                                                 np.int64)
    return np.where(act, v, dflt).astype(np.int32)


def _P(off=0, span=0, km=-1, alo=0, ahi=None, sb=31, c0=0, c1=0, m1=0,
       s2=0, m2=0, dd=0, xx=0, m3=0, dk=0, dc=0) -> np.ndarray:
    """Build a 16-slot formula parameter row (see module docstring).
    ``ahi`` defaults to ``span`` (plain contiguous activity range)."""
    if ahi is None:
        ahi = span
    return np.asarray([off, span, km, alo, ahi, sb, c0, c1, m1, s2, m2,
                       dd, xx, m3, dk, dc], dtype=np.int32)


class _StepRef:
    """One schedule step under construction: four full-width numpy index
    rows (the emitters' ground truth) plus an optional formula hint per
    column and the D-engine parameters. ``hints[c]`` is a 16-slot param
    row (see _P); at finalize the builder verifies the formula
    reproduces the emitted row EXACTLY and then discards the row."""

    __slots__ = ("op", "rows", "hints", "dp", "_dflts")

    def __init__(self, op: int, rows, dflts):
        self.op = op
        self.rows = rows  # [a, g1, b, g2] full-width int32
        # default hint: all-inactive formula with the opcode's default
        self.hints = [None, None, None, None]
        self.dp = np.zeros(NDP, dtype=np.int32)
        self._dflts = dflts


class _Builder:
    """Accumulates schedule steps; default row is a passthrough.

    Width is rounded up to a multiple of 128 (the reference layout the
    schedules are held equal to); the pad rows stay passthrough forever.

    ``one_pos`` (required for OP_MUL steps) is the state position holding
    the constant 1: a mul step's passthrough form is x[p]·x[one_pos].

    Each ``new_*_step`` call finalizes the previous step: hinted columns
    are verified against their emitted rows and compressed to 16 scalars;
    unhinted non-default columns go to the residual row bank. Memory
    during build is O(W) regardless of step count."""

    def __init__(self, W: int, one_pos: int | None = None):
        self._orig_w = W
        self.W = (W + 127) & ~127
        self.one_pos = one_pos
        self.bs_max = 0
        self._cur: _StepRef | None = None
        self._fin: list = []       # (op, lo, hi, colinfo[4], dp)
        self._bank_rows: list = []  # full-width rows, sliced at arrays()
        self._iota = np.arange(self.W, dtype=np.int32)

    # -- step constructors (return the 4 row views for compatibility) --

    def _begin(self, op: int, dflts) -> tuple:
        self._finalize()
        W = self.W
        rows = []
        for dk, dc in dflts:
            rows.append(self._iota.copy() if dk == 0
                        else np.full(W, dc, np.int32))
        self._cur = _StepRef(op, rows, dflts)
        return tuple(rows)

    def new_step(self, csrc: bool = False):
        """2-mul affine step. With ``csrc`` the coefficients come from
        the in-scan scratch (row 0 = passthrough one/zero constants)."""
        if csrc:
            return self._begin(OP_AFFINE_C,
                               ((1, 0), (0, 0), (1, 0), (0, 0)))
        return self._begin(OP_AFFINE, ((1, ONE), (0, 0), (1, ZERO), (0, 0)))

    def new_mul_step(self):
        """out[p] = x[g1[p]]·x[g2[p]]; defaults to x[p]·1."""
        assert self.one_pos is not None, "mul steps need one_pos"
        return self._begin(OP_MUL,
                           ((1, 0), (0, 0), (1, 0), (1, self.one_pos)))

    def new_aff1_step(self, self_read: bool = False, csrc: bool = False):
        """out[p] = x[g1[p]] + C·x[g2[p]] — the 1-mul step. With
        ``self_read`` the runtime reads x1 as the window slice itself
        and g1 is ignored. With ``csrc``, C comes from the in-scan
        scratch instead of the pool."""
        if csrc:
            op = OP_AFF1S_C if self_read else OP_AFF1_C
            return self._begin(op, ((1, 0), (0, 0), (1, 0), (0, 0)))
        op = OP_AFF1S if self_read else OP_AFF1
        return self._begin(op, ((1, 0), (0, 0), (1, ZERO), (0, 0)))

    def new_cmpsel_step(self):
        """comp = ∀p x[a[p]] == x[b[p]] (per batch lane);
        out[p] = comp ? x[g1[p]] : x[g2[p]]."""
        return self._begin(OP_CMPSEL, ((0, 0), (0, 0), (0, 0), (0, 0)))

    @property
    def zero_pos(self) -> int:
        """A state row that is zero forever: the last pad row (state
        widths are odd pre-padding, so at least one pad row exists).
        Lets pure-scale steps ride OP_AFF1: out = x[zero] + C·x[g2]."""
        assert self.W > self._orig_w, "no pad row available"
        return self.W - 1

    # -- hints ---------------------------------------------------------

    def hint(self, col: str, **kw):
        """Attach the closed-form index formula for ``col`` of the
        current step (see _P for parameters). The step's default
        (dk, dc) is filled in automatically unless overridden."""
        ci = COLS.index(col)
        dk, dc = self._cur._dflts[ci]
        kw.setdefault("dk", dk)
        kw.setdefault("dc", dc)
        self._cur.hints[ci] = _P(**kw)

    def dop(self, dop: int, shalf: int, hm: int, half: int, ms0: int,
            ms1: int, mp0: int, mp1: int, msi0: int, msi1: int):
        """Set the current step's D-engine micro-op (see DP_* slots)."""
        self._cur.dp[:] = (dop, shalf, hm, half, ms0, ms1, mp0, mp1,
                           msi0, msi1)

    def track_bs(self, bs: int):
        self.bs_max = max(self.bs_max, bs)

    # -- finalize / assemble -------------------------------------------

    def _finalize(self):
        cur = self._cur
        if cur is None:
            return
        self._cur = None
        W = self.W
        colinfo = []  # per column: ("p", params) | ("bank", bank_id)
        lo, hi = W, 0
        for ci in range(4):
            row = cur.rows[ci]
            hint = cur.hints[ci]
            dk, dc = cur._dflts[ci]
            if hint is not None:
                synth = _synth_np(hint, W)
                if not np.array_equal(synth, row):
                    bad = np.nonzero(synth != row)[0]
                    raise AssertionError(
                        f"schedule hint mismatch: op={cur.op} col="
                        f"{COLS[ci]} first bad p={bad[0]} "
                        f"(formula {synth[bad[0]]} != row {row[bad[0]]}; "
                        f"{bad.size} rows differ)")
                colinfo.append(("p", hint))
                span = int(hint[CP_SPAN])
                if span > 0:
                    lo = min(lo, int(hint[CP_OFF]))
                    hi = max(hi, int(hint[CP_OFF]) + span)
                continue
            base = (self._iota if dk == 0
                    else np.full(W, dc, np.int32))
            diff = np.nonzero(row != base)[0]
            if diff.size == 0:
                colinfo.append(("p", _P(dk=dk, dc=dc)))
                continue
            self._bank_rows.append(row)
            colinfo.append(("bank", len(self._bank_rows) - 1))
            lo = min(lo, int(diff[0]))
            hi = max(hi, int(diff[-1]) + 1)
        if hi <= lo:  # fully-passthrough step
            lo, hi = 0, 1
        self._fin.append((cur.op, lo, hi, colinfo, cur.dp))

    def arrays(self) -> Schedule:
        """Assemble the finalized steps into a Schedule. The window
        width A is the max active span over steps, padded to the 128-row
        position tile; residual bank rows are sliced to their step's
        window."""
        self._finalize()
        W = self.W
        steps = self._fin
        # starts are 128-aligned (the reference's fused butterfly kernels
        # need tile-aligned windows), so A must absorb each
        # step's alignment slack: A >= hi - (lo & ~127) guarantees
        # [start, start + A) covers [lo, hi) for start = min(lo & ~127,
        # W - A) (W - A is itself 128-aligned since both are multiples)
        A = max(hi - (lo & ~127) for _, lo, hi, _, _ in steps)
        A = min(W, (A + 127) & ~127)
        ops = np.asarray([s[0] for s in steps], np.int32)
        starts = np.asarray(
            [min(lo & ~127, W - A) for _, lo, _, _, _ in steps], np.int32)
        for t, (_, lo, hi, _, _) in enumerate(steps):
            assert starts[t] <= lo and starts[t] + A >= hi, (t, lo, hi)
        colp = np.zeros((len(steps), 4, NCP), np.int32)
        rid = np.full((len(steps), 4), -1, np.int32)
        dp = np.stack([s[4] for s in steps])
        bank = []
        for t, (op, lo, hi, colinfo, _) in enumerate(steps):
            start = int(starts[t])
            for ci, (kind, val) in enumerate(colinfo):
                if kind == "p":
                    colp[t, ci] = val
                else:
                    row = self._bank_rows[val][start:start + A]
                    bank.append(np.ascontiguousarray(row))
                    rid[t, ci] = len(bank) - 1
        bank = (np.stack(bank) if bank
                else np.zeros((1, A), np.int32))
        xs = (ops, starts, colp, dp, rid, bank)
        return Schedule(W, A, self.bs_max, xs)


def _mesh(nb: int, bs: int):
    J, I = np.meshgrid(np.arange(nb), np.arange(bs), indexing="ij")
    return J.ravel(), I.ravel()


def _emit_extend(bld, off, k: int, moiety: int, dst, nblocks: int,
                 src=None):
    """Butterfly steps of EXTEND over tree size k on a block region.

    ``dst`` = (base, stride): the m/2-point inputs of block j live at
    positions base + j·stride + i, i < k/2 (stride ≥ k/2; EXIT uses
    stride-k gapped regions). ``src`` = (base, stride, iscale_log): the
    first down-level reads inputs from base + j·stride + (i << iscale),
    folding lane-to-lane copies into the butterfly (multi-block sources
    must share the destination stride; strided single-block sources like
    DEGREE's even-eval subsample use iscale). Blocks share coefficients.

    SCALED EMISSION (default): every level but the last is the 1-mul
    form out[p] = x[p] + C·x[p^half] with C computed by the in-scan
    running-diagonal engine (DOP_LEVEL0/LEVEL micro-ops on each step);
    the last recombine level applies the accumulated diagonal with a
    2-mul OP_AFFINE_C (DOP_FINAL), so the extend's outputs are exactly
    the reference's (fftree.rs:72-120) at ~55% of the multiply work.
    When the pool flags ``unscaled`` (some Lemma-3.2 diagonal is zero),
    every level runs as an exact 2-mul OP_AFFINE with coefficients
    gathered straight from the compact matrix planes.
    """
    bs = k // 2
    if bs == 1:
        return  # size-1 extend is the identity (fftree.rs:74-76)
    logm = _ilog2(bs)
    R0, dstr = dst
    span = (nblocks - 1) * dstr + bs
    act = dict(off=R0, span=span, km=dstr - 1, alo=0, ahi=bs)
    if src is not None:
        S0b, sstr, isl = src
        assert nblocks == 1 or (sstr == dstr and isl == 0), \
            "multi-block sources must share the destination stride"
    unscaled = off.get("unscaled", False)
    pdec = 0 if moiety == S0 else 1
    prec = 2 if moiety == S0 else 3
    levels = [(pdec, d, False) for d in range(logm)]
    levels += [(prec, d, d == 0) for d in reversed(range(logm))]
    bld.track_bs(bs)
    J, I = _mesh(nblocks, bs)
    P = R0 + J * dstr + I

    def hint_partner(col, half, from_src: bool):
        if not from_src:
            bld.hint(col, **act, c0=R0, xx=half, m3=-1)
        elif nblocks > 1 or (sstr == dstr and isl == 0):
            bld.hint(col, **act, c0=S0b, xx=half, m3=-1)
        else:  # strided single-block source: xor on u = t << isl
            bld.hint(col, **act, c0=S0b, s2=-isl, xx=half << isl, m3=-1)

    def hint_src_read(col):
        if nblocks > 1 or (sstr == dstr and isl == 0):
            bld.hint(col, **act, c0=S0b, m1=-1)
        else:
            bld.hint(col, **act, c0=S0b, s2=-isl, m2=-1)

    for li, (pi, d, fin) in enumerate(levels):
        half = bs >> (d + 1)
        bm = off[f"bm_{k}_{d}_{pi}"]
        hw = half  # plane width
        use_src = li == 0 and src is not None
        srcp = (S0b + J * sstr + (I << isl)) if use_src else None
        if unscaled:
            # exact 2-mul butterfly: a = diag, b = off-diag, selected by
            # the butterfly bit (the reference's matrix application)
            ar, g1, br, g2 = bld.new_step()
            ar[P] = np.where((I & half) != 0, bm + hw, bm) + (I & (half - 1))
            br[P] = (np.where((I & half) != 0, bm + 3 * hw, bm + 2 * hw)
                     + (I & (half - 1)))
            bld.hint("a", **act, sb=_ilog2(half), c0=bm, c1=bm + hw,
                     m1=half - 1, dk=1, dc=ONE)
            bld.hint("b", **act, sb=_ilog2(half), c0=bm + 2 * hw,
                     c1=bm + 3 * hw, m1=half - 1, dk=1, dc=ZERO)
            if use_src:
                g1[P] = srcp
                g2[P] = S0b + J * sstr + ((I ^ half) << isl)
                hint_src_read("g1")
                hint_partner("g2", half, True)
            else:
                g2[P] = R0 + J * dstr + (I ^ half)
                hint_partner("g2", half, False)
            continue
        if fin:  # unscale: out = (Ms·D)·x[p] + (Mp·D[perm])·x[p^half]
            ar, g1, br, g2 = bld.new_step(csrc=True)
            ar[P] = 1 + I
            br[P] = 1 + I
            g2[P] = R0 + J * dstr + (I ^ half)
            bld.hint("a", **act, c0=1, m1=dstr - 1)
            bld.hint("b", **act, c0=1, m1=dstr - 1)
            hint_partner("g2", half, False)
        elif use_src:
            ar, g1, br, g2 = bld.new_aff1_step(csrc=True)
            br[P] = 1 + I
            g1[P] = srcp
            g2[P] = S0b + J * sstr + ((I ^ half) << isl)
            bld.hint("b", **act, c0=1, m1=dstr - 1)
            hint_src_read("g1")
            hint_partner("g2", half, True)
        else:
            ar, g1, br, g2 = bld.new_aff1_step(self_read=True, csrc=True)
            br[P] = 1 + I
            g2[P] = R0 + J * dstr + (I ^ half)
            bld.hint("b", **act, c0=1, m1=dstr - 1)
            hint_partner("g2", half, False)
        bld.dop(DOP_FINAL if fin else (DOP_LEVEL0 if li == 0
                                       else DOP_LEVEL),
                shalf=_ilog2(half), hm=half - 1, half=half,
                ms0=bm, ms1=bm + hw, mp0=bm + 2 * hw, mp1=bm + 3 * hw,
                msi0=bm + 4 * hw, msi1=bm + 5 * hw)


def extend_schedule(off: dict, m: int, moiety: int, mextend: bool = False):
    """Standalone EXTEND/MEXTEND of an m-point input (tree size 2m).

    State width m+1 (const-one slot feeds MEXTEND's +Z table term,
    fftree.rs:128-135). ``off``: the pool offsets."""
    W = m + 1
    bld = _Builder(W)
    _emit_extend(bld, off, 2 * m, moiety, (0, m), 1)
    if mextend:
        zkey = "z0_s1" if moiety == S1 else "z1_s0"
        zoff = off[f"{zkey}_{2 * m}"]
        ar, g1, br, g2 = bld.new_aff1_step(self_read=True)
        idx = np.arange(m)
        br[idx] = zoff + idx
        g2[idx] = m  # const-one slot
        bld.hint("b", off=0, span=m, c0=zoff, m1=-1)
        bld.hint("g2", off=0, span=m, c0=m)
    return bld.arrays()


def enter_schedule(off: dict, n: int):
    """ENTER as a schedule (fftree.rs:143-167): per block size k, fold the
    lane copy into depth-0 butterflies on the scratch lane, then one
    combine step interleaving U + X^(k/2)·V. ``off``: the pool offsets."""
    W = 2 * n + 1
    bld = _Builder(W)
    size = 2
    while size <= n:
        k, bs = size, size // 2
        # every block extends (u and v alike); scratch lane destination
        _emit_extend(bld, off, k, S1, (n, bs), n // bs, src=(0, bs, 0))
        # combine (fftree.rs:155-159): u + xnn·v is the 1-mul form
        xnn_off = off[f"xnn_s_{k}"]
        ar, g1, br, g2 = bld.new_aff1_step()
        Jc, Rc = _mesh(n // k, k)
        Ic = Rc // 2
        P = Jc * k + Rc
        # u1/v1 come from the scratch lane (lane0 when bs == 1: the
        # size-1 extend was the identity)
        nbase = 0 if bs == 1 else n
        base = np.where(Rc % 2 == 0, 0, nbase)
        g1[P] = base + Jc * k + Ic
        g2[P] = base + Jc * k + bs + Ic
        br[P] = xnn_off + Rc
        bld.hint("g1", off=0, span=n, sb=0, c0=0, c1=nbase,
                 m1=~(k - 1), s2=1, m2=(k - 1) >> 1)
        bld.hint("g2", off=0, span=n, sb=0, c0=bs, c1=nbase + bs,
                 m1=~(k - 1), s2=1, m2=(k - 1) >> 1)
        bld.hint("b", off=0, span=n, c0=xnn_off, m1=k - 1)
        size *= 2
    return bld.arrays()


def exit_schedule(off: dict, n: int):
    """EXIT as a schedule (fftree.rs:200-230): per level k (n down to 2),
    MOD by X^(k/2) = REDC ∘ (·c) ∘ REDC with the ·c and a₀⁻¹ stages fused
    into pool coefficients, then the u0/v0 split. Scratch lane regions:
    Sa = first half of each block, Sb = second half. ``off``: the pool
    offsets.
    """
    W = 2 * n + 1
    bld = _Builder(W)
    k = n
    while k >= 2:
        bs = k // 2
        nb = n // k
        SA0, SB0 = n, n + bs  # stride-k block regions on the scratch lane
        a0inv = off[f"xnn_s_inv_{k}"]  # even entries via stride-2 index
        z0inv = off[f"z0_inv_s1_{k}"]
        negaz = off[f"neg_a1_z0inv_{k}"]
        c0a0 = off[f"c0_a0inv_{k}"]
        zc1 = off[f"zc1_{k}"]
        negxi = off[f"neg_xnninv_{k}"]
        J, I = _mesh(nb, bs)
        SA = SA0 + J * k + I
        SB = SB0 + J * k + I
        actA = dict(off=SA0, span=(nb - 1) * k + bs, km=k - 1, alo=0,
                    ahi=bs)
        actB = dict(off=SB0, span=(nb - 1) * k + bs, km=k - 1, alo=0,
                    ahi=bs)

        # -- REDC 1 (moiety S0, a = xnn) --
        # t0 = e0·a0inv → Sa (fftree.rs:238): pure scale = 1-mul step
        # reading the always-zero pad row as x1
        ar, g1, br, g2 = bld.new_aff1_step()
        g1[SA] = bld.zero_pos
        br[SA] = a0inv + 2 * I
        g2[SA] = J * k + 2 * I
        bld.hint("g1", **actA, c0=bld.zero_pos, dk=0)
        bld.hint("b", **actA, c0=a0inv, s2=-1, m2=2 * bs - 1)
        bld.hint("g2", **actA, m1=~(k - 1), s2=-1, m2=2 * bs - 1)
        # g1v = extend(t0, S1) on Sa
        _emit_extend(bld, off, k, S1, (SA0, k), nb)
        # h1 = z0inv·e1 + negaz·g1v → Sb  (fftree.rs:253-255)
        ar, g1, br, g2 = bld.new_step()
        ar[SB] = z0inv + I
        g1[SB] = J * k + 2 * I + 1
        br[SB] = negaz + I
        g2[SB] = SA
        bld.hint("a", **actB, c0=z0inv, m1=k - 1)
        bld.hint("g1", **actB, c0=1, m1=~(k - 1), s2=-1, m2=2 * bs - 1)
        bld.hint("b", **actB, c0=negaz, m1=k - 1)
        bld.hint("g2", **actB, c0=SA0, m1=-1)
        # h0 = extend(h1, S0): read Sb, work in Sa (h1 must survive)
        _emit_extend(bld, off, k, S0, (SA0, k), nb, src=(SB0, k, 0))
        h0b, h1b = (SA0, SB0) if bs > 1 else (SB0, SB0)

        # -- fuse ·c and REDC 2 (fftree.rs:277-281) --
        # t0' = (h0·c_even)·a0inv = c0a0·h0 → Sa (1-mul scale)
        ar, g1, br, g2 = bld.new_aff1_step()
        g1[SA] = bld.zero_pos
        br[SA] = c0a0 + I
        g2[SA] = h0b + J * k + I
        bld.hint("g1", **actA, c0=bld.zero_pos, dk=0)
        bld.hint("b", **actA, c0=c0a0, m1=k - 1)
        bld.hint("g2", **actA, c0=h0b, m1=-1)
        _emit_extend(bld, off, k, S1, (SA0, k), nb)
        # h1' = zc1·h1 + negaz·g1v' → Sb
        ar, g1, br, g2 = bld.new_step()
        ar[SB] = zc1 + I
        g1[SB] = h1b + J * k + I
        br[SB] = negaz + I
        g2[SB] = SA
        bld.hint("a", **actB, c0=zc1, m1=k - 1)
        bld.hint("g1", **actB, c0=h1b, m1=-1)
        bld.hint("b", **actB, c0=negaz, m1=k - 1)
        bld.hint("g2", **actB, c0=SA0, m1=-1)
        _emit_extend(bld, off, k, S0, (SA0, k), nb, src=(SB0, k, 0))
        U0b = SA0 if bs > 1 else SB0

        # -- split: b-half first (it reads e0 the a-half would clobber),
        # then a-half = u0 (fftree.rs:206-221; u0 = MOD's even = h0') --
        ar, g1, br, g2 = bld.new_step()
        PB = J * k + bs + I
        ar[PB] = a0inv + 2 * I
        g1[PB] = J * k + 2 * I
        br[PB] = negxi + 2 * I
        g2[PB] = U0b + J * k + I
        actPB = dict(off=bs, span=(nb - 1) * k + bs, km=k - 1, alo=0,
                     ahi=bs)
        bld.hint("a", **actPB, c0=a0inv, s2=-1, m2=2 * bs - 1)
        bld.hint("g1", **actPB, m1=~(k - 1), s2=-1, m2=2 * bs - 1)
        bld.hint("b", **actPB, c0=negxi, s2=-1, m2=2 * bs - 1)
        bld.hint("g2", **actPB, c0=U0b, m1=-1)
        ar, g1, br, g2 = bld.new_aff1_step()
        PA = J * k + I
        g1[PA] = U0b + J * k + I
        bld.hint("g1", off=0, span=(nb - 1) * k + bs, km=k - 1, alo=0,
                 ahi=bs, c0=U0b, m1=-1)
        k //= 2
    return bld.arrays()


def mod_schedule(off: dict, k: int, redc_only: bool = False, moiety: int = S0):
    """Standalone MOD (or single REDC) by a = X^(k/2) with the canonical
    c table (the fftree.rs:286-289 public entry specialized to the
    precomputed-modulus case). Output replaces the value lane with the
    interleaved (h0', h1') table. ``moiety=S1`` gives canonical REDC by
    Z₁ (fftree.rs:272-275); full MOD is S0-only (fftree.rs:278-280).
    ``off``: the pool offsets.
    """
    assert moiety == S0 or redc_only, "full MOD is S0-only"
    n = k
    W = 2 * n + 1
    bld = _Builder(W)
    bs = k // 2
    SA0, SB0 = n, n + bs
    a0inv = off[f"xnn_s_inv_{k}"]
    z0inv = (off[f"z0_inv_s1_{k}"] if moiety == S0
             else off[f"z1_inv_s0_{k}"])
    negaz = (off[f"neg_a1_z0inv_{k}"] if moiety == S0
             else off[f"neg_a1_z1inv_{k}"])
    c0a0 = off[f"c0_a0inv_{k}"]
    zc1 = off[f"zc1_{k}"]
    other = S1 if moiety == S0 else S0

    I = np.arange(bs)
    SA, SB = SA0 + I, SB0 + I
    actA = dict(off=SA0, span=bs)
    actB = dict(off=SB0, span=bs)
    ar, g1, br, g2 = bld.new_aff1_step()
    g1[SA] = bld.zero_pos
    br[SA] = a0inv + 2 * I
    g2[SA] = 2 * I
    bld.hint("g1", **actA, c0=bld.zero_pos, dk=0)
    bld.hint("b", **actA, c0=a0inv, s2=-1, m2=-1)
    bld.hint("g2", **actA, s2=-1, m2=-1)
    _emit_extend(bld, off, k, other, (SA0, k), 1)
    ar, g1, br, g2 = bld.new_step()
    ar[SB] = z0inv + I
    g1[SB] = 2 * I + 1
    br[SB] = negaz + I
    g2[SB] = SA
    bld.hint("a", **actB, c0=z0inv, m1=-1)
    bld.hint("g1", **actB, c0=1, s2=-1, m2=-1)
    bld.hint("b", **actB, c0=negaz, m1=-1)
    bld.hint("g2", **actB, c0=SA0, m1=-1)
    _emit_extend(bld, off, k, moiety, (SA0, k), 1, src=(SB0, k, 0))
    h0b, h1b = (SA0, SB0) if bs > 1 else (SB0, SB0)
    if not redc_only:
        ar, g1, br, g2 = bld.new_aff1_step()
        g1[SA] = bld.zero_pos
        br[SA] = c0a0 + I
        g2[SA] = h0b + I
        bld.hint("g1", **actA, c0=bld.zero_pos, dk=0)
        bld.hint("b", **actA, c0=c0a0, m1=-1)
        bld.hint("g2", **actA, c0=h0b, m1=-1)
        _emit_extend(bld, off, k, S1, (SA0, k), 1)
        ar, g1, br, g2 = bld.new_step()
        ar[SB] = zc1 + I
        g1[SB] = h1b + I
        br[SB] = negaz + I
        g2[SB] = SA
        bld.hint("a", **actB, c0=zc1, m1=-1)
        bld.hint("g1", **actB, c0=h1b, m1=-1)
        bld.hint("b", **actB, c0=negaz, m1=-1)
        bld.hint("g2", **actB, c0=SA0, m1=-1)
        _emit_extend(bld, off, k, S0, (SA0, k), 1, src=(SB0, k, 0))
        h0b = SA0 if bs > 1 else SB0
        h1b = SB0
    # interleave result back onto the value lane (mul-free copy step)
    ar, g1, br, g2 = bld.new_aff1_step()
    g1[2 * I] = h0b + I
    g1[2 * I + 1] = h1b + I
    bld.hint("g1", off=0, span=k, sb=0, c0=h0b, c1=h1b, s2=1, m2=-1)
    return bld.arrays()


def degree_schedule(off: dict, n: int):
    """DEGREE as a schedule (fftree.rs:169-198).

    Per level k: extend the even evals onto S₁, compare against the odd
    evals (one OP_CMPSEL bool per batch lane), and select either the
    low path (keep e₀) or the high path t₀ = extend((e₁−g₁)·z₀⁻¹, S₀),
    accumulating k/2 on the high path. The accumulator rides the state
    as a field element; ``FFTree.degree`` decodes it to int32. ``off``:
    the pool offsets.

    State: V [0,n) evals · acc at n · acc+k/2 at n+1 · one at n+2 ·
    SA [n+3, n+3+n/2) extend scratch · SB t₁/t₀ scratch. Every step is
    laid out to keep its active span ≤ n/2+1: the accumulator update is
    its own one-row step; the branch select is TWO cmpsel steps (V rows,
    then acc) whose compare indices live on rows just below acc — so the
    whole schedule windows to ~n/2 instead of ~2n.
    """
    acc, acc_s = n, n + 1
    one_pos = n + 2
    sa = n + 3
    sb = sa + n // 2
    bld = _Builder(sb + n // 2, one_pos=one_pos)
    k = n
    while k >= 2:
        bs = k // 2
        I = np.arange(bs)
        SA, SB = sa + I, sb + I
        # acc_s = acc + k/2 (one-row 1-mul step)
        ar, g1, br, g2 = bld.new_aff1_step()
        g1[acc_s] = acc
        br[acc_s] = off[f"half_const_{k}"]
        g2[acc_s] = one_pos
        bld.hint("g1", off=acc_s, span=1, c0=acc, dk=0)
        bld.hint("b", off=acc_s, span=1, c0=off[f"half_const_{k}"])
        bld.hint("g2", off=acc_s, span=1, c0=one_pos, dk=0)
        if bs == 1:
            ar, g1, br, g2 = bld.new_aff1_step()  # identity extend = copy
            g1[SA] = 2 * I
            bld.hint("g1", off=sa, span=1, c0=0)
        else:
            _emit_extend(bld, off, k, S1, (sa, bs), 1, src=(0, 1, 1))
        # t1 = z0inv·e1 − z0inv·g1 → SB
        ar, g1, br, g2 = bld.new_step()
        ar[SB] = off[f"z0_inv_s1_{k}"] + I
        g1[SB] = 2 * I + 1
        br[SB] = off[f"neg_z0_inv_s1_{k}"] + I
        g2[SB] = SA
        bld.hint("a", off=sb, span=bs, c0=off[f"z0_inv_s1_{k}"], m1=-1)
        bld.hint("g1", off=sb, span=bs, c0=1, s2=-1, m2=-1)
        bld.hint("b", off=sb, span=bs, c0=off[f"neg_z0_inv_s1_{k}"],
                 m1=-1)
        bld.hint("g2", off=sb, span=bs, c0=sa, m1=-1)
        if bs > 1:
            _emit_extend(bld, off, k, S0, (sb, bs), 1, src=(sb, bs, 0))
        # low path iff extend(e₀) == e₁. cmpsel 1: acc row FIRST (the
        # V-select below overwrites the odd evals the compare reads) —
        # the compare pairs sit on rows just below acc
        ar, g1, br, g2 = bld.new_cmpsel_step()
        rows = acc - bs + I
        ar[rows] = SA
        br[rows] = 2 * I + 1
        g1[acc] = acc
        g2[acc] = acc_s
        bld.hint("a", off=acc - bs, span=bs, c0=sa, m1=-1)
        bld.hint("b", off=acc - bs, span=bs, c0=1, s2=-1, m2=-1)
        bld.hint("g1", off=acc, span=1, c0=acc, dk=0)
        bld.hint("g2", off=acc, span=1, c0=acc_s, dk=0)
        # cmpsel 2: V rows — compare pairs sit on the SAME rows being
        # written (a/b are compare indices, g1/g2 the select)
        ar, g1, br, g2 = bld.new_cmpsel_step()
        ar[I] = SA
        br[I] = 2 * I + 1
        g1[I] = 2 * I
        g2[I] = SB
        bld.hint("a", off=0, span=bs, c0=sa, m1=-1)
        bld.hint("b", off=0, span=bs, c0=1, s2=-1, m2=-1)
        bld.hint("g1", off=0, span=bs, s2=-1, m2=-1)
        bld.hint("g2", off=0, span=bs, c0=sb, m1=-1)
        k //= 2
    # expose acc at row 0 for from_state (mul-free copy step)
    ar, g1, br, g2 = bld.new_aff1_step()
    g1[0] = acc
    bld.hint("g1", off=0, span=1, c0=acc)
    return bld.arrays()


def vanish_schedule(off: dict, v: int):
    """VANISH of v arbitrary points over the size-2v (sub)tree as a
    schedule (fftree.rs:291-316): base values [α−l₀, α−l₁] via the
    negated 2-leaf domain, then per level one OP_MUL pairwise merge and
    a batched MEXTEND.

    Values live MOIETY-PLANAR: two v-row planes (S0 values, S1 values)
    that ping-pong with the two v-row scratch planes each level — a
    merged group's S0 plane IS the product plane and its S1 plane IS
    the mextend output, so there are no interleave steps and every
    step's active span is exactly v. The final domain-ordered interleave
    is a post-scan output permutation (run_schedule's out_perm).

    Returns the schedule with out_perm set. ``off``: the pool offsets.
    """
    one_pos = 4 * v
    bld = _Builder(4 * v + 1, one_pos=one_pos)
    I = np.arange(v)
    # base planes (input points arrive at rows [0, v)): S1 plane first —
    # the S0 plane overwrites the inputs in place
    ar, g1, br, g2 = bld.new_aff1_step()
    g1[v + I] = I
    br[v + I] = off["neg_leaf2"] + 1
    g2[v + I] = one_pos
    bld.hint("g1", off=v, span=v, m1=-1)
    bld.hint("b", off=v, span=v, c0=off["neg_leaf2"] + 1)
    bld.hint("g2", off=v, span=v, c0=one_pos)
    ar, g1, br, g2 = bld.new_aff1_step(self_read=True)
    br[I] = off["neg_leaf2"] + 0
    g2[I] = one_pos
    bld.hint("b", off=0, span=v, c0=off["neg_leaf2"])
    bld.hint("g2", off=0, span=v, c0=one_pos)
    base = 0  # current planes at [base, base+2v); scratch at the other
    cur = 2
    while cur < 2 * v:
        ng = 2 * v // cur // 2  # merged groups this level
        scratch = 2 * v - base
        mc = cur // 2  # per-moiety size of a child group
        J, T = _mesh(ng, cur)
        SA = scratch + J * cur + T
        SB = scratch + v + J * cur + T
        # child value at domain position t: even → S0 plane, odd → S1;
        # q_s0[g, t] = left(t) · right(t) (state×state)
        ar, g1, br, g2 = bld.new_mul_step()
        g1[SA] = base + np.where(T % 2 == 0, 0, v) + 2 * J * mc + T // 2
        g2[SA] = (base + np.where(T % 2 == 0, 0, v) + (2 * J + 1) * mc
                  + T // 2)
        bld.hint("g1", off=scratch, span=ng * cur, sb=0, c0=base,
                 c1=base + v, m1=~(cur - 1), s2=1, m2=mc - 1)
        bld.hint("g2", off=scratch, span=ng * cur, sb=0, c0=base + mc,
                 c1=base + v + mc, m1=~(cur - 1), s2=1, m2=mc - 1)
        # mextend q onto S1 of the size-2·cur tree → the new S1 plane
        _emit_extend(bld, off, 2 * cur, S1, (scratch + v, cur), ng,
                     src=(scratch, cur, 0))
        ar, g1, br, g2 = bld.new_aff1_step(self_read=True)
        br[SB] = off[f"z0_s1_{2 * cur}"] + T
        g2[SB] = one_pos
        bld.hint("b", off=scratch + v, span=ng * cur,
                 c0=off[f"z0_s1_{2 * cur}"], m1=cur - 1)
        bld.hint("g2", off=scratch + v, span=ng * cur, c0=one_pos)
        base = scratch
        cur *= 2
    perm = np.empty(2 * v, dtype=np.int32)
    perm[0::2] = base + np.arange(v)
    perm[1::2] = base + v + np.arange(v)
    return bld.arrays()._replace(out_perm=perm)


def general_mod_schedule(off: dict, p: int, m: int, moiety: int = S0,
                         redc_only: bool = False):
    """REDC (and MOD) with a RUNTIME modulus table, fully scheduled
    (fftree.rs:232-289): the caller packs [evals ‖ a] (REDC) or
    [evals ‖ a ‖ c] (MOD) along the position axis. a₀⁻¹ is computed by
    a scheduled Fermat chain (square-and-multiply over p−2, OP_MUL
    steps) — the reference burns a batch_inversion per call here
    (fftree.rs:236); this burns ~2·log p steps and stays inside the one
    executor. ``off``: the pool offsets; ``p``: the field's prime.

    State: V [0,m) evals/result · A [m,2m) · C [2m,3m) (MOD only) ·
    AI a₀⁻¹ · SA · SB (each m/2) · one.
    """
    bs = m // 2
    base = 2 * m if redc_only else 3 * m
    ai, sa, sb = base, base + bs, base + 2 * bs
    one_pos = base + 3 * bs
    bld = _Builder(one_pos + 1, one_pos=one_pos)
    I = np.arange(bs)
    AI, SA, SB = ai + I, sa + I, sb + I
    A0, A1 = m + 2 * I, m + 2 * I + 1
    actAI = dict(off=ai, span=bs)
    actSA = dict(off=sa, span=bs)
    actSB = dict(off=sb, span=bs)

    # --- scheduled Fermat: AI = a₀^(p−2) ---
    ar, g1, br, g2 = bld.new_aff1_step()
    g1[AI] = A0  # acc = base (top exponent bit); mul-free copy
    bld.hint("g1", **actAI, c0=m, s2=-1, m2=-1)
    ebits = bin(p - 2)[2:]
    for bit in ebits[1:]:
        ar, g1, br, g2 = bld.new_mul_step()
        g1[AI] = AI
        g2[AI] = AI  # square
        bld.hint("g1", **actAI, c0=ai, m1=-1)
        bld.hint("g2", **actAI, c0=ai, m1=-1)
        if bit == "1":
            ar, g1, br, g2 = bld.new_mul_step()
            g1[AI] = AI
            g2[AI] = A0  # multiply by base
            bld.hint("g1", **actAI, c0=ai, m1=-1)
            bld.hint("g2", **actAI, c0=m, s2=-1, m2=-1)

    other = S1 if moiety == S0 else S0
    zinv = (off[f"z0_inv_s1_{m}"] if moiety == S0
            else off[f"z1_inv_s0_{m}"])
    neg_zinv = (off[f"neg_z0_inv_s1_{m}"] if moiety == S0
                else off[f"neg_z1_inv_s0_{m}"])

    def redc_pass(e0, e1):
        """SA ← h0, SB ← h1; e0/e1 = (row values, hint params) pairs."""
        e0_rows, e0_p = e0
        e1_rows, e1_p = e1
        # t0 = e0·a0inv → SA
        ar, g1, br, g2 = bld.new_mul_step()
        g1[SA] = e0_rows
        g2[SA] = AI
        bld.hint("g1", **actSA, **e0_p)
        bld.hint("g2", **actSA, c0=ai, m1=-1)
        # g1v = extend(t0, other) in place
        if bs > 1:
            _emit_extend(bld, off, m, other, (sa, bs), 1)
        # g1v·a1 in place
        ar, g1, br, g2 = bld.new_mul_step()
        g1[SA] = SA
        g2[SA] = A1
        bld.hint("g1", **actSA, c0=sa, m1=-1)
        bld.hint("g2", **actSA, c0=m + 1, s2=-1, m2=-1)
        # h1 = zinv·e1 + neg_zinv·(g1v·a1) → SB
        ar, g1, br, g2 = bld.new_step()
        ar[SB] = zinv + I
        g1[SB] = e1_rows
        br[SB] = neg_zinv + I
        g2[SB] = SA
        bld.hint("a", **actSB, c0=zinv, m1=-1)
        bld.hint("g1", **actSB, **e1_p)
        bld.hint("b", **actSB, c0=neg_zinv, m1=-1)
        bld.hint("g2", **actSB, c0=sa, m1=-1)
        # h0 = extend(h1, moiety) → SA
        if bs > 1:
            _emit_extend(bld, off, m, moiety, (sa, bs), 1,
                         src=(sb, bs, 0))
        else:
            ar, g1, br, g2 = bld.new_step()
            g1[SA] = SB
            bld.hint("g1", **actSA, c0=sb, m1=-1)

    redc_pass((2 * I, dict(s2=-1, m2=-1)),
              (2 * I + 1, dict(c0=1, s2=-1, m2=-1)))
    if not redc_only:
        # scale by c (hc0 = h0·c_even, hc1 = h1·c_odd): SA and SB are
        # adjacent, so one mul step with a parity-like select on the
        # bs-bit covers both halves
        ar, g1, br, g2 = bld.new_mul_step()
        g1[SA] = SA
        g2[SA] = 2 * m + 2 * I
        g1[SB] = SB
        g2[SB] = 2 * m + 2 * I + 1
        bld.hint("g1", off=sa, span=2 * bs, c0=sa, m1=-1)
        bld.hint("g2", off=sa, span=2 * bs, sb=_ilog2(bs),
                 c0=2 * m, c1=2 * m - 2 * bs + 1, s2=-1, m2=-1)
        redc_pass((SA, dict(c0=sa, m1=-1)), (SB, dict(c0=sb, m1=-1)))
    # interleave (h0, h1) onto V (mul-free copy step)
    ar, g1, br, g2 = bld.new_aff1_step()
    g1[2 * I] = SA
    g1[2 * I + 1] = SB
    bld.hint("g1", off=0, span=m, sb=0, c0=sa, c1=sb, s2=1, m2=-1)
    return bld.arrays()
