"""The unscheduled algorithms: direct level-by-level scans on the kernels.

The port's counterpart of ``ecfft_tpu/ops/core.py``: EXTEND, MEXTEND,
ENTER, REDC, MOD, EXIT, DEGREE and VANISH as flat iterations over levels,
each level a few whole-window operations, with no schedule. They are the
second route to every algorithm (the cross-validation path of
``FFTree.*_unscheduled``) and the device bootstrap's own algorithms
(``fftree.py``). The functions take the JAX package's arguments: a batch
(..., n, L) of canonical int32 limbs and the per-size tables (canonical
(rows, L) tensors on the batch's device), and return (..., n, L) (DEGREE
an int32 per batch entry).

Layout. A batch is laid out once, on entry, as the kernels' (rows, L,
lanes) window, positions on the rows and the batch on the lanes, and
transposed back once on exit. Where the JAX package keeps a block axis
(ENTER, EXIT, VANISH: many subproblems of one size), the blocks lie on
the row axis too, one after another, and the coefficient rows of a size
are tiled over them: the lanes stay the batch, so a launch's grid never
grows with the block count. The blocks are kept in bit-reversed order, so
the blocks a level pairs (2j and 2j + 1) are the window's first and second
halves, and a level's output blocks land where the next level reads them;
one row permutation on entry (ENTER, VANISH) or on exit (EXIT) puts the
positions in that order. Splitting a window into its even and odd rows
and interleaving two windows row by row act on every block at once, since
every block has an even number of rows.

Products. Every product is a launch of the schedule machine's kernels
through ``ops.step`` (their plain versions for CPU tensors): an EXTEND
level, c_self·x + c_partner·x[p XOR half], is one muladd2 launch beside
one copy that brings each row's partner level with it; ENTER's combine
u + v·xnn is muladd1; REDC's (e1 − g1·a1)·z⁻¹ is one muladd2 with the
rows z⁻¹ and −a1·z⁻¹ (and MOD's middle product by c joins the second
REDC's rows); VANISH's merge of two computed halves is mulss. Sums,
differences, compares, copies and selects are PyTorch ops.

Montgomery residents ("cios" forms). A kernel's product there is
a·b·R⁻¹. The values here stay canonical throughout, as the JAX package
keeps them; instead every table that multiplies a window is carried as
t·R mod p (``step.to_resident``), so muladd1 and muladd2 return canonical
sums of canonical products, and a product of two computed windows takes a
second launch by R² mod p (``step.mul_windows``). The per-size EXTEND
tables ``ext`` come already in that form (``FFTree._ext``); the other
tables are converted where they are used (a one-lane launch of one size's
rows).
"""

from __future__ import annotations

import torch

from ecfft_tpu_torch.fields import device as fd
from ecfft_tpu_torch.fields.registry import FieldSpec
from ecfft_tpu_torch.ops import step
from ecfft_tpu_torch.ops.emit import S0, S1

# --------------------------------------------------------------- layout


def _window(spec: FieldSpec, x, perm=None):
    """(..., m, L) → the (m, L, B) window of the flattened batch, its rows
    permuted by ``perm`` (an index of the m positions) where given, and
    the leading shape."""
    lead, m = x.shape[:-2], x.shape[-2]
    flat = x.reshape(-1, m, spec.num_limbs)
    if perm is not None:
        flat = flat.index_select(1, perm)
    return flat.permute(1, 2, 0).contiguous(), lead


def _unwindow(w, lead, perm=None):
    """An (m, L, B) window → (*lead, m, L), its rows permuted back."""
    if perm is not None:
        w = w.index_select(0, perm)
    return w.permute(2, 0, 1).reshape(*lead, *w.shape[:2]).contiguous()


def _bitrev(n: int, device) -> torch.Tensor:
    """The bit-reversal permutation of n = 2^k positions (an involution)."""
    idx = torch.arange(n, device=device)
    out = torch.zeros_like(idx)
    for b in range(n.bit_length() - 1):
        out |= ((idx >> b) & 1) << (n.bit_length() - 2 - b)
    return out


def _split(x):
    """A window's even and odd rows, each a window of its own."""
    return x[0::2].contiguous(), x[1::2].contiguous()


def _interleave(a, b):
    """Rows a0, b0, a1, b1, ... of two windows of one shape."""
    return torch.stack([a, b], dim=1).reshape(-1, *a.shape[1:])


def _rows(spec: FieldSpec, t, R: int, resident: bool = True):
    """A canonical (m, L) table as R coefficient rows, tiled over the R/m
    blocks of a window (in the residents' form unless ``resident`` is
    False: the form of the ``ext`` tables)."""
    if resident:
        t = step.to_resident(spec, t.contiguous())
    return t.repeat(R // t.shape[0], 1)


# ----------------------------------------------------------- algorithms


def _extend(spec: FieldSpec, ext, x, moiety: int):
    """EXTEND of every m-row block of the (R, L, B) window ``x``, ``ext``
    the tables of tree size 2m: depth d pairs the rows that differ in bit
    log2(m) − 1 − d, out[p] = c_self[d, p]·x[p] + c_partner[d, p]·x[p XOR
    half] (``ecfft_tpu/ops/core.py::extend``). Per level one copy that
    swaps each pair of half-blocks (the partners) and one muladd2 launch:
    the first into a new window, the others in place."""
    shifts = [int(h) for h in ext["shifts"]]
    if not shifts:
        return x
    dec, rec = ext["s0" if moiety == S0 else "s1"]
    R, L, B = x.shape
    levels = [(dec[d], shifts[d]) for d in range(len(shifts))]
    levels += [(rec[d], shifts[d]) for d in reversed(range(len(shifts)))]
    out = x
    for coeff, half in levels:
        partner = out.view(R // (2 * half), 2, half, L, B).flip(1).reshape(
            R, L, B)
        dst = torch.empty_like(x) if out is x else out
        step.muladd2(spec, _rows(spec, coeff[:, 0], R, False),
                     _rows(spec, coeff[:, 1], R, False), out, partner, dst,
                     0)
        out = dst
    return out


def extend(spec: FieldSpec, ext, evals, moiety: int):
    """EXTEND: evals on one moiety of a size-2m domain → the other moiety
    (fftree.rs:72-120). ``ext``: the tree size's tables, {"shifts":
    (logm,), "s0"/"s1": (dec, rec) coefficient tensors (logm, m, 2, L) in
    the residents' form}. Input (..., m, L)."""
    w, lead = _window(spec, evals)
    return _unwindow(_extend(spec, ext, w, moiety), lead)


def _mextend(spec: FieldSpec, ext, z_table, x, moiety: int):
    R = x.shape[0]
    z = z_table.repeat(R // z_table.shape[0], 1).unsqueeze(-1)
    return fd._add_cols(spec, _extend(spec, ext, x, moiety), z).int()


def mextend(spec: FieldSpec, ext, z_table, evals, moiety: int):
    """MEXTEND: EXTEND for monic polynomials of degree exactly m
    (fftree.rs:128-141), then the vanishing table (z0_s1 for an S1
    target, z1_s0 for S0) added."""
    w, lead = _window(spec, evals)
    return _unwindow(_mextend(spec, ext, z_table, w, moiety), lead)


def enter(spec: FieldSpec, ext_by_size, xnn_by_size, coeffs):
    """ENTER (fft): coefficients → evaluations (fftree.rs:143-167).

    Bottom-up over block sizes: at size k every k-block combines the two
    k/2-blocks of its coefficients' low and high halves (u, v) as u + X^(k/2)·v
    on S0 (muladd1 with xnn's even rows) and, after one EXTEND of all
    blocks onto S1, on S1 (xnn's odd rows), interleaved. The coefficients
    enter in bit-reversed order, so u's blocks are the window's first half
    and v's its second.
    """
    n = coeffs.shape[-2]
    perm = _bitrev(n, coeffs.device)
    x, lead = _window(spec, coeffs, perm)
    h = n // 2
    size = 1
    while size < n:
        size *= 2
        x1 = _extend(spec, ext_by_size[size], x, S1)
        xnn = xnn_by_size[size]
        even = step.mul_window(spec, _rows(spec, xnn[0::2], h), x[h:],
                               x[:h])
        odd = step.mul_window(spec, _rows(spec, xnn[1::2], h), x1[h:],
                              x1[:h])
        x = _interleave(even, odd)
    return _unwindow(x, lead)


def _redc(spec: FieldSpec, ext, z_inv, e0, e1, a1, a0_inv, moiety: int,
          c=None):
    """REDC of the window whose even rows are ``e0`` and odd rows ``e1``
    (fftree.rs:232-259), as the halves (h0, h1) of its output; with ``c``
    the rows are first multiplied by c's even and odd rows (MOD's middle
    product, folded into this REDC's coefficient rows):

        t0 = e0·c0·a0⁻¹,  g1 = EXTEND(t0),
        h1 = (e1·c1 − g1·a1)·z⁻¹ = e1·(c1·z⁻¹) + g1·(−a1·z⁻¹),
        h0 = EXTEND(h1).
    """
    R = e0.shape[0]
    t0_rows, z_rows = a0_inv, z_inv
    if c is not None:
        t0_rows = step.mul(spec, c[0::2], a0_inv)
        z_rows = step.mul(spec, c[1::2], z_inv)
    t0 = step.mul_window(spec, _rows(spec, t0_rows, R), e0)
    g1 = _extend(spec, ext, t0, S0 if moiety == S1 else S1)
    neg_az = fd.neg(spec, step.mul(spec, a1, z_inv))
    h1 = step.mul2_window(spec, _rows(spec, z_rows, R),
                          _rows(spec, neg_az, R), e1, g1)
    return _extend(spec, ext, h1, moiety), h1


def redc(spec: FieldSpec, ext, z_inv, evals, a1, a0_inv, moiety: int):
    """REDC: ⟨P·Z⁻¹ mod a ≀ S⟩ (fftree.rs:232-259). ``a1`` = the odd
    positions of the modulus table, ``a0_inv`` = its even positions
    inverted; ``z_inv`` is z0_inv_s1 for moiety S0, z1_inv_s0 for S1."""
    w, lead = _window(spec, evals)
    h0, h1 = _redc(spec, ext, z_inv, *_split(w), a1, a0_inv, moiety)
    return _unwindow(_interleave(h0, h1), lead)


def _mod(spec: FieldSpec, ext, z0_inv_s1, x, a1, a0_inv, c):
    """MOD = REDC ∘ (·c) ∘ REDC of a window, as its output's halves."""
    h0, h1 = _redc(spec, ext, z0_inv_s1, *_split(x), a1, a0_inv, S0)
    return _redc(spec, ext, z0_inv_s1, h0, h1, a1, a0_inv, S0, c)


def modular_reduce(spec: FieldSpec, ext, z0_inv_s1, evals, a1, a0_inv, c):
    """MOD = REDC ∘ (·c) ∘ REDC (fftree.rs:277-289); ``c`` is
    ⟨Z₀² mod a ≀ S⟩."""
    w, lead = _window(spec, evals)
    return _unwindow(_interleave(*_mod(spec, ext, z0_inv_s1, w, a1,
                                       a0_inv, c)), lead)


def exit_(spec: FieldSpec, tables, evals):
    """EXIT (ifft): evaluations → coefficients (fftree.rs:200-230).

    Top-down: each size-k block yields u0 (the low half's evaluations: MOD
    by X^(k/2)) and v0 = (e0 − u0)/X^(k/2) (one muladd2 with the rows
    xnn⁻¹ and −xnn⁻¹), which become its two k/2-blocks, the u0 blocks the
    window's first half and the v0 blocks its second; after log n levels
    the window holds the coefficients in bit-reversed order.

    ``tables[k]`` = dict with ext, xnn_s, xnn_s_inv, z0_inv_s1,
    z0z0_rem_xnn_s for tree size k.
    """
    n = evals.shape[-2]
    x, lead = _window(spec, evals)
    k = n
    while k > 1:
        t = tables[k]
        xnn, xi0 = t["xnn_s"], t["xnn_s_inv"][0::2]
        u0, _ = _mod(spec, t["ext"], t["z0_inv_s1"], x, xnn[1::2], xi0,
                     t["z0z0_rem_xnn_s"])
        R = u0.shape[0]
        v0 = step.mul2_window(spec, _rows(spec, xi0, R),
                              _rows(spec, fd.neg(spec, xi0), R),
                              x[0::2].contiguous(), u0)
        x = torch.cat([u0, v0])
        k //= 2
    return _unwindow(x, lead, _bitrev(n, x.device))


def degree(spec: FieldSpec, tables, evals):
    """DEGREE (fftree.rs:169-198), batched: per level the low path e0 and
    the high path t0 = EXTEND((e1 − EXTEND(e0))·Z₀⁻¹) are both computed
    and selected per batch lane (``torch.where``), k/2 added where the
    high path was taken. Returns an int32 tensor of shape (...) on the
    batch's device."""
    n = evals.shape[-2]
    x, lead = _window(spec, evals)
    res = torch.zeros(x.shape[2], dtype=torch.int32, device=x.device)
    k = n
    while k > 1:
        t = tables[k]
        e0, e1 = _split(x)
        g1 = _extend(spec, t["ext"], e0, S1)
        low = (g1 == e1).all(dim=1).all(dim=0)  # (B,)
        zi = t["z0_inv_s1"]
        R = e0.shape[0]
        t1 = step.mul2_window(spec, _rows(spec, zi, R),
                              _rows(spec, fd.neg(spec, zi), R), e1, g1)
        t0 = _extend(spec, t["ext"], t1, S0)
        x = torch.where(low, e0, t0)
        res += torch.where(low, 0, k // 2).to(torch.int32)
        k //= 2
    return res.reshape(lead)


def vanish(spec: FieldSpec, tables, leaves2, points):
    """VANISH: evaluations of Z(x) = Π(x − aᵢ) over S (fftree.rs:291-316):
    a bottom-up product tree. Each point α starts a 2-block [α − l₀,
    α − l₁] over the 2-leaf subtree; per level the two halves of the
    window (the blocks a level pairs, as the points enter in bit-reversed
    order) multiply (mulss) into the product's evaluations over S0, which
    MEXTEND carries onto S1, interleaved.

    ``leaves2`` = the 2-leaf subtree's domain, shape (2, L).
    ``tables[k]`` = dict with ext + z0_s1 for tree size k.
    """
    v = points.shape[-2]
    p, lead = _window(spec, points, _bitrev(v, points.device))
    leaves = leaves2.unsqueeze(-1)
    x = _interleave(fd._sub_cols(spec, p, leaves[0]).int(),
                    fd._sub_cols(spec, p, leaves[1]).int())
    size = 2
    while size < 2 * v:
        size *= 2
        h = x.shape[0] // 2
        q_s0 = step.mul_windows(spec, x[:h], x[h:])
        t = tables[size]
        x = _interleave(q_s0, _mextend(spec, t["ext"], t["z0_s1"], q_s0, S1))
    return _unwindow(x, lead)
