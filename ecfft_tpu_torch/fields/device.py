"""Prime-field arithmetic on limb tensors, in plain PyTorch.

The port's counterpart of ``ecfft_tpu/fields/device.py``: the field ops
of (..., L) tensors (:func:`add`, :func:`sub`, :func:`neg`, :func:`mul`,
:func:`square`, :func:`pow_int`, :func:`inv`, :func:`eq`, the fused
:func:`muladd2` and :func:`mat2_apply`) and the column pipeline that the
kernels' plain versions run. Everything here is the plain version, for
CPU tensors: on the card a product goes to the hand-written kernels
through ``ops.step`` (``step.mul``, ``step.pow_int``, ``step.inv``, ...),
which pass their product to :func:`pow_int` and :func:`inv`; sums,
differences and compares stay these PyTorch ops on either device.

Layout: a field element is L limbs of 16 bits (``spec.limb_bits``), the
same bits as the JAX package's uint32 limbs; M31 (p = 2^31 − 1) packs its
element into one 32-bit limb. PyTorch has little uint32 support (no add,
shift or compare on the CPU), so resident tensors are **int32** (a 16-bit
limb, or a canonical M31 value, fits) and the plain arithmetic here
computes in **int64**, where every column sum of the schoolbook product,
and every product of two M31 values, is exact.

The column functions mirror the XLA step pipeline of
``ecfft_tpu/ops/schedule.py`` (``_conv_cols`` → ``_fold_cols`` →
``_normalize_cols`` → ``_reduce_cols``) on the (..., columns, B) layout,
producing the same column values; only the carry normalization differs
(a serial ripple here, a carry-lookahead scan there), and both are exact.
A prime without a pseudo-Mersenne fold keeps its residents in Montgomery
form (value·R, R = 2^(16L)), as the JAX package does: its products reduce
by ``_mont_reduce_cols`` (CIOS), and :func:`mul` gives the canonical
product of canonical values. A prime of one 16-bit limb with a fold
(p = 97, 64513, 65521, ...) keeps canonical residents: its product columns
hold a value below 2^35, which one int64 remainder reduces exactly.
"""

from __future__ import annotations

import numpy as np
import torch

from ecfft_tpu_torch.fields.registry import LIMB_MASK, M31_P, FieldSpec


def encode(spec: FieldSpec, values, device=None) -> torch.Tensor:
    """Python ints → int32 limb tensor (canonical form, one trailing limb
    axis of size ``spec.num_limbs``)."""
    arr = np.asarray(values, dtype=object)
    nbytes = 4 if spec.limb_bits > 16 else 2 * spec.num_limbs
    raw = b"".join((int(v) % spec.p).to_bytes(nbytes, "little")
                   for v in arr.reshape(-1))
    if spec.limb_bits > 16:
        out = np.frombuffer(raw, "<u4").reshape(-1, 1)
    else:
        out = np.frombuffer(raw, "<u2").reshape(-1, spec.num_limbs)
    out = out.astype(np.int32).reshape(arr.shape + (spec.num_limbs,))
    return torch.from_numpy(out).to(device)


def decode(spec: FieldSpec, limbs) -> np.ndarray:
    """Limb tensor (or array) → object array of python ints."""
    if isinstance(limbs, torch.Tensor):
        limbs = limbs.cpu().numpy()
    arr = np.asarray(limbs).astype(np.int64)
    shape = arr.shape[:-1]
    flat = arr.reshape(-1, spec.num_limbs)
    if spec.limb_bits > 16:
        raw, fs = flat.astype("<u4").tobytes(), 4 * spec.num_limbs
    else:
        raw, fs = flat.astype("<u2").tobytes(), 2 * spec.num_limbs
    out = np.empty(flat.shape[0], dtype=object)
    for i in range(flat.shape[0]):
        out[i] = int.from_bytes(raw[i * fs:(i + 1) * fs], "little")
    return out.reshape(shape)


def on_device(t: torch.Tensor, device: torch.device) -> bool:
    """Whether ``t`` lies on ``device``, where a CUDA device without an
    index (``"cuda"``, the trees' default) means the current card, as
    ``torch`` places a tensor made for it (``t.device`` is then
    ``cuda:0``, not ``cuda``)."""
    if device.type == "cuda" and device.index is None:
        return t.is_cuda and t.device.index == torch.cuda.current_device()
    return t.device == device


def ones(spec: FieldSpec, shape=(), device=None) -> torch.Tensor:
    return encode(spec, 1, device).expand(*shape, spec.num_limbs)


# ------------------------------------------------------- M31, in int64


def is_m31(spec: FieldSpec) -> bool:
    return spec.num_limbs == 1 and spec.p == M31_P


def _m31_canon(x):
    """int64 values below 2^63 → canonical residues mod 2^31 − 1: fold
    twice (x ≡ (x mod 2^31) + (x >> 31)), then subtract p once."""
    x = (x & M31_P) + (x >> 31)
    x = (x & M31_P) + (x >> 31)
    return torch.where(x >= M31_P, x - M31_P, x)


def _m31_add(a, b):
    s = a.long() + b.long()  # < 2p
    return torch.where(s >= M31_P, s - M31_P, s)


def _m31_sub(a, b):
    a, b = a.long(), b.long()
    return torch.where(a >= b, a - b, a + (M31_P - b))


def _m31_mul(a, b):
    """The product of two canonical values (< 2^62, exact in int64),
    reduced: the same residue, so the same bits, as the JAX package's
    16-bit-split product."""
    return _m31_canon(a.long() * b.long())


# ------------------------------------------------ int64 column pipeline


def _conv_cols(spec: FieldSpec, a, x):
    """Shift-accumulate product columns: a (..., L, 1|B) × x (..., L, B)
    → (..., 2L, B) int64, with the JAX pipeline's 16-bit lo/hi split so
    every column equals its uint32 counterpart (< 2L·2^16)."""
    L = spec.num_limbs
    a, x = a.long(), x.long()
    c = x.new_zeros((*x.shape[:-2], 2 * L, x.shape[-1]))
    for i in range(L):
        prod = a[..., i:i + 1, :] * x
        c[..., i:i + L, :] += prod & LIMB_MASK
        c[..., i + 1:i + L + 1, :] += prod >> 16
    return c


def _fold_cols(spec: FieldSpec, c):
    """Fold columns ≥ L (axis -2) back in with 2^(16L) ≡ Σ d·2^(16·off)."""
    L = spec.num_limbs
    hw = c.shape[-2] - L
    out_w = max(L, max(off for off, _ in spec.fold_terms) + hw)
    out = c.new_zeros((*c.shape[:-2], out_w, c.shape[-1]))
    out[..., :L, :] = c[..., :L, :]
    for off, digit in spec.fold_terms:
        out[..., off:off + hw, :] += c[..., L:, :] * digit
    return out


def _normalize_cols(c):
    """Carry-normalize along axis -2: columns → 16-bit limbs, width + 1
    (the last column takes the final carry). Exact for any int64 input
    that does not overflow."""
    out = []
    carry = torch.zeros_like(c[..., 0, :])
    for k in range(c.shape[-2]):
        v = c[..., k, :] + carry
        out.append(v & LIMB_MASK)
        carry = v >> 16
    out.append(carry)
    return torch.stack(out, dim=-2)


def _sub_comps(spec: FieldSpec, js) -> list:
    """Limbs of 2^(16(L+1)) − p·2^j for each j: adding one and reading the
    top column tells whether x ≥ p·2^j (the conditional-subtract chain)."""
    W1 = spec.num_limbs + 1
    return [[((1 << (16 * W1)) - (spec.p << j)) >> (16 * i) & LIMB_MASK
             for i in range(W1)] for j in js]


def _cond_sub(spec: FieldSpec, x, js):
    """Canonical (..., L + 1, B) limbs: subtract p·2^j where it fits, for
    each j of ``js`` in turn; returns the low L limbs."""
    L = spec.num_limbs
    for comp in _sub_comps(spec, js):
        comp = torch.tensor(comp, dtype=torch.int64, device=x.device)
        y = _normalize_cols(x + comp[:, None])
        need = y[..., L + 1:L + 2, :] > 0
        x = torch.where(need, y[..., :L + 1, :], x)
    return x[..., :L, :]


def _reduce_cols(spec: FieldSpec, c):
    """Product columns (..., 2L, B) → canonical value (..., L, B): fold,
    normalize (twice), then subtract p·2^j where it fits, j from the slack
    bound down to 0. At one limb the columns' value (below 2^35, exact in
    int64) is reduced by a remainder: two folds need not reach 2^16 there
    (F = 2^16 mod p may be as large as 2^11, e.g. 1023 for p = 64513)."""
    L = spec.num_limbs
    if L == 1:
        v = sum(c[..., k:k + 1, :].long() << (16 * k)
                for k in range(c.shape[-2]))
        return torch.remainder(v, spec.p)
    c = _normalize_cols(_fold_cols(spec, c))
    c = _normalize_cols(_fold_cols(spec, c))
    slack = 16 * L - spec.p.bit_length()
    js = [0] if slack == 0 else list(range(slack + 1, -1, -1))
    return _cond_sub(spec, c[..., :L + 1, :], js)


def is_mont(spec: FieldSpec) -> bool:
    """Whether the port keeps ``spec``'s residents in Montgomery form: a
    prime of more than one limb without a pseudo-Mersenne fold, as the JAX
    package decides (``ecfft_tpu/ops/schedule.py``, ``_pack_state``)."""
    return spec.num_limbs > 1 and spec.fold_terms is None


def _mont_reduce_cols(spec: FieldSpec, c):
    """Word-serial Montgomery reduction (CIOS) of product columns
    (..., w, B), w ≤ 2L + 1 (the columns of one product or a sum of two
    products of canonical values) → canonical value·R⁻¹ (..., L, B): L
    rounds of m = c₀·n′ mod 2^16, c += m·p, a one-column shift, as the JAX
    package's ``_mont_reduce_cols``; int64 holds every column exactly. The
    result (V + M·p)/R with V < 2p² and M < R is below 2p²/R + p < 3p, so
    subtracting 2p and then p where they fit leaves it canonical."""
    L = spec.num_limbs
    n_prime = spec.n_prime
    p_limbs = spec.to_limbs(spec.p)
    cols = [c[..., i, :].long() for i in range(c.shape[-2])]
    cols += [torch.zeros_like(cols[0]) for _ in range(2 * L + 1 - len(cols))]
    for _ in range(L):
        m = (cols[0] * n_prime) & LIMB_MASK
        for i in range(L):
            prod = m * p_limbs[i]
            cols[i] = cols[i] + (prod & LIMB_MASK)
            cols[i + 1] = cols[i + 1] + (prod >> 16)
        carry = cols[0] >> 16  # the low 16 bits are exactly zero now
        cols = cols[1:]
        cols[0] = cols[0] + carry
    x = _normalize_cols(torch.stack(cols[:L + 1], dim=-2))[..., :L + 1, :]
    return _cond_sub(spec, x, (1, 0))


def _add_canon(spec: FieldSpec, a, b):
    """Canonical (..., L, B) + (..., L, B) mod p: one conditional subtract
    (the JAX package's ``_add_canon``)."""
    x = _normalize_cols(a.long() + b.long())
    return _cond_sub(spec, x, (0,))


def _r2_col(spec: FieldSpec, device):
    """R² mod p as one (L, 1) int64 column: a Montgomery product by it
    cancels a Montgomery product's R⁻¹."""
    return torch.tensor(spec.to_limbs(spec.r2_mod_p), dtype=torch.int64,
                        device=device)[:, None]


def _mont_mul_cols(spec: FieldSpec, a, x):
    """The Montgomery product a·x·R⁻¹ mod p of canonical (..., L, 1|B)
    and (..., L, B) limbs."""
    return _mont_reduce_cols(spec, _conv_cols(spec, a, x))


def check_fold(spec: FieldSpec) -> None:
    """Raise NotImplementedError for a field the port cannot compute in: a
    prime below 2^16 without a pseudo-Mersenne fold (one 16-bit limb whose
    F = 2^16 mod p has a digit of 2^11 or more, e.g. 40961 or 12289). The
    JAX package keeps canonical residents for it yet reduces its products
    by a Montgomery reduction, and so computes wrong values (ROADMAP.md,
    "What stays out"). Every other odd prime runs: M31, a prime with a
    fold (canonical residents; one 16-bit limb included), any other of 2
    limbs or more (Montgomery residents)."""
    if spec.num_limbs == 1 and not is_m31(spec) and spec.fold_terms is None:
        raise NotImplementedError(
            f"{spec.name}: a prime of one 16-bit limb without a "
            f"pseudo-Mersenne fold is not taken (2^16 mod p = "
            f"{spec.r_mod_p} is past the fold's bound 2^11; the JAX package "
            "reduces such a prime's canonical residents with a Montgomery "
            "reduction and computes wrong values)")


# --------------------------------------------------------- field ops


def mul(spec: FieldSpec, a, b) -> torch.Tensor:
    """Elementwise field product of canonical (..., L) int32 tensors,
    canonical. A prime without a fold takes two Montgomery products, the
    second by R² mod p to cancel the first's R⁻¹ (the JAX package's
    ``_mont_mul_scan``)."""
    check_fold(spec)
    if is_m31(spec):
        return _m31_mul(a, b).int()
    a, b = a.unsqueeze(-1), b.unsqueeze(-1)
    if is_mont(spec):
        return _mont_mul_cols(spec, _r2_col(spec, a.device),
                              _mont_mul_cols(spec, a, b))[..., 0].int()
    return _reduce_cols(spec, _conv_cols(spec, a, b))[..., 0].int()


def _add_cols(spec: FieldSpec, a, b):
    """a + b mod p of canonical values in the (..., L, B) column layout
    (the operands broadcast), int64: M31 by one compare, any other field
    by one carry ripple and one conditional subtract of p (the JAX
    package's ``_gen_add``)."""
    if is_m31(spec):
        return _m31_add(a, b)
    return _add_canon(spec, a, b)


def _sub_cols(spec: FieldSpec, a, b):
    """a − b mod p of canonical values in the (..., L, B) column layout
    (the operands broadcast), int64: a − b + p, which lies in [1, 2p),
    rippled with signed carries, then p subtracted where it fits."""
    if is_m31(spec):
        return _m31_sub(a, b)
    p = torch.tensor(spec.to_limbs(spec.p), dtype=torch.int64,
                     device=a.device)[:, None]
    return _cond_sub(spec, _normalize_cols(a.long() - b.long() + p), (0,))


def add(spec: FieldSpec, a, b) -> torch.Tensor:
    """a + b mod p for canonical (..., L) int32 tensors (they broadcast)."""
    check_fold(spec)
    return _add_cols(spec, a.unsqueeze(-1), b.unsqueeze(-1))[..., 0].int()


def sub(spec: FieldSpec, a, b) -> torch.Tensor:
    """a − b mod p for canonical (..., L) int32 tensors (they broadcast)."""
    check_fold(spec)
    return _sub_cols(spec, a.unsqueeze(-1), b.unsqueeze(-1))[..., 0].int()


def neg(spec: FieldSpec, a) -> torch.Tensor:
    """−a mod p for (..., L) int32 tensors (zero stays zero)."""
    return sub(spec, torch.zeros_like(a), a)


def eq(spec: FieldSpec, a, b) -> torch.Tensor:
    """Elementwise equality, reduced over the limb axis."""
    return (a == b).all(dim=-1)


def square(spec: FieldSpec, a) -> torch.Tensor:
    """a² (:func:`mul`)."""
    return mul(spec, a, a)


def pow_int(spec: FieldSpec, a, e: int, product=None) -> torch.Tensor:
    """a^e for a host-known exponent by ``product`` (default :func:`mul`,
    the plain int64 product; ``ops.step`` passes the kernels'): binary
    square-and-multiply for an exponent of up to 16 bits, as the JAX
    package unrolls it; a longer one (Fermat's p − 2) in 4-bit windows
    from the top, a^1 … a^15 first, which takes about a third fewer
    products. Every product is exact, so the order does not change a
    bit of the result."""
    product = product or mul
    if e == 0:
        return ones(spec, a.shape[:-1], a.device).contiguous()
    if e.bit_length() <= 16:
        res, acc = None, a
        while True:
            if e & 1:
                res = acc if res is None else product(spec, res, acc)
            e >>= 1
            if not e:
                return res
            acc = product(spec, acc, acc)
    table = [None, a]
    for _ in range(14):
        table.append(product(spec, table[-1], a))
    digits = [(e >> s) & 15 for s in range(0, e.bit_length(), 4)][::-1]
    res = table[digits[0]]
    for dgt in digits[1:]:
        for _ in range(4):
            res = product(spec, res, res)
        if dgt:
            res = product(spec, res, table[dgt])
    return res


def inv(spec: FieldSpec, a, power=None) -> torch.Tensor:
    """Elementwise inverse by Fermat, a^(p−2), for every field, zero mapped
    to zero (the JAX package's ``inv``); ``power`` (default
    :func:`pow_int`) raises to the power."""
    check_fold(spec)
    r = (power or pow_int)(spec, a, spec.p - 2)
    zero = (a == 0).all(dim=-1, keepdim=True)
    return torch.where(zero, torch.zeros_like(r), r)


def muladd2(spec: FieldSpec, a1, x1, a2, x2) -> torch.Tensor:
    """a1·x1 + a2·x2 of canonical (..., L) int32 tensors, canonical: the
    two products' columns summed before one reduction (a Montgomery one
    and a product by R² mod p for a prime without a fold), as the JAX
    package's fused ``muladd2``."""
    check_fold(spec)
    if is_m31(spec):
        return _m31_add(_m31_mul(a1, x1), _m31_mul(a2, x2)).int()
    a1, x1, a2, x2 = (t.unsqueeze(-1) for t in (a1, x1, a2, x2))
    c = _conv_cols(spec, a1, x1) + _conv_cols(spec, a2, x2)
    if is_mont(spec):
        return _mont_mul_cols(spec, _r2_col(spec, c.device),
                              _mont_reduce_cols(spec, c))[..., 0].int()
    return _reduce_cols(spec, c)[..., 0].int()


def mat2_apply(spec: FieldSpec, m, v0, v1):
    """The 2×2 matrix–vector product over the field: ``m`` (..., 2, 2, L),
    ``v0``/``v1`` (..., L) → (m00·v0 + m01·v1, m10·v0 + m11·v1)."""
    return (muladd2(spec, m[..., 0, 0, :], v0, m[..., 0, 1, :], v1),
            muladd2(spec, m[..., 1, 0, :], v0, m[..., 1, 1, :], v1))
