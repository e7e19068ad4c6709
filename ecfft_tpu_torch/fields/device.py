"""Prime-field arithmetic on limb tensors, in plain PyTorch.

The port's counterpart of ``ecfft_tpu/fields/device.py``, cut to what the
pool build, the step functions' plain versions and the tests need.

Layout: a field element is L limbs of 16 bits (``spec.limb_bits``), the
same bits as the JAX package's uint32 limbs. PyTorch has little uint32
support (no add, shift or compare on the CPU), so resident tensors are
**int32** (a 16-bit limb fits) and the plain
arithmetic here computes in **int64**, where every column sum of the
schoolbook product is exact.

The column functions mirror the XLA step pipeline of
``ecfft_tpu/ops/schedule.py`` (``_conv_cols`` → ``_fold_cols`` →
``_normalize_cols`` → ``_reduce_cols``) on the (..., columns, B) layout,
producing the same column values; only the carry normalization differs
(a serial ripple here, a carry-lookahead scan there), and both are exact.
"""

from __future__ import annotations

import numpy as np
import torch

from ecfft_tpu_torch.fields.registry import LIMB_MASK, FieldSpec


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


def ones(spec: FieldSpec, shape=(), device=None) -> torch.Tensor:
    return encode(spec, 1, device).expand(*shape, spec.num_limbs)


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


def _reduce_cols(spec: FieldSpec, c):
    """Product columns (..., 2L, B) → canonical value (..., L, B): fold,
    normalize (twice), then subtract p·2^j where it fits, j from the slack
    bound down to 0."""
    L = spec.num_limbs
    c = _normalize_cols(_fold_cols(spec, c))
    c = _normalize_cols(_fold_cols(spec, c))
    slack = 16 * L - spec.p.bit_length()
    js = [0] if slack == 0 else list(range(slack + 1, -1, -1))
    x = c[..., :L + 1, :]
    for comp in _sub_comps(spec, js):
        comp = torch.tensor(comp, dtype=torch.int64, device=c.device)
        y = _normalize_cols(x + comp[:, None])
        need = y[..., L + 1:L + 2, :] > 0
        x = torch.where(need, y[..., :L + 1, :], x)
    return x[..., :L, :]


def check_fold(spec: FieldSpec) -> None:
    """Raise NotImplementedError for a field the port cannot reduce yet."""
    if spec.num_limbs == 1 or spec.fold_terms is None:
        raise NotImplementedError(
            f"{spec.name}: the port's limb arithmetic covers fold-friendly "
            "16-bit-limb primes only; the CIOS Montgomery branch and the "
            "M31 (L=1) step are still to be ported (ROADMAP.md, Queue 2)")


# --------------------------------------------------------- field ops


def mul(spec: FieldSpec, a, b) -> torch.Tensor:
    """Elementwise field product of (..., L) int32 tensors."""
    check_fold(spec)
    c = _conv_cols(spec, a.unsqueeze(-1), b.unsqueeze(-1))
    return _reduce_cols(spec, c)[..., 0].int()


def neg(spec: FieldSpec, a) -> torch.Tensor:
    """−a mod p for (..., L) int32 tensors of 16-bit limbs (zero stays
    zero)."""
    p = torch.tensor(spec.to_limbs(spec.p), dtype=torch.int64,
                     device=a.device)
    d = p - a.long()  # limbwise; a signed ripple restores 16-bit limbs
    out = []
    borrow = torch.zeros_like(d[..., 0])
    for k in range(spec.num_limbs):
        v = d[..., k] + borrow
        out.append(v & LIMB_MASK)
        borrow = v >> 16
    out = torch.stack(out, dim=-1)
    zero = (a == 0).all(dim=-1, keepdim=True)
    return torch.where(zero, torch.zeros_like(out), out).int()
