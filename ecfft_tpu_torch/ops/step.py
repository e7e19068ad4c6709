"""The schedule machine's three in-place affine steps.

Each wrapper updates the window [start, start + A) of a (W, L, B) int32
state in place:

- :func:`aff1s_ip`: state[s+q] ← state[s+q] + C[q]·x2[q]   (OP_AFF1S*)
- :func:`aff1g_ip`: state[s+q] ← x1[q] + C[q]·x2[q]          (OP_AFF1*)
- :func:`aff2g_ip`: state[s+q] ← A[q]·x1[q] + B[q]·x2[q]     (OP_AFFINE*)

with (A, L) coefficient rows and (A, L, B) gathered windows x1, x2. They
replace ``pallas_aff1s_ip``, ``pallas_aff1g_ip`` and ``pallas_aff2g_ip``
of ``ecfft_tpu/ops/pallas_step.py``.

A CUDA tensor goes to the hand-written kernel in ``csrc/step_kernels.cu``
(built at first use by ``ops/_build.py``), or the wrapper raises: there
is no fallback. A CPU tensor goes to the plain PyTorch version beside it
(:func:`_muladd1_cols`, :func:`_muladd2_cols`), which mirrors the JAX
package's XLA step in int64. Each wrapper counts its kernel launches in
its ``launches`` attribute; the plain path does not count.

x1 and x2 must be buffers of their own, never views of the state: the
in-place write is race-free only because every thread reads its inputs
from them (or, for the self-read step, from the one state element it
writes).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ecfft_tpu_torch.fields import device as fd
from ecfft_tpu_torch.fields.registry import FieldSpec

KERNEL_LIMBS = 16  # the kernels' compile-time limb count


# ------------------------------------------------------- plain versions


def _muladd1_cols(spec: FieldSpec, C, x1, x2):
    """x1 + C·x2 in the (W, L, B) layout, in int64 (C: (W, L, 1)). As the
    JAX step does, x1 joins the product columns before the reduction (it
    is smaller than a second product, so the two-product bounds cover
    it)."""
    c = fd._conv_cols(spec, C, x2)
    c[..., :spec.num_limbs, :] += x1.long()
    return fd._reduce_cols(spec, c)


def _muladd2_cols(spec: FieldSpec, A, x1, B, x2):
    """A·x1 + B·x2 in the (W, L, B) layout, in int64 (A, B: (W, L, 1))."""
    c = fd._conv_cols(spec, A, x1) + fd._conv_cols(spec, B, x2)
    return fd._reduce_cols(spec, c)


# --------------------------------------------------------------- kernels

_lib = None


def load_kernels() -> ctypes.CDLL:
    """Build (if stale) and load the step kernels' library."""
    global _lib
    if _lib is None:
        from ecfft_tpu_torch.ops._build import kernel_library

        so = ctypes.CDLL(kernel_library())
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        for name, n_ptrs in (("ecfft_aff1s_ip", 3), ("ecfft_aff1g_ip", 4),
                             ("ecfft_aff2g_ip", 5)):
            fn = getattr(so, name)
            fn.restype = i32
            # field, tensor pointers, start, A, B, stream
            fn.argtypes = [ptr] + [ptr] * n_ptrs + [i32, i32, i32, ptr]
        so.ecfft_error_string.restype = ctypes.c_char_p
        so.ecfft_error_string.argtypes = [i32]
        _lib = so
    return _lib


class _Field(ctypes.Structure):
    """Mirror of ``struct Field`` in step_kernels.cu."""
    _fields_ = [("p", ctypes.c_uint32 * KERNEL_LIMBS),
                ("f", ctypes.c_uint32 * KERNEL_LIMBS),
                ("slack", ctypes.c_int)]


@functools.lru_cache(maxsize=None)
def _field(spec: FieldSpec) -> _Field:
    """The kernels' field constants: p's limbs, the limbs of the fold
    multiplier F = 2^(16L) mod p, and the slack 16L − bitlen(p)."""
    L = spec.num_limbs
    if (L != KERNEL_LIMBS or spec.limb_bits != 16 or spec.fold_terms is None
            or sum(d for _, d in spec.fold_terms) >= 1 << 10):
        raise NotImplementedError(
            f"{spec.name}: the CUDA step kernels take fold-friendly primes "
            "with 16 limbs of 16 bits (fold digits summing below 2^10); "
            "the CIOS Montgomery branch and the M31 (L=1) step are still "
            "to be ported (ROADMAP.md, Queue 2)")
    f = [0] * L
    for off, digit in spec.fold_terms:
        f[off] += digit
    return _Field((ctypes.c_uint32 * L)(*spec.to_limbs(spec.p)),
                  (ctypes.c_uint32 * L)(*f), 16 * L - spec.p.bit_length())


def _launch(name: str, spec: FieldSpec, tensors, state, start: int,
            A: int) -> None:
    fn = getattr(load_kernels(), name)
    fld = _field(spec)
    with torch.cuda.device(state.device):
        stream = torch.cuda.current_stream(state.device).cuda_stream
        err = fn(ctypes.byref(fld), *(t.data_ptr() for t in tensors),
                 state.data_ptr(), start, A, state.shape[2], stream)
    if err:
        raise RuntimeError(f"{name} launch failed: "
                           f"{load_kernels().ecfft_error_string(err)}")


# -------------------------------------------------------------- wrappers


def _check(spec: FieldSpec, state, start: int, coeffs, windows) -> int:
    """Validate a step's operands; returns the window height A."""
    fd.check_fold(spec)
    if state.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {state.device}")
    if state.dim() != 3 or state.shape[1] != spec.num_limbs:
        raise ValueError(f"state must be (W, {spec.num_limbs}, B), got "
                         f"{tuple(state.shape)}")
    W, L, B = state.shape
    A = windows[0].shape[0]
    for t in (state, *coeffs, *windows):
        if t.device != state.device:
            raise ValueError(f"operand on {t.device}, state on "
                             f"{state.device}")
        if t.dtype != torch.int32:
            raise TypeError(f"operands must be int32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("operands must be contiguous")
    for c in coeffs:
        if tuple(c.shape) != (A, L):
            raise ValueError(f"coefficients must be ({A}, {L}), got "
                             f"{tuple(c.shape)}")
    for w in windows:
        if tuple(w.shape) != (A, L, B):
            raise ValueError(f"windows must be ({A}, {L}, {B}), got "
                             f"{tuple(w.shape)}")
        if w.untyped_storage().data_ptr() == \
                state.untyped_storage().data_ptr():
            raise ValueError("a gathered window may not share the "
                             "state's storage")
    if A == 0 or B == 0 or not 0 <= start <= W - A:
        raise ValueError(f"window [{start}, {start + A}) outside the "
                         f"state's {W} rows, or empty")
    return A


def aff1s_ip(spec: FieldSpec, C, state, x2, start: int) -> None:
    """state[start+q] ← state[start+q] + C[q]·x2[q] in place (OP_AFF1S)."""
    A = _check(spec, state, start, (C,), (x2,))
    if state.is_cuda:
        _launch("ecfft_aff1s_ip", spec, (C, x2), state, start, A)
        aff1s_ip.launches += 1
        return
    win = state[start:start + A]
    win.copy_(_muladd1_cols(spec, C.unsqueeze(-1), win, x2))


def aff1g_ip(spec: FieldSpec, C, state, x1, x2, start: int) -> None:
    """state[start+q] ← x1[q] + C[q]·x2[q] in place (OP_AFF1)."""
    A = _check(spec, state, start, (C,), (x1, x2))
    if state.is_cuda:
        _launch("ecfft_aff1g_ip", spec, (C, x1, x2), state, start, A)
        aff1g_ip.launches += 1
        return
    state[start:start + A] = _muladd1_cols(spec, C.unsqueeze(-1), x1, x2)


def aff2g_ip(spec: FieldSpec, A_, B_, state, x1, x2, start: int) -> None:
    """state[start+q] ← A[q]·x1[q] + B[q]·x2[q] in place (OP_AFFINE)."""
    A = _check(spec, state, start, (A_, B_), (x1, x2))
    if state.is_cuda:
        _launch("ecfft_aff2g_ip", spec, (A_, B_, x1, x2), state, start, A)
        aff2g_ip.launches += 1
        return
    state[start:start + A] = _muladd2_cols(spec, A_.unsqueeze(-1), x1,
                                           B_.unsqueeze(-1), x2)


aff1s_ip.launches = 0
aff1g_ip.launches = 0
aff2g_ip.launches = 0
STEP_WRAPPERS = (aff1s_ip, aff1g_ip, aff2g_ip)


def mul_rows(spec: FieldSpec, a, b):
    """(N, L) × (N, L) field product through the self-read step with a
    one-lane batch: out = 0 + a·b. The D-engine's row products run here,
    so on a card they are kernel launches too."""
    out = torch.zeros((a.shape[0], a.shape[1], 1), dtype=torch.int32,
                      device=a.device)
    aff1s_ip(spec, a.contiguous(), out, b.contiguous().unsqueeze(-1), 0)
    return out.squeeze(-1)
