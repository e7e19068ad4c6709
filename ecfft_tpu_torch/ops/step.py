"""The schedule machine's affine steps, each writing a window of a state.

The in-place wrappers update the window [start, start + A) of a
(W, L, B) int32 state:

- :func:`aff1s_ip`: state[s+q] ← state[s+q] + C[q]·x2[q]   (OP_AFF1S*)
- :func:`aff1g_ip`: state[s+q] ← x1[q] + C[q]·x2[q]          (OP_AFF1*)
- :func:`aff2g_ip`: state[s+q] ← A[q]·x1[q] + B[q]·x2[q]     (OP_AFFINE*)

with (A, L) coefficient rows and (A, L, B) gathered windows x1, x2. They
replace ``pallas_aff1s_ip``, ``pallas_aff1g_ip`` and ``pallas_aff2g_ip``
of ``ecfft_tpu/ops/pallas_step.py``. Their pair form reads x2 from the
window itself, at the partner row q XOR h (h a power of two, A a
multiple of 2h) or, where the step's index row names it, at row q
itself, and the two-product step x1 as the window itself, so that
nothing is gathered (the word forms; M31's kernels have none):

- :func:`aff1s_pair_ip`: state[s+q] ← state[s+q] + C[q]·state[r[q]]
- :func:`aff2g_pair_ip`: state[s+q] ← A[q]·state[s+q] + B[q]·state[r[q]]

The muladd pair replaces the out-of-place ``pallas_muladd1``/
``pallas_muladd2`` (the unrolled executor's generic steps) and writes rows
[start, start + A) of an output of the caller's choosing: the state
itself, or a new window (start 0):

- :func:`muladd1`: out[s+q] ← x1[q] + C[q]·x2[q]
- :func:`muladd2`: out[s+q] ← A[q]·x1[q] + B[q]·x2[q]

:func:`mulss` is the state×state product of OP_MUL steps (VANISH's merges,
the general-modulus REDC/MOD), which the JAX package leaves to XLA
(``_mulss``, ``ecfft_tpu/ops/schedule.py``): both factors are gathered
windows, and it reads no coefficient row:

- :func:`mulss`: out[s+q] ← x1[q]·x2[q]

A CUDA tensor goes to the hand-written kernel, or the wrapper raises: there
is no fallback. :func:`kernel_form` names the form of the kernels that
takes a field: "m31" (``csrc/m31_kernels.cu``, one 32-bit word an
element), or a word form of ``csrc/step_kernels.cu`` and
``csrc/fused_kernels.cu`` for L = 1 … 16 limbs of 16 bits, "fold<L>" for
a prime with a pseudo-Mersenne fold (secp256k1 is "fold16", M61 "fold4",
a prime below 2^16 such as 97 or 64513 "fold1") or "cios<L>" for any
other of 2 limbs or more (Montgomery residents, CIOS reduction). Each
form's library is built at its first use (``ops/_build.py``). A CPU tensor
goes to the plain PyTorch version beside it (:func:`_muladd1_cols`,
:func:`_muladd2_cols`, :func:`_mulss_cols`), which mirrors the JAX
package's XLA step in int64. Each wrapper counts its kernel launches per
form in its ``launches`` Counter, and per form, rows and lanes in its
``shapes`` Counter; the plain path does not count. A pair-form launch
counts as a launch of its step (``aff1s_ip`` or ``aff2g_ip``, whose
kernel function it runs), and in its own wrapper's counts besides.

For the in-place steps x1 and x2 must be buffers of their own, never
views of the state: the in-place write is race-free only because every
thread reads its inputs from them (or, for the self-read step, from the
one state element it writes). The muladd pair also takes x1 as the very
window it writes (OP_AFF1S), for the same reason. :func:`mulss` takes no
view of its output at all; its two factors may be one buffer (a square).
The pair form reads the partner rows in place: a block of its kernel
holds both rows of each pair it writes, and they cross in shared memory.
"""

from __future__ import annotations

import collections
import ctypes
import functools

import torch

from ecfft_tpu_torch.fields import device as fd
from ecfft_tpu_torch.fields.registry import FieldSpec
from ecfft_tpu_torch.utils import profiling

MAX_LIMBS = 16  # the word forms' largest limb count (p < 2^256)
MAX_WORDS = 8  # the same element in 32-bit words (csrc/word_arith.cuh)


# ------------------------------------------------------- plain versions


def _muladd1_cols(spec: FieldSpec, C, x1, x2):
    """x1 + C·x2 in the (W, L, B) layout, in int64 (C: (W, L, 1)). As the
    JAX step does, x1 joins the product columns before the fold's
    reduction (it is smaller than a second product, so the two-product
    bounds cover it); with Montgomery residents it is added to the reduced
    product with one conditional subtract; M31 adds it to the reduced
    product."""
    if fd.is_m31(spec):
        return fd._m31_add(x1, fd._m31_mul(C, x2))
    c = fd._conv_cols(spec, C, x2)
    if fd.is_mont(spec):
        return fd._add_canon(spec, fd._mont_reduce_cols(spec, c), x1)
    c[..., :spec.num_limbs, :] += x1.long()
    return fd._reduce_cols(spec, c)


def _muladd2_cols(spec: FieldSpec, A, x1, B, x2):
    """A·x1 + B·x2 in the (W, L, B) layout, in int64 (A, B: (W, L, 1)):
    one reduction of the two products' columns (a Montgomery one for
    Montgomery residents)."""
    if fd.is_m31(spec):
        return fd._m31_add(fd._m31_mul(A, x1), fd._m31_mul(B, x2))
    c = fd._conv_cols(spec, A, x1) + fd._conv_cols(spec, B, x2)
    if fd.is_mont(spec):
        return fd._mont_reduce_cols(spec, c)
    return fd._reduce_cols(spec, c)


def _mulss_cols(spec: FieldSpec, x1, x2):
    """x1·x2 elementwise in the (W, L, B) layout, in int64: the product's
    columns and one reduction (a Montgomery one for Montgomery
    residents), both factors batched."""
    if fd.is_m31(spec):
        return fd._m31_mul(x1, x2)
    c = fd._conv_cols(spec, x1, x2)
    if fd.is_mont(spec):
        return fd._mont_reduce_cols(spec, c)
    return fd._reduce_cols(spec, c)


# --------------------------------------------------------------- kernels

_libs: dict = {}  # form → the loaded library


# (tensor pointers, ints) of each kernel's C interface after the field
# constants; a stream pointer follows them
_SIGNATURES = {
    "ecfft_aff1s_ip": (3, 3), "ecfft_aff1g_ip": (4, 3),
    "ecfft_aff2g_ip": (5, 3), "ecfft_muladd1": (4, 3),
    "ecfft_muladd2": (5, 3), "ecfft_fused_bf1": (2, 4),
    "ecfft_fused_bf2": (3, 4), "ecfft_fused_cascade": (4, 4),
    "ecfft_mulss": (3, 3), "ecfft_aff1s_pair_ip": (3, 4),
    "ecfft_aff2g_pair_ip": (4, 4),
}
_WORD_ONLY = ("ecfft_aff1s_pair_ip", "ecfft_aff2g_pair_ip")  # no M31 form


def load_kernels(form: str = "fold16") -> ctypes.CDLL:
    """Build (if stale) and load the kernels' library of ``form``."""
    if form not in _libs:
        from ecfft_tpu_torch.ops._build import kernel_library

        profiling.loaded()
        so = ctypes.CDLL(kernel_library(form))
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        for name, (n_ptrs, n_ints) in _SIGNATURES.items():
            if form == "m31":  # the same arguments without the constants
                if name in _WORD_ONLY:
                    continue
                fn = getattr(so, _m31_name(name))
                fn.argtypes = [ptr] * n_ptrs + [i32] * n_ints + [ptr]
            else:
                fn = getattr(so, name)
                fn.argtypes = [ptr] + [ptr] * n_ptrs + [i32] * n_ints + [ptr]
            fn.restype = i32
        so.ecfft_error_string.restype = ctypes.c_char_p
        so.ecfft_error_string.argtypes = [i32]
        _libs[form] = so
    return _libs[form]


class _Field(ctypes.Structure):
    """Mirror of ``struct Field`` in csrc/word_arith.cuh."""
    _fields_ = [("pw", ctypes.c_uint32 * MAX_WORDS),
                ("fw", ctypes.c_uint32 * MAX_WORDS),
                ("np", ctypes.c_uint32),
                ("np16", ctypes.c_uint32),
                ("slack", ctypes.c_int),
                ("nw", ctypes.c_int),
                ("mont", ctypes.c_int)]


def _m31_name(name: str) -> str:
    """The M31 form's entry point: ecfft_aff1s_ip → ecfft_m31_aff1s_ip."""
    return "ecfft_m31_" + name[len("ecfft_"):]


@functools.lru_cache(maxsize=None)
def kernel_form(spec: FieldSpec) -> str:
    """The form of the kernels that takes ``spec``: "m31", "fold<L>" (L
    limbs of 16 bits and a pseudo-Mersenne fold, ``spec.fold_terms``, for
    L = 1 … 16) or "cios<L>" (no fold: Montgomery residents, as the JAX
    package keeps them, for L = 2 … 16). Raises NotImplementedError naming
    the cause for any other field: a prime below 2^16 without a fold
    (:func:`fields.device.check_fold`), or one of more than 16 limbs."""
    fd.check_fold(spec)
    if fd.is_m31(spec):
        return "m31"
    if spec.num_limbs > MAX_LIMBS or spec.limb_bits != 16:
        raise NotImplementedError(
            f"{spec.name}: no CUDA kernel takes this field: it has "
            f"{spec.num_limbs} limbs of {spec.limb_bits} bits, and the "
            f"kernels take 2 to {MAX_LIMBS} limbs of 16 bits (p < 2^256) or "
            "M31's one 32-bit word")
    return f"{'cios' if fd.is_mont(spec) else 'fold'}{spec.num_limbs}"


def pair_form(spec: FieldSpec) -> bool:
    """Whether the kernels of ``spec``'s form have the pair form of the
    self-read and two-product steps (:func:`aff1s_pair_ip`,
    :func:`aff2g_pair_ip`): every word form; M31's kernels have none, and
    a field that no kernel takes has none."""
    try:
        return kernel_form(spec) != "m31"
    except NotImplementedError:
        return False


def _words(v: int):
    return (ctypes.c_uint32 * MAX_WORDS)(*((v >> 32 * k) & 0xFFFFFFFF
                                           for k in range(MAX_WORDS)))


@functools.lru_cache(maxsize=None)
def _field(spec: FieldSpec) -> _Field:
    """The word forms' field constants: p in 32-bit words; the fold form's
    multiplier F = 2^(16L) mod p in words, or the CIOS form's n' = −p⁻¹
    mod 2^32 and mod 2^16; the slack 16L − bitlen(p); the word count and
    the form, which the kernels check against their own."""
    form = kernel_form(spec)
    if form == "m31":
        raise ValueError(f"{spec.name}: the M31 kernels take no field "
                         "constants")
    mont = form.startswith("cios")
    L = spec.num_limbs
    F = 0 if mont else spec.r_mod_p
    np_ = (-pow(spec.p, -1, 1 << 32)) % (1 << 32) if mont else 0
    return _Field(_words(spec.p), _words(F), np_, np_ & 0xFFFF,
                  16 * L - spec.p.bit_length(), (L + 1) // 2, int(mont))


def launch(name: str, spec: FieldSpec, device, *args) -> None:
    """Call kernel ``name`` of the form that takes ``spec`` on
    ``device``'s current stream: the M31 form with ``args``, a word form
    with the field's constants, then ``args``. Tensors go as their data
    pointers, the rest (ints, ctypes references) as they are. Raises on a
    refused launch."""
    form = kernel_form(spec)
    lib = load_kernels(form)
    if form == "m31":
        name, lead = _m31_name(name), ()
    else:
        lead = (ctypes.byref(_field(spec)),)
    fn = getattr(lib, name)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*lead, *(a.data_ptr() if isinstance(a, torch.Tensor) else a
                          for a in args), stream)
    if err:
        raise RuntimeError(f"{name} launch failed: "
                           f"{lib.ecfft_error_string(err)}")


def count(wrapper, spec: FieldSpec, rows: int, lanes: int) -> None:
    """One launch more of ``wrapper``'s kernel, in the count of its form
    (``launches``) and in that of its form over a window of ``rows`` rows
    and ``lanes`` lanes (``shapes``)."""
    form = kernel_form(spec)
    wrapper.launches[form] += 1
    wrapper.shapes[(form, rows, lanes)] += 1


# -------------------------------------------------------------- wrappers


def check_operands(spec: FieldSpec, device, tensors, coeffs, windows,
                   A: int, B: int) -> None:
    """Every tensor int32, contiguous and on ``device``; coefficient rows
    (A, L), windows (A, L, B), none of them empty."""
    fd.check_fold(spec)
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")
    L = spec.num_limbs
    for t in (*tensors, *coeffs, *windows):
        if t.device != device:
            raise ValueError(f"operand on {t.device}, state on {device}")
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
    if A == 0 or B == 0:
        raise ValueError("empty window")


def check_state(spec: FieldSpec, state, start: int, A: int) -> None:
    """A (W, L, B) state whose rows hold the window [start, start + A)."""
    if state.dim() != 3 or state.shape[1] != spec.num_limbs:
        raise ValueError(f"state must be (W, {spec.num_limbs}, B), got "
                         f"{tuple(state.shape)}")
    if not 0 <= start <= state.shape[0] - A:
        raise ValueError(f"window [{start}, {start + A}) outside the "
                         f"state's {state.shape[0]} rows")


def _check(spec: FieldSpec, state, start: int, coeffs, windows) -> int:
    """Validate an in-place step's operands; returns the window height A."""
    check_state(spec, state, start, 0)
    A = windows[0].shape[0]
    check_operands(spec, state.device, (state,), coeffs, windows, A,
                   state.shape[2])
    for w in windows:
        if w.untyped_storage().data_ptr() == \
                state.untyped_storage().data_ptr():
            raise ValueError("a gathered window may not share the "
                             "state's storage")
    check_state(spec, state, start, A)
    return A


def aff1s_ip(spec: FieldSpec, C, state, x2, start: int) -> None:
    """state[start+q] ← state[start+q] + C[q]·x2[q] in place (OP_AFF1S)."""
    A = _check(spec, state, start, (C,), (x2,))
    if state.is_cuda:
        launch("ecfft_aff1s_ip", spec, state.device, C, x2, state, start,
               A, state.shape[2])
        count(aff1s_ip, spec, A, state.shape[2])
        return
    win = state[start:start + A]
    win.copy_(_muladd1_cols(spec, C.unsqueeze(-1), win, x2))


def aff1g_ip(spec: FieldSpec, C, state, x1, x2, start: int) -> None:
    """state[start+q] ← x1[q] + C[q]·x2[q] in place (OP_AFF1)."""
    A = _check(spec, state, start, (C,), (x1, x2))
    if state.is_cuda:
        launch("ecfft_aff1g_ip", spec, state.device, C, x1, x2, state,
               start, A, state.shape[2])
        count(aff1g_ip, spec, A, state.shape[2])
        return
    state[start:start + A] = _muladd1_cols(spec, C.unsqueeze(-1), x1, x2)


def aff2g_ip(spec: FieldSpec, A_, B_, state, x1, x2, start: int) -> None:
    """state[start+q] ← A[q]·x1[q] + B[q]·x2[q] in place (OP_AFFINE)."""
    A = _check(spec, state, start, (A_, B_), (x1, x2))
    if state.is_cuda:
        launch("ecfft_aff2g_ip", spec, state.device, A_, B_, x1, x2, state,
               start, A, state.shape[2])
        count(aff2g_ip, spec, A, state.shape[2])
        return
    state[start:start + A] = _muladd2_cols(spec, A_.unsqueeze(-1), x1,
                                           B_.unsqueeze(-1), x2)


def _check_pair(spec: FieldSpec, state, start: int, coeffs, h: int,
                x2) -> int:
    """Validate a pair step's operands; returns the window height A, the
    coefficient rows' (A, L): h must be a power of two with A a multiple
    of 2h, so that q XOR h stays in the window, and the index row x2 an
    (A,) int32 tensor beside the state."""
    check_state(spec, state, start, 0)
    A = coeffs[0].shape[0] if coeffs[0].dim() == 2 else 0
    check_operands(spec, state.device, (state,), coeffs, (), A,
                   state.shape[2])
    if h < 1 or h & (h - 1) or A % (2 * h):
        raise ValueError(f"partner distance {h} must be a power of two with "
                         f"{A} rows a multiple of {2 * h}")
    if (x2.dtype != torch.int32 or tuple(x2.shape) != (A,)
            or x2.device != state.device or not x2.is_contiguous()):
        raise ValueError(f"the index row must be ({A},) int32 on "
                         f"{state.device}, got {tuple(x2.shape)} {x2.dtype}")
    check_state(spec, state, start, A)
    return A


def _pair_window(state, start: int, A: int, h: int, x2):
    """A copy of what a pair step reads as x2: row q of the window holds
    the state's row start + q where ``x2[q]`` names it, else start +
    (q XOR h)."""
    q = torch.arange(A, device=state.device)
    return state.index_select(0, torch.where(x2 == start + q, start + q,
                                             start + (q ^ h)))


def _launch_pair(wrapper, step_wrapper, name: str, spec: FieldSpec, state,
                 *args) -> None:
    """Launch pair kernel ``name`` on ``args`` (the rows, the index row,
    the state, then start, h, A and B), counted under its step's wrapper
    and its own."""
    if not pair_form(spec):
        raise NotImplementedError(f"{spec.name}: the {kernel_form(spec)} "
                                  "kernels have no pair form")
    launch(name, spec, state.device, *args)
    count(step_wrapper, spec, args[-2], args[-1])
    count(wrapper, spec, args[-2], args[-1])


def aff1s_pair_ip(spec: FieldSpec, C, state, h: int, start: int,
                  x2) -> None:
    """state[start+q] ← state[start+q] + C[q]·state[r] in place (OP_AFF1S
    whose x2 lies in its own pair of rows): r = start + q where the step's
    int32 index row ``x2`` holds that row, else the partner start +
    (q XOR h)."""
    A = _check_pair(spec, state, start, (C,), h, x2)
    if state.is_cuda:
        _launch_pair(aff1s_pair_ip, aff1s_ip, "ecfft_aff1s_pair_ip", spec,
                     state, C, x2, state, start, h, A, state.shape[2])
        return
    win = state[start:start + A]
    win.copy_(_muladd1_cols(spec, C.unsqueeze(-1), win,
                            _pair_window(state, start, A, h, x2)))


def aff2g_pair_ip(spec: FieldSpec, A_, B_, state, h: int, start: int,
                  x2) -> None:
    """state[start+q] ← A[q]·state[start+q] + B[q]·state[r] in place
    (OP_AFFINE whose x1 is the window and whose x2 lies in its own pair of
    rows; r as :func:`aff1s_pair_ip`'s)."""
    A = _check_pair(spec, state, start, (A_, B_), h, x2)
    if state.is_cuda:
        _launch_pair(aff2g_pair_ip, aff2g_ip, "ecfft_aff2g_pair_ip", spec,
                     state, A_, B_, x2, state, start, h, A, state.shape[2])
        return
    state[start:start + A] = _muladd2_cols(
        spec, A_.unsqueeze(-1), state[start:start + A], B_.unsqueeze(-1),
        _pair_window(state, start, A, h, x2))


def _check_out(spec: FieldSpec, coeffs, x1, x2, out, start: int) -> int:
    """Validate a muladd's operands; returns the window height A. Rows
    [start, start + A) of ``out`` are written, so no window may share its
    storage except x1 as exactly those rows."""
    if x2.dim() != 3:
        raise ValueError(f"windows must be (A, L, B), got {tuple(x2.shape)}")
    A = x2.shape[0]
    check_state(spec, out, start, A)
    check_operands(spec, out.device, (out,), coeffs, (x1, x2), A,
                   out.shape[2])
    own = out.untyped_storage().data_ptr()
    if x2.untyped_storage().data_ptr() == own or (
            x1.untyped_storage().data_ptr() == own
            and x1.data_ptr() != out[start].data_ptr()):
        raise ValueError("only x1 may share the output's storage, and only "
                         "as the window it writes")
    return A


def muladd1(spec: FieldSpec, C, x1, x2, out, start: int) -> None:
    """out[start+q] ← x1[q] + C[q]·x2[q] for a (W, L, B) ``out``: the
    state, x1 possibly its own window, or a buffer of its own."""
    A = _check_out(spec, (C,), x1, x2, out, start)
    if out.is_cuda:
        launch("ecfft_muladd1", spec, out.device, C, x1, x2, out, start, A,
               out.shape[2])
        count(muladd1, spec, A, out.shape[2])
        return
    out[start:start + A] = _muladd1_cols(spec, C.unsqueeze(-1), x1, x2)


def muladd2(spec: FieldSpec, A_, B_, x1, x2, out, start: int) -> None:
    """out[start+q] ← A[q]·x1[q] + B[q]·x2[q] (as :func:`muladd1`)."""
    A = _check_out(spec, (A_, B_), x1, x2, out, start)
    if out.is_cuda:
        launch("ecfft_muladd2", spec, out.device, A_, B_, x1, x2, out, start,
               A, out.shape[2])
        count(muladd2, spec, A, out.shape[2])
        return
    out[start:start + A] = _muladd2_cols(spec, A_.unsqueeze(-1), x1,
                                         B_.unsqueeze(-1), x2)


def mulss(spec: FieldSpec, x1, x2, out, start: int) -> None:
    """out[start+q] ← x1[q]·x2[q] for a (W, L, B) ``out`` (OP_MUL). x1 and
    x2 are (A, L, B) windows in buffers of their own (a gathered row may lie
    inside the window that is written), and may be the same buffer."""
    if x2.dim() != 3:
        raise ValueError(f"windows must be (A, L, B), got {tuple(x2.shape)}")
    A = x2.shape[0]
    check_state(spec, out, start, A)
    check_operands(spec, out.device, (out,), (), (x1, x2), A, out.shape[2])
    own = out.untyped_storage().data_ptr()
    if own in (x1.untyped_storage().data_ptr(),
               x2.untyped_storage().data_ptr()):
        raise ValueError("a factor may not share the output's storage")
    if out.is_cuda:
        launch("ecfft_mulss", spec, out.device, x1, x2, out, start, A,
               out.shape[2])
        count(mulss, spec, A, out.shape[2])
        return
    out[start:start + A] = _mulss_cols(spec, x1, x2)


STEP_WRAPPERS = (aff1s_ip, aff1g_ip, aff2g_ip, muladd1, muladd2, mulss)
PAIR_WRAPPERS = (aff1s_pair_ip, aff2g_pair_ip)  # counted in a step's too
for _w in (*STEP_WRAPPERS, *PAIR_WRAPPERS):
    _w.launches = collections.Counter()
    _w.shapes = collections.Counter()


def mul_rows(spec: FieldSpec, a, b):
    """(N, L) × (N, L) field product through the self-read step with a
    one-lane batch: out = 0 + a·b (a Montgomery product for Montgomery
    residents). The D-engine's row products and the pool's conversion into
    Montgomery form run here, so on a card they are kernel launches too."""
    out = torch.zeros((a.shape[0], a.shape[1], 1), dtype=torch.int32,
                      device=a.device)
    aff1s_ip(spec, a.contiguous(), out, b.contiguous().unsqueeze(-1), 0)
    return out.squeeze(-1)


# ------------------------------------- field products on the kernels
#
# The products of the unscheduled algorithms (``ops/core.py``) and the
# device bootstrap (``fftree.py``): each is a launch of the kernels above
# on a CUDA tensor, and their plain version on a CPU one, so both devices
# run one path. The kernels of a "cios" form return a·b·R⁻¹; here every
# value stays canonical: a table that multiplies a window is carried in
# the residents' form (:func:`to_resident`, t·R mod p), so the muladd pair
# returns x1 + C·x2 and A·x1 + B·x2 themselves, and a product of two
# computed values takes a second launch by R² mod p (:func:`mul_windows`).


def const_rows(spec: FieldSpec, value: int, rows: int, device):
    """``rows`` coefficient rows of one constant, (rows, L) int32."""
    return fd.encode(spec, value, device).expand(
        rows, spec.num_limbs).contiguous()


def to_resident(spec: FieldSpec, rows):
    """(N, L) canonical rows in the residents' form: with Montgomery
    residents rows·R mod p, by one self-read product by R² mod p a row (a
    launch on the card; the JAX package's ``_pool_to_mont``), else
    ``rows``. A product by such rows leaves the other factor's form."""
    if not fd.is_mont(spec):
        return rows
    return mul_rows(spec, const_rows(spec, spec.r2_mod_p, rows.shape[0],
                                     rows.device), rows)


def mul_window(spec: FieldSpec, c, x, add=None):
    """add + c[q]·x[q] for (A, L) coefficient rows ``c`` in the residents'
    form and an (A, L, B) window ``x``, into a new window; ``add`` an
    (A, L, B) window or None (zero). One muladd1 launch."""
    out = torch.zeros_like(x) if add is None else torch.empty_like(x)
    muladd1(spec, c, out if add is None else add, x, out, 0)
    return out


def mul2_window(spec: FieldSpec, a, b, x1, x2):
    """a[q]·x1[q] + b[q]·x2[q] for (A, L) coefficient rows in the
    residents' form and (A, L, B) windows, into a new window. One muladd2
    launch."""
    out = torch.empty_like(x1)
    muladd2(spec, a, b, x1, x2, out, 0)
    return out


def mul_windows(spec: FieldSpec, x1, x2):
    """x1·x2 of two canonical (A, L, B) windows, canonical, into a new
    window: one mulss launch, and with Montgomery residents one muladd1 by
    R² mod p rows to cancel its R⁻¹. The factors may be one buffer."""
    out = torch.empty_like(x1)
    mulss(spec, x1, x2, out, 0)
    if fd.is_mont(spec):
        out = mul_window(spec, const_rows(spec, spec.r2_mod_p,
                                          out.shape[0], out.device), out)
    return out


def _as_window(spec: FieldSpec, t):
    """A (..., L) tensor as an (N, L, 1) contiguous window."""
    return t.reshape(-1, spec.num_limbs, 1).contiguous()


def mul(spec: FieldSpec, a, b):
    """The canonical product of canonical (..., L) int32 tensors (they
    broadcast) on the kernels: one-lane windows through
    :func:`mul_windows`."""
    a, b = torch.broadcast_tensors(a, b)
    return mul_windows(spec, _as_window(spec, a),
                       _as_window(spec, b)).reshape(a.shape)


def square(spec: FieldSpec, a):
    """a² on the kernels (mulss with one buffer as both factors)."""
    w = _as_window(spec, a)
    return mul_windows(spec, w, w).reshape(a.shape)


def _mont_product(spec: FieldSpec, a, b):
    """a·b·R⁻¹ of (..., L) tensors in Montgomery form: one mulss launch."""
    out = torch.empty_like(_as_window(spec, a))
    mulss(spec, _as_window(spec, a), _as_window(spec, b), out, 0)
    return out.reshape(a.shape)


def pow_int(spec: FieldSpec, a, e: int):
    """a^e on the kernels (``fields.device.pow_int``'s square-and-multiply).
    With Montgomery residents the chain runs in Montgomery form, one mulss
    a product, between a conversion in and one out."""
    if not fd.is_mont(spec) or e == 0:
        return fd.pow_int(spec, a, e, product=mul)
    rows = a.reshape(-1, spec.num_limbs).contiguous()
    r = fd.pow_int(spec, to_resident(spec, rows), e, product=_mont_product)
    return mul_rows(spec, const_rows(spec, 1, r.shape[0], r.device),
                    r).reshape(a.shape)


def inv(spec: FieldSpec, a):
    """a^(p−2) on the kernels, zero mapped to zero."""
    return fd.inv(spec, a, power=pow_int)


def fused_muladd2(spec: FieldSpec, a1, x1, a2, x2):
    """a1·x1 + a2·x2 of canonical (..., L) tensors of one shape on the
    muladd2 kernel (the JAX package's fused ``muladd2``): a1 and a2 as
    coefficient rows, x1 and x2 as one-lane windows."""
    shape = x1.shape
    rows = [to_resident(spec, t.reshape(-1, spec.num_limbs).contiguous())
            for t in (a1, a2)]
    return mul2_window(spec, rows[0], rows[1], _as_window(spec, x1),
                       _as_window(spec, x2)).reshape(shape)


def mat2_apply(spec: FieldSpec, m, v0, v1):
    """The 2×2 matrix–vector product of ``fields.device.mat2_apply`` on
    the muladd2 kernel: two launches."""
    return (fused_muladd2(spec, m[..., 0, 0, :], v0, m[..., 0, 1, :], v1),
            fused_muladd2(spec, m[..., 1, 0, :], v0, m[..., 1, 1, :], v1))
