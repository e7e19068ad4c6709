"""ctypes bindings for the native C++ ECFFT engine (native/ecfft_native.cpp).

The port's counterpart of ``ecfft_tpu/native.py``, bound to the same
source, which ``ops._build.native_library`` compiles into the port's own
build directory. The engine is the port's independent single-core oracle
(4×64 Montgomery arithmetic), the baseline that ``chip_smoke.py`` measures,
and the FFTree builder (:func:`build_tables_native`).

All boundary values are 32-byte little-endian canonical integers.
"""

from __future__ import annotations

import ctypes

import numpy as np

from ecfft_tpu_torch.fields.registry import FIELDS, FieldSpec, build_domain
from ecfft_tpu_torch.ops._build import native_library

_lib = None


def lib() -> ctypes.CDLL:
    """The engine's library, built and loaded on first use."""
    global _lib
    if _lib is None:
        so = ctypes.CDLL(native_library())
        so.ecn_tree_new.restype = ctypes.c_void_p
        so.ecn_tree_new.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                    ctypes.c_uint64, ctypes.c_char_p,
                                    ctypes.c_uint64]
        so.ecn_tree_free.restype = None
        so.ecn_tree_free.argtypes = [ctypes.c_void_p]
        for name in ("ecn_enter", "ecn_exit"):
            fn = getattr(so, name)
            fn.restype = None
            fn.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64,
                           ctypes.c_char_p]
        so.ecn_table.restype = ctypes.c_uint64
        so.ecn_table.argtypes = [ctypes.c_void_p, ctypes.c_uint64,
                                 ctypes.c_int, ctypes.c_char_p]
        so.ecn_mats.restype = ctypes.c_uint64
        so.ecn_mats.argtypes = [ctypes.c_void_p, ctypes.c_uint64,
                                ctypes.c_uint64, ctypes.c_int,
                                ctypes.c_char_p]
        so.ecn_batch_inv.restype = None
        so.ecn_batch_inv.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                     ctypes.c_uint64, ctypes.c_char_p]
        _lib = so
    return _lib


def _pack(vals) -> bytes:
    return b"".join(int(v).to_bytes(32, "little") for v in vals)


def _unpack(buf: bytes) -> list[int]:
    return [int.from_bytes(buf[i:i + 32], "little")
            for i in range(0, len(buf), 32)]


TABLE_IDS = {
    "leaves": 0, "xnn_s": 1, "xnn_s_inv": 2, "z0_s1": 3, "z1_s0": 4,
    "z0_inv_s1": 5, "z1_inv_s0": 6, "z0z0_rem_xnn_s": 7,
    "z1z1_rem_xnn_s": 8,
}


class NativeFFTree:
    """Single-core native FFTree: ENTER/EXIT on python ints, and the
    tables the port's FFTree is built from."""

    def __init__(self, field: str | FieldSpec, n: int,
                 leaves: list[int] | None = None, maps=None):
        self.spec = FIELDS[field] if isinstance(field, str) else field
        self.n = n
        if leaves is None:
            dom = build_domain(self.spec, n)
            if dom is None:
                raise ValueError("n exceeds the field's curve two-adicity")
            leaves, maps = dom
        blob = b""
        for m in maps:
            num = list(m.numerator)
            den = list(m.denominator)
            blob += len(num).to_bytes(4, "little") + _pack(num)
            blob += len(den).to_bytes(4, "little") + _pack(den)
        self._lib = lib()
        self._h = self._lib.ecn_tree_new(
            self.spec.p.to_bytes(32, "little"), _pack(leaves), n, blob,
            len(blob))

    def __del__(self):
        # guard against interpreter-shutdown teardown ordering
        h = getattr(self, "_h", None)
        so = getattr(self, "_lib", None)
        if h and so is not None:
            so.ecn_tree_free(h)
            self._h = None

    def _io(self, fname, vals):
        out = ctypes.create_string_buffer(32 * len(vals))
        getattr(self._lib, fname)(self._h, _pack(vals), len(vals), out)
        return _unpack(out.raw)

    def enter(self, coeffs: list[int]) -> list[int]:
        return self._io("ecn_enter", coeffs)

    def exit(self, evals: list[int]) -> list[int]:
        return self._io("ecn_exit", evals)

    def table(self, size: int, name: str) -> list[int]:
        cnt = self._lib.ecn_table(self._h, size, TABLE_IDS[name], None)
        out = ctypes.create_string_buffer(32 * cnt)
        self._lib.ecn_table(self._h, size, TABLE_IDS[name], out)
        return _unpack(out.raw)

    def mats(self, size: int, depth: int, which: int) -> list[int]:
        cnt = self._lib.ecn_mats(self._h, size, depth, which, None)
        out = ctypes.create_string_buffer(32 * 4 * cnt)
        self._lib.ecn_mats(self._h, size, depth, which, out)
        return _unpack(out.raw)


def batch_inv_limbs(spec: FieldSpec, arr: np.ndarray) -> np.ndarray:
    """Batched modular inverse of an (N, L) 16-bit-limb array (Montgomery's
    trick in the native engine). Requires 16-bit limbs and p < 2^256."""
    if spec.limb_bits != 16 or spec.num_limbs > 16:
        raise NotImplementedError(
            f"{spec.name}: native batch inversion takes 16-bit limbs and "
            "p < 2^256")
    n, L = arr.shape
    rows = np.zeros((n, 16), dtype=np.uint16)
    rows[:, :L] = arr.astype(np.uint16)
    out = ctypes.create_string_buffer(32 * n)
    lib().ecn_batch_inv(spec.p.to_bytes(32, "little"), rows.tobytes(), n,
                        out)
    res = np.frombuffer(out.raw, dtype=np.uint16).reshape(n, 16)
    return res[:, :L].astype(np.uint32)


def _ints_to_limbs(spec: FieldSpec, vals: list[int]) -> np.ndarray:
    """Canonical ints → (n, L) uint32 limb array, through a byte view."""
    raw = b"".join(int(v).to_bytes(32, "little") for v in vals)
    arr = np.frombuffer(raw, dtype=np.uint16).reshape(len(vals), 16)
    out = arr.astype(np.uint32)
    if spec.num_limbs == 1:  # m31: single packed limb
        return (out[:, 0] | (out[:, 1] << 16)).reshape(-1, 1)
    return out[:, :spec.num_limbs]


def build_tables_native(field: str | FieldSpec, n: int) -> dict | None:
    """The FFTree tables of a size-``n`` tree, built by the native engine,
    as numpy uint32 limb arrays in the JAX package's layout:
    ``{m: {name: (rows, L), "mats": [(dec_S0, dec_S1, rec_S0, rec_S1)
    per depth, each (m/4 >> d, 2, 2, L)]}}`` for m = 2, 4, …, n. Mirrors
    ``ecfft_tpu.native.build_fftree_native``; None when n exceeds the
    curve's two-adicity."""
    spec = FIELDS[field] if isinstance(field, str) else field
    dom = build_domain(spec, n)
    if dom is None:
        return None
    nt = NativeFFTree(spec, n, *dom)
    tables: dict[int, dict] = {}
    m = 2
    while m <= n:
        t: dict = {name: _ints_to_limbs(spec, nt.table(m, name))
                   for name in TABLE_IDS}
        t["mats"] = [
            tuple(_ints_to_limbs(spec, nt.mats(m, d, which))
                  .reshape(-1, 2, 2, spec.num_limbs) for which in range(4))
            for d in range(max(m.bit_length() - 2, 0))
        ]
        tables[m] = t
        m *= 2
    return tables
