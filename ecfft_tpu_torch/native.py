"""ctypes bindings for the native C++ ECFFT engine (native/ecfft_native.cpp).

The port's counterpart of ``ecfft_tpu/native.py``, bound to the same
source, which ``ops._build.native_library`` compiles into the port's own
build directory. The engine is the port's independent single-core oracle
(4×64 Montgomery arithmetic), the baseline that ``chip_smoke.py`` measures,
the FFTree builder (:func:`build_tree_native`), FIND_CURVE's search
for a fresh prime's curve (:func:`find_curve_native`,
:func:`find_curve_parallel`), the Frobenius trace behind Schoof's count
(:func:`schoof_trace_native`) and the single-core Montgomery product's
latency (:func:`mont_mul_ns`); these four have the source of their
originals.

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
        for name in ("ecn_enter", "ecn_exit", "ecn_vanish"):
            fn = getattr(so, name)
            fn.restype = None
            fn.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64,
                           ctypes.c_char_p]
        for name in ("ecn_extend", "ecn_mextend"):
            fn = getattr(so, name)
            fn.restype = None
            fn.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64,
                           ctypes.c_int, ctypes.c_char_p]
        so.ecn_degree.restype = ctypes.c_uint64
        so.ecn_degree.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                  ctypes.c_uint64]
        so.ecn_redc.restype = None
        so.ecn_redc.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                ctypes.c_char_p, ctypes.c_uint64,
                                ctypes.c_int, ctypes.c_char_p]
        so.ecn_mod.restype = None
        so.ecn_mod.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                               ctypes.c_char_p, ctypes.c_char_p,
                               ctypes.c_uint64, ctypes.c_char_p]
        so.ecn_table.restype = ctypes.c_uint64
        so.ecn_table.argtypes = [ctypes.c_void_p, ctypes.c_uint64,
                                 ctypes.c_int, ctypes.c_char_p]
        so.ecn_mats.restype = ctypes.c_uint64
        so.ecn_mats.argtypes = [ctypes.c_void_p, ctypes.c_uint64,
                                ctypes.c_uint64, ctypes.c_int,
                                ctypes.c_char_p]
        so.ecn_layer.restype = ctypes.c_uint64
        so.ecn_layer.argtypes = [ctypes.c_void_p, ctypes.c_uint64,
                                 ctypes.c_char_p]
        so.ecn_batch_inv.restype = None
        so.ecn_batch_inv.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                     ctypes.c_uint64, ctypes.c_char_p]
        so.ecn_find_curve.restype = ctypes.c_uint64
        so.ecn_find_curve.argtypes = [ctypes.c_char_p, ctypes.c_uint64,
                                      ctypes.c_uint64, ctypes.c_uint64,
                                      ctypes.c_char_p, ctypes.c_char_p,
                                      ctypes.c_char_p, ctypes.c_char_p]
        so.ecn_schoof_trace.restype = ctypes.c_int64
        so.ecn_schoof_trace.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                        ctypes.c_char_p, ctypes.c_uint32]
        so.ecn_mul_throughput.restype = ctypes.c_double
        so.ecn_mul_throughput.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
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
    """Single-core native FFTree: the eight algorithms on python ints
    (REDC by Z0 only, with an explicit modulus table), and the tables the
    port's FFTree is built from."""

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

    def _io(self, fname, vals, out_count, *extra):
        out = ctypes.create_string_buffer(32 * out_count)
        getattr(lib(), fname)(self._h, _pack(vals), len(vals), *extra, out)
        return _unpack(out.raw)

    def enter(self, coeffs: list[int]) -> list[int]:
        return self._io("ecn_enter", coeffs, len(coeffs))

    def exit(self, evals: list[int]) -> list[int]:
        return self._io("ecn_exit", evals, len(evals))

    def extend(self, evals: list[int], moiety: int) -> list[int]:
        return self._io("ecn_extend", evals, len(evals), moiety)

    def mextend(self, evals: list[int], moiety: int) -> list[int]:
        return self._io("ecn_mextend", evals, len(evals), moiety)

    def degree(self, evals: list[int]) -> int:
        return int(lib().ecn_degree(self._h, _pack(evals), len(evals)))

    def redc_z0(self, evals: list[int], a: list[int]) -> list[int]:
        out = ctypes.create_string_buffer(32 * len(evals))
        lib().ecn_redc(self._h, _pack(evals), _pack(a), len(evals), 0, out)
        return _unpack(out.raw)

    def modular_reduce(self, evals, a, c) -> list[int]:
        out = ctypes.create_string_buffer(32 * len(evals))
        lib().ecn_mod(self._h, _pack(evals), _pack(a), _pack(c), len(evals),
                      out)
        return _unpack(out.raw)

    def vanish(self, points: list[int]) -> list[int]:
        out = ctypes.create_string_buffer(32 * 2 * len(points))
        lib().ecn_vanish(self._h, _pack(points), len(points), out)
        return _unpack(out.raw)

    def table(self, size: int, name: str) -> list[int]:
        cnt = lib().ecn_table(self._h, size, TABLE_IDS[name], None)
        out = ctypes.create_string_buffer(32 * cnt)
        lib().ecn_table(self._h, size, TABLE_IDS[name], out)
        return _unpack(out.raw)

    def eval_domain(self, size: int | None = None) -> list[int]:
        return self.table(size or self.n, "leaves")

    def mats(self, size: int, depth: int, which: int) -> list[int]:
        cnt = lib().ecn_mats(self._h, size, depth, which, None)
        out = ctypes.create_string_buffer(32 * 4 * cnt)
        lib().ecn_mats(self._h, size, depth, which, out)
        return _unpack(out.raw)

    def layer(self, li: int) -> list[int]:
        cnt = lib().ecn_layer(self._h, li, None)
        out = ctypes.create_string_buffer(32 * cnt)
        lib().ecn_layer(self._h, li, out)
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


def build_tree_native(field: str | FieldSpec, n: int) -> tuple | None:
    """(tables, f_layers, maps) of a size-``n`` tree, built by the native
    engine: the tables as numpy uint32 limb arrays in the JAX package's
    layout, ``{m: {name: (rows, L), "mats": [(dec_S0, dec_S1, rec_S0,
    rec_S1) per depth, each (m/4 >> d, 2, 2, L)]}}`` for m = 2, 4, …, n;
    the domain's layers as python ints, leaves first (``NativeFFTree.
    layer``), and the rational maps, which serialization writes. Mirrors
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
    return tables, [nt.layer(li) for li in range(n.bit_length())], dom[1]


def find_curve_parallel(p: int, k: int, threads: int = 10,
                        seed: int = 1, chunk: int = 20000):
    """Race ``threads`` native searches with distinct seeds and return the
    first hit — the reference's rayon fan-out example
    (examples/find_curve.rs:11-36) on top of the C++ engine. Each thread
    searches in finite chunks (ctypes releases the GIL during the C call)
    and stops once any thread has found a curve."""
    import concurrent.futures as cf
    import threading

    found: list = []
    lock = threading.Lock()

    def worker(t: int):
        s = seed + 1000003 * t
        while True:
            with lock:
                if found:
                    return None
            r = find_curve_native(p, k, s, chunk)
            if r is not None:
                with lock:
                    found.append(r)
                return r
            s += 777767777

    with cf.ThreadPoolExecutor(max_workers=threads) as ex:
        futs = [ex.submit(worker, t) for t in range(threads)]
        for f in cf.as_completed(futs):
            pass
    return max(found, key=lambda r: r[0]) if found else None


def find_curve_native(p: int, k: int, seed: int = 1,
                      max_iters: int = 0):
    """Native FIND_CURVE (find_curve.rs:224-246 at C++ speed): returns
    (n, a, B, gen_x, gen_y) with n ≥ k the 2-adicity of the cyclic
    2-Sylow generator, or None if max_iters exhausted. ~1000× the python
    search throughput — practical for 256-bit primes and larger k."""
    bufs = [ctypes.create_string_buffer(32) for _ in range(4)]
    n = lib().ecn_find_curve(p.to_bytes(32, "little"), k, seed, max_iters,
                             *bufs)
    if n == 0:
        return None
    a, bb, x, y = (int.from_bytes(b.raw, "little") for b in bufs)
    return int(n), a, bb, x, y


def schoof_trace_native(p: int, a: int, b: int, ell: int) -> int:
    """Frobenius trace t mod ell of y² = x³ + ax + b over F_p, computed
    by the native engine's endomorphism arithmetic in F_p[x]/ψ_ℓ
    (schoofs.rs:76-138; ℓ=2 parity test schoofs.rs:345-366). 4×64
    Montgomery field ops make this practical far beyond the pure-python
    path's ~64-bit ceiling (see ecfft_tpu_torch.schoof.cardinality_native)."""
    t = lib().ecn_schoof_trace(
        p.to_bytes(32, "little"),
        (a % p).to_bytes(32, "little"),
        (b % p).to_bytes(32, "little"),
        ell,
    )
    if t < 0:
        raise ArithmeticError(f"native schoof trace failed for l={ell}")
    return int(t)


def mont_mul_ns(field: str = "secp256k1", iters: int = 2_000_000) -> float:
    """Measured single-core Montgomery-mul latency (ns) — the baseline
    constant for bench.py's vs_baseline."""
    import time

    spec = FIELDS[field]
    p_bytes = spec.p.to_bytes(32, "little")
    t0 = time.perf_counter()
    lib().ecn_mul_throughput(p_bytes, iters)
    return (time.perf_counter() - t0) / iters * 1e9
