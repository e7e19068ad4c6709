"""FFTree serialization in the reference's ark-serialize layout
(reference/src/fftree.rs:507-660), in the port.

The port's counterpart of ``ecfft_tpu/serialize.py``: the same bytes for
the same tree (tested against the JAX package's writer and the frozen
fixtures of ``tests/fixtures``), the same typed ``SerializationError`` for
every malformed input. Every helper below :func:`_felt_size` up to
:func:`serialize_fftree` is a copy of its original (source held equal by
``tests/test_torch_port_copies.py``); the two entry points differ only in
what they touch: the port's tables are int32 CPU tensors, so no device
fetch is needed, and :func:`deserialize_fftree` builds the tree on the
device its caller names (the card by default).

Byte layout per tree section, in the reference's field order
(fftree.rs:532-552):

    f                   BinaryTree<F>      = Vec<F> (u64 LE len + elems),
                                             index 0 unused (zero), layers
                                             top-down, leaves last
    recombine_matrices  BinaryTree<Mat2x2> = Vec of 4-element row-major F
    decompose_matrices  BinaryTree<Mat2x2>
    rational_maps       Vec<RationalMap>   = per map: numerator Vec<F>,
                                             denominator Vec<F>
    xnn_s, z0_s1, z1_s0 Vec<F>
    [xnn_s_inv, z0_inv_s1, z1_inv_s0]      only when uncompressed
                                           (fftree.rs:539-544)
    z0z0_rem_xnn_s, z1z1_rem_xnn_s         Vec<F>
    has_subtree         bool (1 byte)
    subtree             recursively, down to the 1-leaf tree

Field elements are canonical integers, little-endian, in ceil(bits(p)/8)
bytes (arkworks Fp serialization: 32 bytes for secp256k1, 4 for m31).
Compressed mode omits the three inverse tables and regenerates them by
batch inversion on load (fftree.rs:620-628).
"""

from __future__ import annotations

import io
import struct

import numpy as np

from ecfft_tpu_torch.errors import SerializationError
from ecfft_tpu_torch.fields.host import batch_inv_mod
from ecfft_tpu_torch.fields.registry import FieldSpec, get_spec


def _felt_size(spec: FieldSpec) -> int:
    return (spec.p.bit_length() + 7) // 8


# ------------------------------------------------------- vectorized codecs


def _limbs_to_bytes(spec: FieldSpec, arr) -> bytes:
    """(..., L) uint32 canonical limb array → concatenated little-endian
    felt bytes, felt_size bytes per element (vectorized)."""
    a = np.ascontiguousarray(np.asarray(arr, dtype=np.uint32)).reshape(
        -1, spec.num_limbs
    )
    fs = _felt_size(spec)
    if spec.limb_bits == 16:
        raw = a.astype("<u2").tobytes()
        width = 2 * spec.num_limbs
    else:  # packed single-limb field (m31)
        raw = a.astype("<u4").tobytes()
        width = 4 * spec.num_limbs
    if fs == width:
        return raw
    m = np.frombuffer(raw, np.uint8).reshape(-1, width)
    return m[:, :fs].tobytes()


def _bytes_to_limbs(spec: FieldSpec, data: bytes, count: int) -> np.ndarray:
    """Inverse of _limbs_to_bytes: ``count`` felts → (count, L) uint32."""
    fs = _felt_size(spec)
    m = np.frombuffer(data, np.uint8, count=count * fs).reshape(count, fs)
    if spec.limb_bits == 16:
        width = 2 * spec.num_limbs
    else:
        width = 4 * spec.num_limbs
    if fs != width:
        pad = np.zeros((count, width - fs), np.uint8)
        m = np.concatenate([m, pad], axis=1)
    if spec.limb_bits == 16:
        return (
            np.ascontiguousarray(m).view("<u2").astype(np.uint32)
            .reshape(count, spec.num_limbs)
        )
    return (
        np.ascontiguousarray(m).view("<u4").astype(np.uint32)
        .reshape(count, spec.num_limbs)
    )


def _ints_to_limbs(spec: FieldSpec, vals) -> np.ndarray:
    """Python ints → (n, L) uint32 canonical limbs (bulk byte route)."""
    fs = _felt_size(spec)
    raw = b"".join(int(v).to_bytes(fs, "little") for v in vals)
    return _bytes_to_limbs(spec, raw, len(vals))


def _limbs_to_ints(spec: FieldSpec, arr) -> list[int]:
    """(n, L) limbs → python ints (one from_bytes call per element)."""
    raw = _limbs_to_bytes(spec, arr)
    fs = _felt_size(spec)
    return [
        int.from_bytes(raw[i * fs : (i + 1) * fs], "little")
        for i in range(len(raw) // fs)
    ]


# ------------------------------------------------------------ IO helpers


def _take(buf, k: int, what: str) -> bytes:
    """Read exactly k bytes or raise a typed error (VERDICT r3 #8: the
    reference's Valid::check is a declared no-op, fftree.rs:593-598;
    truncated input must never surface as a bare numpy/struct error)."""
    data = buf.read(k)
    if len(data) != k:
        raise SerializationError(
            f"truncated FFTree bytes: wanted {k} more byte(s) for {what}, "
            f"got {len(data)}"
        )
    return data


def _take_len(buf, what: str) -> int:
    (n,) = struct.unpack("<Q", _take(buf, 8, f"{what} length"))
    # a length prefix can't exceed the remaining byte count (each element
    # is at least one byte) — reject before a giant allocation
    here = buf.tell() if hasattr(buf, "tell") else None
    if here is not None:
        end = buf.seek(0, io.SEEK_END)
        buf.seek(here)
        if n > end - here:
            raise SerializationError(
                f"implausible {what} length {n}: only {end - here} "
                "byte(s) remain"
            )
    return n


def _check_canonical(spec, arr: np.ndarray, what: str) -> np.ndarray:
    """Every felt must be a canonical residue in [0, p) (limb-wise
    lexicographic compare, vectorized)."""
    if arr.size == 0:
        return arr
    p_limbs = np.asarray(spec.to_limbs(spec.p), np.uint32)
    a = arr.reshape(-1, spec.num_limbs)
    lt = np.zeros(a.shape[0], bool)
    ge = np.zeros(a.shape[0], bool)
    for i in range(spec.num_limbs - 1, -1, -1):
        undecided = ~(lt | ge)
        lt |= undecided & (a[:, i] < p_limbs[i])
        ge |= undecided & (a[:, i] > p_limbs[i])
    if not lt.all():
        bad = int(np.argmin(lt))
        raise SerializationError(
            f"non-canonical felt in {what} (element {bad} is >= p)"
        )
    return arr


def _w_vec(buf, spec, arr):
    """Vec<F>: u64 LE length prefix + felts. ``arr`` is (n, L) limbs."""
    a = np.asarray(arr, dtype=np.uint32).reshape(-1, spec.num_limbs)
    buf.write(struct.pack("<Q", a.shape[0]))
    buf.write(_limbs_to_bytes(spec, a))


def _r_vec(buf, spec, what: str = "Vec<F>") -> np.ndarray:
    n = _take_len(buf, what)
    data = _take(buf, n * _felt_size(spec), what)
    return _check_canonical(spec, _bytes_to_limbs(spec, data, n), what)


def _w_vec_mat(buf, spec, mats):
    """BinaryTree<Mat2x2>: Vec of matrices, each 4 row-major felts.
    ``mats`` is (n, 2, 2, L) limbs."""
    m = np.asarray(mats, dtype=np.uint32).reshape(-1, 2, 2, spec.num_limbs)
    buf.write(struct.pack("<Q", m.shape[0]))
    buf.write(_limbs_to_bytes(spec, m))


def _r_vec_mat(buf, spec, what: str = "BinaryTree<Mat2x2>") -> np.ndarray:
    n = _take_len(buf, what)
    data = _take(buf, n * 4 * _felt_size(spec), what)
    flat = _check_canonical(spec, _bytes_to_limbs(spec, data, n * 4), what)
    return flat.reshape(n, 2, 2, spec.num_limbs)


def _w_maps(buf, spec, maps):
    """Vec<RationalMap>: per map numerator Vec<F> then denominator Vec<F>.
    ``maps`` = [(num_ints, den_ints)] (tiny — host ints are fine)."""
    buf.write(struct.pack("<Q", len(maps)))
    for num, den in maps:
        _w_vec(buf, spec, _ints_to_limbs(spec, num))
        _w_vec(buf, spec, _ints_to_limbs(spec, den))


def _r_maps(buf, spec):
    n = _take_len(buf, "Vec<RationalMap>")
    return [
        (
            _limbs_to_ints(spec, _r_vec(buf, spec, f"map {i} numerator")),
            _limbs_to_ints(spec, _r_vec(buf, spec, f"map {i} denominator")),
        )
        for i in range(n)
    ]


def _heap_from_layers(layers: list[np.ndarray]) -> np.ndarray:
    """[leaves, ..., root] (each (k, L)) → flat heap (2n, L), index 0
    zero-filled (utils.rs:240-293 BinaryTree layout)."""
    zero = np.zeros_like(layers[-1][:1])
    return np.concatenate([zero] + list(reversed(layers)), axis=0)


def _layers_from_heap(vec: np.ndarray) -> list[np.ndarray]:
    """Inverse of _heap_from_layers; returns [leaves, ..., root]."""
    n = vec.shape[0] // 2
    layers = []
    size = n
    while size >= 1:
        layers.append(vec[size : 2 * size])
        size //= 2
    return layers


def _identity_mats(spec: FieldSpec, n: int) -> np.ndarray:
    out = np.zeros((n, 2, 2, spec.num_limbs), np.uint32)
    one = np.asarray(spec.to_limbs(1), np.uint32)
    out[:, 0, 0] = one
    out[:, 1, 1] = one
    return out


class TreeSection:
    """Limb-array view of one tree size's data — the unit of
    (de)serialization and the bridge to/from device tables."""

    def __init__(self, f_layers, rec_layers, dec_layers, maps, tables):
        self.f_layers = f_layers  # [leaves, ..., root], (k, L) limb arrays
        self.rec_layers = rec_layers  # per layer: (k/2, 2, 2, L) limbs
        self.dec_layers = dec_layers
        self.maps = maps  # [(num_ints, den_ints)]
        self.tables = tables  # dict name -> (k, L) limbs


def _write_section(buf, spec, sec: TreeSection, compress: bool):
    n = sec.f_layers[0].shape[0]
    _w_vec(buf, spec, _heap_from_layers(sec.f_layers))
    # matrix heaps have n entries for an n-leaf tree (fftree.rs:341-342);
    # unfilled layers (top, d==1) hold identities
    for layers in (sec.rec_layers, sec.dec_layers):
        if n == 1:
            _w_vec_mat(buf, spec, _identity_mats(spec, 1))
            continue
        heap = [_identity_mats(spec, 1)]
        padded = list(layers)
        while len(padded) < max(n.bit_length() - 1, 0):
            padded.append(_identity_mats(spec, n >> (len(padded) + 1)))
        for layer in reversed(padded):
            heap.append(np.asarray(layer, np.uint32))
        _w_vec_mat(buf, spec, np.concatenate(heap, axis=0))
    _w_maps(buf, spec, sec.maps)
    t = sec.tables
    _w_vec(buf, spec, t["xnn_s"])
    _w_vec(buf, spec, t["z0_s1"])
    _w_vec(buf, spec, t["z1_s0"])
    if not compress:
        _w_vec(buf, spec, t["xnn_s_inv"])
        _w_vec(buf, spec, t["z0_inv_s1"])
        _w_vec(buf, spec, t["z1_inv_s0"])
    _w_vec(buf, spec, t["z0z0_rem_xnn_s"])
    _w_vec(buf, spec, t["z1z1_rem_xnn_s"])


def _host_batch_inv(spec: FieldSpec, arr: np.ndarray,
                    what: str = "table") -> np.ndarray:
    vals = _limbs_to_ints(spec, arr)
    try:
        return _ints_to_limbs(spec, batch_inv_mod(vals, spec.p))
    except (ValueError, ZeroDivisionError) as e:
        raise SerializationError(
            f"cannot regenerate inverse of {what}: {e}"
        ) from e


def _read_section(buf, spec, compress: bool) -> TreeSection:
    fvec = _r_vec(buf, spec, "domain tree f")
    if fvec.shape[0] < 2 or fvec.shape[0] & (fvec.shape[0] - 1):
        raise SerializationError(
            f"domain tree heap length {fvec.shape[0]} is not a "
            "power of two >= 2"
        )
    f_layers = _layers_from_heap(fvec)
    n = f_layers[0].shape[0]
    rec_heap = _r_vec_mat(buf, spec, "recombine matrices")
    dec_heap = _r_vec_mat(buf, spec, "decompose matrices")
    for heap in (rec_heap, dec_heap):
        if heap.shape[0] != n:
            raise SerializationError(
                f"matrix heap has {heap.shape[0]} entries, "
                f"expected {n} for an {n}-leaf tree"
            )
    num_layers = max(n.bit_length() - 1, 0)
    rec_layers = _layers_from_heap(rec_heap)[:num_layers] if n > 1 else []
    dec_layers = _layers_from_heap(dec_heap)[:num_layers] if n > 1 else []
    maps = _r_maps(buf, spec)
    t = {}
    t["xnn_s"] = _r_vec(buf, spec, "xnn_s")
    t["z0_s1"] = _r_vec(buf, spec, "z0_s1")
    t["z1_s0"] = _r_vec(buf, spec, "z1_s0")
    zlen = n // 2 if n > 1 else 0
    for key, want in (("xnn_s", n), ("z0_s1", zlen), ("z1_s0", zlen)):
        if t[key].shape[0] != want:
            raise SerializationError(
                f"{key} has {t[key].shape[0]} entries, expected {want} "
                f"for an {n}-leaf tree"
            )
    if compress:
        t["xnn_s_inv"] = _host_batch_inv(spec, t["xnn_s"], "xnn_s")
        t["z0_inv_s1"] = _host_batch_inv(spec, t["z0_s1"], "z0_s1")
        t["z1_inv_s0"] = _host_batch_inv(spec, t["z1_s0"], "z1_s0")
    else:
        t["xnn_s_inv"] = _r_vec(buf, spec, "xnn_s_inv")
        t["z0_inv_s1"] = _r_vec(buf, spec, "z0_inv_s1")
        t["z1_inv_s0"] = _r_vec(buf, spec, "z1_inv_s0")
    t["z0z0_rem_xnn_s"] = _r_vec(buf, spec, "z0z0_rem_xnn_s")
    t["z1z1_rem_xnn_s"] = _r_vec(buf, spec, "z1z1_rem_xnn_s")
    return TreeSection(f_layers, rec_layers, dec_layers, maps, t)


def _host_tables(tree) -> dict:
    """The tree's tables as numpy uint32 limb arrays."""
    return {m: {k: ([tuple(a.numpy().astype(np.uint32) for a in quad)
                     for quad in v] if k == "mats"
                    else v.numpy().astype(np.uint32))
                for k, v in t.items()}
            for m, t in tree.tables.items()}


def serialize_fftree(tree, compress: bool = True) -> bytes:
    """Serialize an FFTree to reference-layout bytes.

    Mirrors serialize_with_mode (fftree.rs:510-554): the subtree chain is
    written recursively (even-strided layers, last rational map dropped,
    fftree.rs:465-482) down to the 1-leaf tree.
    """
    from ecfft_tpu_torch.fftree import FFTree  # local import to avoid cycle

    if not isinstance(tree, FFTree):
        raise TypeError("serialize_fftree expects an FFTree")
    if tree.f_layers is None:
        raise ValueError("tree lacks host domain layers")
    spec = tree.spec
    # encode every f layer once (host ints → limbs, vectorized)
    enc_layers = [
        _ints_to_limbs(spec, layer) for layer in tree.f_layers
    ]
    host_tables = _host_tables(tree)
    buf = io.BytesIO()
    n = tree.n
    size = n
    while size >= 1:
        stride = n // size
        f_layers = [
            layer[::stride] for layer in enc_layers[: size.bit_length()]
        ]
        maps = [
            (list(m.numerator), list(m.denominator))
            for m in tree.maps[: max(size.bit_length() - 1, 0)]
        ]
        if size >= 2:
            dt = host_tables[size]
            rec_layers, dec_layers = [], []
            for dec_s0, dec_s1, rec_s0, rec_s1 in dt["mats"]:
                # undo moiety selection: full layer = interleave(sel1, sel0)
                # for dec (skips 0/1 resp.), (sel0, sel1) for rec
                dec_layers.append(_interleave_mats(dec_s1, dec_s0))
                rec_layers.append(_interleave_mats(rec_s0, rec_s1))
            tables = {k: dt[k] for k in _TABLE_KEYS}
        else:
            rec_layers, dec_layers = [], []
            one = _ints_to_limbs(spec, [1])
            empty = np.zeros((0, spec.num_limbs), np.uint32)
            tables = {k: one if k.startswith("xnn") else empty
                      for k in _TABLE_KEYS}
        sec = TreeSection(f_layers, rec_layers, dec_layers, maps, tables)
        _write_section(buf, spec, sec, compress)
        buf.write(b"\x01" if size > 1 else b"\x00")
        size //= 2
    return buf.getvalue()


_TABLE_KEYS = ("xnn_s", "xnn_s_inv", "z0_s1", "z1_s0", "z0_inv_s1",
               "z1_inv_s0", "z0z0_rem_xnn_s", "z1z1_rem_xnn_s")


def _interleave_mats(a, b) -> np.ndarray:
    """(k, 2, 2, L) a, b → (2k, 2, 2, L): a at even rows, b at odd."""
    out = np.empty((a.shape[0] * 2,) + a.shape[1:], np.uint32)
    out[0::2] = a
    out[1::2] = b
    return out


def deserialize_fftree(field: str | FieldSpec, data: bytes,
                       compress: bool = True, device="cuda"):
    """Reconstruct an FFTree on ``device`` from reference-layout bytes
    (fftree.rs:602-660). Compressed mode regenerates the three inverse
    tables by host batch inversion (fftree.rs:620-628). Raises
    ``SerializationError`` on malformed bytes."""
    from ecfft_tpu_torch.convert import tables_from_numpy
    from ecfft_tpu_torch.ec.curve import RationalMap
    from ecfft_tpu_torch.fftree import FFTree

    spec = get_spec(field)
    buf = io.BytesIO(data)
    sections = []
    while True:
        sections.append(_read_section(buf, spec, compress))
        has_sub = _take(buf, 1, "subtree flag")
        if has_sub == b"\x00":
            break
        if has_sub != b"\x01":
            raise SerializationError(
                f"subtree flag must be 0x00 or 0x01, got {has_sub!r}"
            )
    for prev, cur in zip(sections, sections[1:]):
        if cur.f_layers[0].shape[0] * 2 != prev.f_layers[0].shape[0]:
            raise SerializationError(
                "subtree chain sizes must halve: "
                f"{prev.f_layers[0].shape[0]} -> {cur.f_layers[0].shape[0]}"
            )
    if sections[-1].f_layers[0].shape[0] != 1:
        raise SerializationError(
            "subtree chain must end at the 1-leaf tree "
            f"(got {sections[-1].f_layers[0].shape[0]} leaves)"
        )

    top = sections[0]
    n = top.f_layers[0].shape[0]
    tables = {}
    for sec in sections:
        m = sec.f_layers[0].shape[0]
        if m < 2:
            continue
        t = {"leaves": sec.f_layers[0]}
        t["mats"] = [
            (dec[1::2], dec[0::2], rec[0::2], rec[1::2])
            for dec, rec in zip(sec.dec_layers[:max(m.bit_length() - 2, 0)],
                                sec.rec_layers)
        ]
        t.update(sec.tables)
        tables[m] = t
    return FFTree(
        spec, n, tables_from_numpy(tables), device,
        [_limbs_to_ints(spec, la) for la in top.f_layers],
        [RationalMap(tuple(num), tuple(den), spec.p)
         for num, den in top.maps])
