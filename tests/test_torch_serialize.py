"""Tree persistence in the port (``ecfft_tpu_torch/serialize.py``,
``serialize_native.py``, ``FFTree.prepare(cache_dir=…)``,
``FFTree.place_on``) against the JAX package, on the CPU, byte for byte:
the ark-layout bytes of the cases of ``tests/test_serialize.py`` equal
the JAX package's for the same native-built tree, in both modes; the
frozen m31 n = 4 fixtures are reproduced and read back; a deserialized
tree computes ENTER as the native engine does; every malformed input
raises the port's ``SerializationError``; the npz tables and the pool and
schedule cache files load across the two packages in both directions,
with equal arrays (no JAX transform runs)."""

import json
import os
import random

import numpy as np
import pytest
import torch

from ecfft_tpu.fftree import _POOL_FORMAT as JAX_POOL_FORMAT
from ecfft_tpu.native import build_fftree_native as jbuild
from ecfft_tpu.serialize import serialize_fftree as jserialize
from ecfft_tpu.serialize_native import load_tables_npz as jload
from ecfft_tpu.serialize_native import save_tables_npz as jsave
from ecfft_tpu_torch import build_fftree_native as tbuild
from ecfft_tpu_torch.errors import EcfftError, SerializationError
from ecfft_tpu_torch.fftree import _POOL_FORMAT
from ecfft_tpu_torch.native import NativeFFTree
from ecfft_tpu_torch.serialize import deserialize_fftree, serialize_fftree
from ecfft_tpu_torch.serialize_native import load_tables_npz, save_tables_npz

FIX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
CASES = [("m31", 64), ("secp256k1", 16)]
IDS = [f"{f}-{n}" for f, n in CASES]
MODES = pytest.mark.parametrize("compress", [True, False],
                                ids=["compressed", "uncompressed"])
_TREES = {}


def trees(field, n):
    """(port tree on the CPU, JAX tree), both native-built, cached."""
    if (field, n) not in _TREES:
        _TREES[(field, n)] = (tbuild(field, n, device="cpu"),
                              jbuild(field, n))
    return _TREES[(field, n)]


def u32(t):
    return np.asarray(t.numpy() if isinstance(t, torch.Tensor) else t
                      ).astype(np.uint32)


def same_tables(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for m in a:
        assert sorted(k for k in a[m] if k != "ext") == \
            sorted(k for k in b[m] if k != "ext"), m
        for k, v in a[m].items():
            if k == "ext":
                continue
            if k == "mats":
                assert len(v) == len(b[m][k])
                for qa, qb in zip(v, b[m][k]):
                    for x, y in zip(qa, qb, strict=True):
                        assert np.array_equal(u32(x), u32(y)), (m, k)
            else:
                assert np.array_equal(u32(v), u32(b[m][k])), (m, k)


@pytest.mark.parametrize("field,n", CASES, ids=IDS)
@MODES
def test_bytes_equal_the_jax_packages_and_round_trip(field, n, compress):
    tt, jt = trees(field, n)
    data = serialize_fftree(tt, compress=compress)
    assert data == jserialize(jt, compress=compress)
    t2 = deserialize_fftree(field, data, compress=compress, device="cpu")
    assert t2.device == torch.device("cpu")
    assert serialize_fftree(t2, compress=compress) == data
    same_tables(t2.tables, tt.tables)


@pytest.mark.parametrize("field,n", CASES, ids=IDS)
@MODES
def test_deserialized_tree_enters_as_the_native_engine(field, n, compress):
    tt, _ = trees(field, n)
    t2 = deserialize_fftree(field, serialize_fftree(tt, compress=compress),
                            compress=compress, device="cpu")
    rng = random.Random(1)
    cs = [[rng.randrange(t2.spec.p) for _ in range(n)] for _ in range(2)]
    got = t2.enter(t2.encode(cs))
    nt = NativeFFTree(field, n)
    for b in range(2):
        assert list(t2.decode(got[b])) == nt.enter(cs[b])
    assert torch.equal(got, tt.enter(tt.encode(cs)))


@pytest.mark.parametrize("field,n", CASES, ids=IDS)
def test_compressed_is_smaller_and_regenerates_the_inverses(field, n):
    tt, _ = trees(field, n)
    comp = serialize_fftree(tt, compress=True)
    assert len(comp) < len(serialize_fftree(tt, compress=False))
    t2 = deserialize_fftree(field, comp, compress=True, device="cpu")
    for m in t2.tables:
        for key in ("xnn_s_inv", "z0_inv_s1", "z1_inv_s0"):
            assert torch.equal(t2.tables[m][key], tt.tables[m][key]), (m, key)


@MODES
def test_fixtures_reproduced_and_read(compress):
    name = f"m31_n4_{'compressed' if compress else 'uncompressed'}.bin"
    with open(os.path.join(FIX, name), "rb") as f:
        fixture = f.read()
    assert serialize_fftree(tbuild("m31", 4, device="cpu"),
                            compress=compress) == fixture
    t2 = deserialize_fftree("m31", fixture, compress=compress, device="cpu")
    assert serialize_fftree(t2, compress=compress) == fixture


def _m31_bytes():
    return serialize_fftree(trees("m31", 64)[0], compress=True)


@pytest.mark.parametrize("cut", [0, 4, 7, 8, 100, "half", "last"])
def test_truncated_input_raises_typed_error(cut):
    data = _m31_bytes()
    cut = {"half": len(data) // 2, "last": len(data) - 1}.get(cut, cut)
    with pytest.raises(SerializationError):
        deserialize_fftree("m31", data[:cut], compress=True, device="cpu")


@pytest.mark.parametrize("data", [b"\xff" * 64, b""], ids=["huge", "empty"])
def test_garbage_input_raises_typed_error(data):
    with pytest.raises(SerializationError):
        deserialize_fftree("m31", data, compress=True, device="cpu")


def test_bad_subtree_flag_raises_typed_error():
    data = _m31_bytes()
    assert data[-1:] == b"\x00"
    with pytest.raises(SerializationError, match="subtree flag"):
        deserialize_fftree("m31", data[:-1] + b"\x02", compress=True,
                           device="cpu")


def test_non_canonical_felt_raises_typed_error():
    data = bytearray(_m31_bytes())
    data[12:16] = b"\xff\xff\xff\xff"  # the heap's root, >= p
    with pytest.raises(SerializationError, match="non-canonical"):
        deserialize_fftree("m31", bytes(data), compress=True, device="cpu")


def test_non_power_of_two_heap_and_short_chain_raise_typed_errors():
    data = _m31_bytes()
    bad = (3).to_bytes(8, "little") + data[8:]  # heap of 3 felts
    with pytest.raises(SerializationError):
        deserialize_fftree("m31", bad, compress=True, device="cpu")
    first = data.index(b"\x01", len(data) // 2)  # a section's flag byte
    with pytest.raises(SerializationError):
        deserialize_fftree("m31", data[:first] + b"\x00", compress=True,
                           device="cpu")


def test_corrupt_errors_are_ecfft_and_value_errors():
    data = _m31_bytes()
    for exc in (EcfftError, ValueError):
        with pytest.raises(exc):
            deserialize_fftree("m31", data[:len(data) // 3], compress=True,
                               device="cpu")


def test_a_tree_without_layers_is_refused(tmp_path):
    """A tree loaded from its npz tables computes but has no domain
    layers to serialize."""
    path = str(tmp_path / "tree.npz")
    save_tables_npz(trees("secp256k1", 16)[0], path)
    with pytest.raises(ValueError, match="layers"):
        serialize_fftree(load_tables_npz(path, device="cpu"))
    with pytest.raises(TypeError):
        serialize_fftree(object())


@pytest.mark.parametrize("field,n", CASES, ids=IDS)
def test_npz_tables_load_across_the_packages(field, n, tmp_path):
    tt, jt = trees(field, n)
    port, jax_ = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    save_tables_npz(tt, port)
    jsave(jt, jax_)
    with np.load(port) as a, np.load(jax_) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    for path in (port, jax_):
        t2 = load_tables_npz(path, device="cpu")
        assert (t2.spec.name, t2.n) == (field, n)
        same_tables(t2.tables, tt.tables)
        assert torch.equal(t2.enter(t2.encode([[1] * n])),
                           tt.enter(tt.encode([[1] * n])))
    same_tables(jload(port).tables, jt.tables)


def _cache_files(d):
    return sorted(f for f in os.listdir(d) if f.startswith((".pool_",
                                                            ".sched_")))


def _same_cached(tp, jt, n):
    """The port tree's pool (canonical) and ENTER/EXIT schedules equal
    the JAX tree's."""
    assert tp._pool_off == jt._pool_off
    assert np.array_equal(u32(tp._pool), np.asarray(jt._pool))
    for alg in ("enter", "exit"):
        s, _, _ = tp._schedule(alg, n)
        js = jt._scheds[(alg, n)]
        assert (s.W, s.A, s.bs_max) == (js.W, js.A, js.bs_max)
        for a, b in zip(s.xs, js.xs, strict=True):
            assert np.array_equal(a, np.asarray(b)), alg
        assert (s.out_perm is None) == (js.out_perm is None)
        if s.out_perm is not None:
            assert np.array_equal(s.out_perm, np.asarray(js.out_perm))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_cache_files_load_across_the_packages(writer, tmp_path):
    """prepare(cache_dir=…) writes the JAX package's file names and keys;
    the other package (and a second tree of the writer's) reads them
    instead of building, with equal pool and schedule arrays."""
    assert _POOL_FORMAT == JAX_POOL_FORMAT
    field, n = "m31", 64  # canonical residents: the pool is its file's
    first = (tbuild(field, n, device="cpu") if writer == "port"
             else jbuild(field, n))
    first.prepare(cache_dir=str(tmp_path))
    names = _cache_files(tmp_path)
    tag = f"{_POOL_FORMAT}_{tbuild(field, n, device='cpu')._cache_digest()}"
    assert names == sorted([f".pool_{field}_{n}_{tag}.npz",
                            f".sched_{field}_enter_{n}_{tag}.npz",
                            f".sched_{field}_exit_{n}_{tag}.npz"])
    with np.load(tmp_path / names[0]) as z:
        assert z["pool"].dtype == np.uint32
        json.loads(str(z["offsets"]))
    stamps = {f: os.path.getmtime(tmp_path / f) for f in names}
    tp = tbuild(field, n, device="cpu")
    tp.prepare(cache_dir=str(tmp_path))
    jt = jbuild(field, n)
    jt.prepare(cache_dir=str(tmp_path))
    assert {f: os.path.getmtime(tmp_path / f) for f in names} == stamps
    _same_cached(tp, jt, n)
    fresh = tbuild(field, n, device="cpu").prepare()
    x = tp.encode([[3 * i + 1 for i in range(n)]])
    assert torch.equal(tp.enter(x), fresh.enter(x))
    assert torch.equal(tp.exit(tp.enter(x)), x)


def test_cache_keeps_the_canonical_pool_of_a_montgomery_prime(tmp_path):
    """A prime without a fold keeps Montgomery residents: the file holds
    the canonical pool, and a tree that reads it converts it as one that
    builds it does."""
    from ecfft_tpu_torch.fields import registry as treg

    spec = treg.spec_for_prime(
        0x0800000000000011000000000000000000000000000000000000000000000001,
        "stark_cache")
    a = build_tree_like(spec)
    a.prepare(cache_dir=str(tmp_path))
    b = build_tree_like(spec)
    b.prepare(cache_dir=str(tmp_path))
    c = build_tree_like(spec).prepare()
    assert torch.equal(b._pool, c._pool) and torch.equal(a._pool, c._pool)
    with np.load(tmp_path / _cache_files(tmp_path)[0]) as z:
        assert not np.array_equal(z["pool"], u32(c._pool))


def build_tree_like(spec):
    """A CPU tree over ``spec`` whose tables are secp256k1's n = 16 tree's
    limbs reduced mod p: the pool and its Montgomery conversion need only
    tables of the right shapes and nonzero diagonals."""
    from ecfft_tpu_torch.fftree import FFTree
    from ecfft_tpu_torch.fields import device as fd

    tt, _ = trees("secp256k1", 16)

    def red(t):
        vals = [int(v) % spec.p or 1 for v in fd.decode(tt.spec, t)
                .reshape(-1)]
        return fd.encode(spec, vals).reshape(t.shape)

    tables = {m: {k: ([tuple(red(a) for a in q) for q in v] if k == "mats"
                      else red(v)) for k, v in t.items()}
              for m, t in tt.tables.items()}
    return FFTree(spec, 16, tables, device="cpu")


def test_place_on_moves_pool_and_banks():
    """The pool and every schedule's bank follow the tree (the card's
    case is in tests/test_torch_cuda.py; here the meta device, which
    holds no data); a tree placed on the device it is on still runs."""
    tt = tbuild("secp256k1", 16, device="cpu").prepare()
    x = tt.encode([[i for i in range(16)]])
    assert torch.equal(tt.place_on("cpu").exit(tt.enter(x)), x)
    meta = torch.device("meta")
    assert tt.place_on(meta) is tt
    assert tt.device == meta and tt._pool.device == meta
    assert all(e[1].device == meta for e in tt._scheds.values())
    assert tt.tables[16]["leaves"].device == torch.device("cpu")
