"""The port's six other FFTree algorithms (EXTEND, MEXTEND, DEGREE, REDC,
MOD, VANISH: seven methods of ``ecfft_tpu_torch.FFTree``) on the CPU, over
secp256k1, on both executors, held against the JAX package on the same
tree and the same numpy-seeded inputs, and against the native engine.
Tolerance: none, the arithmetic is exact (0 differing limbs).

- the methods at n ≤ 64, B = 3, against the JAX methods (the legacy scan;
  each reference computed once per module), both moieties for
  EXTEND/MEXTEND/REDC, DEGREE on lanes of different degrees, the
  general-modulus REDC and MOD once each;
- at the smallest sizes (1 and 2 points) and at n = 256 against the native
  engine;
- every new emitter's schedule against the JAX emitter's, array for array,
  and the unrolled executor's fusion analysis against the JAX package's
  (``fusable`` lists; host-side only: the JAX unrolled executor never
  runs here);
- batch chunks with the unbatched modulus tables, and the error cases.

The unrolled executor runs with its tile width TW at 8 rows, where these
sizes already emit pair levels and in-tile runs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecfft_tpu.native import NativeFFTree, build_fftree_native
from ecfft_tpu.ops import schedule as jsch
from ecfft_tpu.ops import unrolled as jur
from ecfft_tpu_torch import FFTree
from ecfft_tpu_torch.convert import tables_from_numpy
from ecfft_tpu_torch.errors import SizeError
from ecfft_tpu_torch.ops import emit
from ecfft_tpu_torch.ops import schedule as tsch
from ecfft_tpu_torch.ops import unrolled as tur

FIELD, N, B, L = "secp256k1", 64, 3, 16
S0, S1 = emit.S0, emit.S1
EXECUTORS = ["scan", "unrolled"]


def _limbs(rng, *shape):
    """Canonical values as (..., L) uint32 limbs, drawn with numpy."""
    x = rng.randint(0, 1 << 16, size=(*shape, L)).astype(np.uint32)
    x[..., -1] = rng.randint(0, 0xFFFF, size=shape)
    return x


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int32))


def _port_tree(jt):
    np_tables = {
        m: {k: ([tuple(np.asarray(a) for a in q) for q in v]
                if k == "mats" else np.asarray(v)) for k, v in t.items()}
        for m, t in jt.tables.items()}
    return FFTree(FIELD, jt.n, tables_from_numpy(np_tables), device="cpu")


@pytest.fixture(scope="module")
def jt():
    return build_fftree_native(FIELD, N)


@pytest.fixture(scope="module")
def port_trees(jt):
    """One port tree per executor on the JAX tree's tables (a tree keeps
    the unrolled analysis it made, so the two do not share one)."""
    return {ex: _port_tree(jt) for ex in EXECUTORS}


@pytest.fixture
def executor(request, monkeypatch):
    """Select the executor named by the test's ``ex`` parameter; the
    unrolled one with TW = 8."""
    ex = request.getfixturevalue("ex")
    if ex == "unrolled":
        monkeypatch.setenv("ECFFT_EXECUTOR", "unrolled")
        monkeypatch.setattr(tur, "TW", 8)
    else:
        monkeypatch.delenv("ECFFT_EXECUTOR", raising=False)
    return ex


def _degree_evals(nt, n, degs, rng):
    """Evaluations (the native engine's ENTER) of polynomials of the given
    degrees, as python ints."""
    p = nt.spec.p
    coeffs = [[int(rng.randint(1, 1 << 30)) * 7919 % p if i <= d else 0
               for i in range(n)] for d in degs]
    return [nt.enter(c) for c in coeffs]


DEGREES = [0, N - 1, 17]

# case → (method, size, leading arguments after the batch, extras' sizes)
CASES = {
    "extend-S0": ("extend", N // 2, (S0,), ()),
    "extend-S1": ("extend", N // 2, (S1,), ()),
    "mextend-S0": ("mextend", N // 2, (S0,), ()),
    "mextend-S1": ("mextend", N // 2, (S1,), ()),
    "degree": ("degree", N, (), ()),
    "redc_z0": ("redc_z0", N, (), ()),
    "redc_z1": ("redc_z1", N, (), ()),
    "modular_reduce": ("modular_reduce", N, (), ()),
    "vanish": ("vanish", N // 2, (), ()),
    "general-redc_z0": ("redc_z0", 16, (), (16,)),
    "general-modular_reduce": ("modular_reduce", 8, (), (8, 8)),
}


@pytest.fixture(scope="module")
def reference(jt):
    """case → (inputs, the JAX method's output), computed at first use and
    kept for the module: both executors are held to the same arrays."""
    cache = {}

    def get(case):
        if case not in cache:
            method, m, args, extras = CASES[case]
            rng = np.random.RandomState(sum(map(ord, case)))
            if method == "degree":
                nt = NativeFFTree(FIELD, N)
                batch = np.asarray(jt.encode(
                    _degree_evals(nt, m, DEGREES, rng)))
            else:
                batch = _limbs(rng, B, m)
            tabs = [_limbs(rng, k) for k in extras]
            out = getattr(jt, method)(jnp.asarray(batch), *args,
                                      *(jnp.asarray(t) for t in tabs))
            cache[case] = (batch, tabs, np.asarray(out))
        return cache[case]
    return get


@pytest.mark.parametrize("ex", EXECUTORS)
@pytest.mark.parametrize("case", list(CASES))
def test_method_matches_jax(port_trees, reference, executor, case, ex):
    method, _, args, _ = CASES[case]
    batch, tabs, want = reference(case)
    got = getattr(port_trees[ex], method)(_t(batch), *args,
                                          *(_t(t) for t in tabs))
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy().astype(want.dtype), want)
    if method == "degree":
        assert got.tolist() == DEGREES


# ------------------------------------------- against the native engine


def _ints(spec, limbs):
    return [[spec.from_limbs(row) for row in poly] for poly in limbs]


def _native_check(tree, nt, method, m, rng, batch=2):
    """One method of the port at size m against the native engine."""
    spec, dec = tree.spec, tree.decode
    if method == "degree":
        degs = sorted({0, m - 1, m // 3})
        ev = _degree_evals(nt, m, degs, rng)
        assert tree.degree(tree.encode(ev)).tolist() == degs
        assert [nt.degree(e) for e in ev] == degs
        return
    x = _limbs(rng, batch, m)
    xi = _ints(spec, x)
    if method in ("extend", "mextend"):
        for mo in (S0, S1):
            got = getattr(tree, method)(_t(x), mo)
            for b in range(batch):
                assert list(dec(got[b])) == getattr(nt, method)(xi[b], mo)
        return
    if method == "vanish":
        got = tree.vanish(_t(x))
        assert got.shape == (batch, 2 * m, L)
        for b in range(batch):
            assert list(dec(got[b])) == nt.vanish(xi[b])
        return
    a, c = nt.table(m, "xnn_s"), nt.table(m, "z0z0_rem_xnn_s")
    if method == "modular_reduce":
        got = tree.modular_reduce(_t(x))
        want = [nt.modular_reduce(v, a, c) for v in xi]
    else:  # redc_z0 (the engine's REDC by Z1 is not bound)
        got = tree.redc_z0(_t(x))
        want = [nt.redc_z0(v, a) for v in xi]
    for b in range(batch):
        assert list(dec(got[b])) == want[b]


NATIVE_METHODS = ["extend", "mextend", "degree", "redc_z0", "modular_reduce",
                  "vanish"]


@pytest.mark.parametrize("ex", EXECUTORS)
@pytest.mark.parametrize("method", NATIVE_METHODS)
def test_smallest_sizes_match_native(port_trees, executor, method, ex):
    """1 and 2 points (EXTEND from 2: the size-1 extend is the identity
    and has no schedule, in the JAX package either): state widths of 2 to
    9 rows before padding, extends of no level at all."""
    nt = NativeFFTree(FIELD, N)
    rng = np.random.RandomState(41)
    for m in (1, 2, 4):
        if m == 1 and method in ("extend", "redc_z0", "modular_reduce"):
            continue
        _native_check(port_trees[ex], nt, method, m, rng)
    if method == "degree":
        one = port_trees[ex].degree(_t(_limbs(rng, 2, 1, 1)))
        assert one.tolist() == [[0], [0]] and one.dtype == torch.int32


@pytest.fixture(scope="module")
def big():
    """A native-built port tree at n = 256 per executor, and the engine."""
    from ecfft_tpu_torch import build_fftree_native as build

    return ({ex: build(FIELD, 256, device="cpu") for ex in EXECUTORS},
            NativeFFTree(FIELD, 256))


@pytest.mark.parametrize("ex", EXECUTORS)
@pytest.mark.parametrize("method", NATIVE_METHODS)
def test_n256_matches_native(big, executor, method, ex):
    trees, nt = big
    m = 128 if method in ("extend", "mextend", "vanish") else 256
    _native_check(trees[ex], nt, method, m, np.random.RandomState(43))


@pytest.mark.parametrize("ex", EXECUTORS)
def test_general_modulus_matches_native(port_trees, executor, ex):
    """REDC and MOD by a modulus table given at run time, m = 4: the
    Fermat chain's ~500 OP_MUL steps on rows the extends also use."""
    tree, nt = port_trees[ex], NativeFFTree(FIELD, N)
    rng = np.random.RandomState(47)
    x, a, c = _limbs(rng, 2, 4), _limbs(rng, 4), _limbs(rng, 4)
    xi = _ints(tree.spec, x)
    ai, ci = _ints(tree.spec, [a, c])
    got = tree.redc_z0(_t(x), _t(a))
    mod = tree.modular_reduce(_t(x), _t(a), _t(c))
    for b in range(2):
        assert list(tree.decode(got[b])) == nt.redc_z0(xi[b], ai)
        assert list(tree.decode(mod[b])) == nt.modular_reduce(xi[b], ai, ci)


# ------------------------------------------------------- the emitters

# schedule → (the port's emitter, the JAX emitter, their arguments)
SCHEDULES = {
    "extend-S0": ("extend_schedule", (N // 2, S0)),
    "extend-S1": ("extend_schedule", (N // 2, S1)),
    "mextend-S0": ("extend_schedule", (N // 2, S0, True)),
    "mextend-S1": ("extend_schedule", (N // 2, S1, True)),
    "mextend-1": ("extend_schedule", (1, S1, True)),
    "redc": ("mod_schedule", (N, True)),
    "redc1": ("mod_schedule", (N, True, S1)),
    "mod": ("mod_schedule", (N,)),
    "mod-2": ("mod_schedule", (2,)),
    "degree": ("degree_schedule", (N,)),
    "degree-2": ("degree_schedule", (2,)),
    "vanish": ("vanish_schedule", (N // 2,)),
    "vanish-1": ("vanish_schedule", (1,)),
    "gredc-S0": ("general_mod_schedule", (16, S0, True)),
    "gredc-S1": ("general_mod_schedule", (16, S1, True)),
    "gredc-2": ("general_mod_schedule", (2, S0, True)),
    "gmod": ("general_mod_schedule", (16, S0, False)),
}


BOTH_KINDS = ("extend-S0", "extend-S1", "mextend-S0", "mextend-S1", "redc",
              "redc1", "mod", "vanish")


def _both(jt, tt, name):
    fn, args = SCHEDULES[name]
    ref = getattr(jsch, fn)(jt, *args)
    lead = ((tt.pool_offsets, tt.spec.p) if fn == "general_mod_schedule"
            else (tt.pool_offsets,))
    return getattr(emit, fn)(*lead, *args), ref


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_schedule_matches_jax(jt, port_trees, name):
    got, ref = _both(jt, port_trees["scan"], name)
    assert (got.W, got.A, got.bs_max) == (ref.W, ref.A, ref.bs_max)
    assert len(got.xs) == len(ref.xs) == 6
    for g, r in zip(got.xs, ref.xs):
        np.testing.assert_array_equal(g, np.asarray(r))
    if name.startswith("vanish"):
        np.testing.assert_array_equal(got.out_perm, ref.out_perm)
        assert got.out_perm.dtype == ref.out_perm.dtype
    else:
        assert got.out_perm is None and ref.out_perm is None
    # a D-engine micro-op stands only on the affine steps that read it
    ops, dp = got.xs[0], got.xs[3]
    plain = np.isin(ops, (emit.OP_MUL, emit.OP_CMPSEL))
    assert not dp[plain, emit.DP_DOP].any()


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_fusable_list_matches_jax(jt, port_trees, monkeypatch, name):
    monkeypatch.setattr(jur, "TW", 8)
    monkeypatch.setattr(tur, "TW", 8)
    s, ref = _both(jt, port_trees["scan"], name)
    want = jur._SchedMeta(ref).fusable
    got = tur._SchedMeta(s).fusable
    assert got == want
    if name in BOTH_KINDS:  # pair levels and in-tile levels
        assert any(h >= 8 for h in got) and any(0 < h < 8 for h in got)
    elif name in ("gredc-S0", "gredc-S1", "gmod"):  # extends of 8 rows
        assert any(got) and max(got) < 8
    else:  # no level, or (DEGREE) extends on odd offsets
        assert not any(got)


def test_index_synthesis_matches_numpy_formula_on_the_new_steps(port_trees):
    """The executor's torch synthesis of an OP_MUL and an OP_CMPSEL step's
    columns (their own defaults: the row itself, the constant 1's row)
    equals the builder's numpy formula over the window."""
    off = port_trees["scan"].pool_offsets
    for s in (emit.degree_schedule(off, 16), emit.vanish_schedule(off, 8)):
        ops, starts, colp, _, rid, _ = s.xs
        q = torch.arange(s.A)
        seen = 0
        for t in np.nonzero(np.isin(ops, (emit.OP_MUL, emit.OP_CMPSEL)))[0]:
            for ci in range(4):
                assert rid[t, ci] < 0
                full = emit._synth_np(colp[t, ci], s.W)
                got = tsch._synth(colp[t, ci], q + int(starts[t]))
                np.testing.assert_array_equal(
                    got.numpy(), full[starts[t]:starts[t] + s.A])
            seen += 1
        assert seen


# ------------------------------------------------- chunks and errors


@pytest.mark.parametrize("ex", EXECUTORS)
def test_batch_chunks_give_the_same_result(port_trees, executor, monkeypatch,
                                           ex):
    """Chunks of 2 + 1 lanes: the unbatched modulus tables go into every
    chunk's state, DEGREE's lanes branch on their own, and VANISH's rows
    come out through ``out_perm``."""
    tree = port_trees[ex]
    rng = np.random.RandomState(53)
    x, a, c = _t(_limbs(rng, B, 8)), _t(_limbs(rng, 8)), _t(_limbs(rng, 8))
    nt = NativeFFTree(FIELD, N)
    ev = tree.encode(_degree_evals(nt, 16, [3, 15, 0], rng))
    pts = _t(_limbs(rng, B, 8))
    whole = (tree.modular_reduce(x, a, c), tree.degree(ev), tree.vanish(pts))
    chunks, to_state = [], tsch.to_state
    monkeypatch.setattr(tsch, "_lanes_per_chunk", lambda *a: 2)
    monkeypatch.setattr(tsch, "to_state", lambda b, *a: (
        chunks.append(tuple(p.shape[0] for p in b) if isinstance(b, tuple)
                      else b.shape[0]), to_state(b, *a))[1])
    parts = (tree.modular_reduce(x, a, c), tree.degree(ev), tree.vanish(pts))
    assert chunks == [(2, 8, 8), (1, 8, 8), 2, 1, 2, 1]
    for w, p in zip(whole, parts):
        assert torch.equal(w, p)
    assert whole[1].tolist() == [3, 15, 0]


METHODS = ["extend", "mextend", "degree", "redc_z0", "redc_z1",
           "modular_reduce", "vanish"]


@pytest.mark.parametrize("method", METHODS)
def test_size_checks(port_trees, method):
    """A size that is no power of two, and one above the tree (half the
    tree for the methods that work on a subtree of twice their input)."""
    tree = port_trees["scan"]
    fn = getattr(tree, method)
    top = N if method in ("extend", "mextend", "vanish") else 2 * N
    for m in (12, top):
        with pytest.raises(SizeError):
            fn(torch.zeros((1, m, L), dtype=torch.int32))
    with pytest.raises(ValueError):
        fn(torch.zeros((1, 8, L), dtype=torch.int64))


@pytest.mark.parametrize("given", ["a", "c"])
def test_modular_reduce_needs_both_tables(port_trees, given):
    tree = port_trees["scan"]
    x = torch.zeros((1, 8, L), dtype=torch.int32)
    tab = torch.zeros((8, L), dtype=torch.int32)
    with pytest.raises(TypeError):
        tree.modular_reduce(x, **{given: tab})


def test_modulus_tables_are_checked(port_trees):
    tree = port_trees["scan"]
    x = torch.zeros((1, 8, L), dtype=torch.int32)
    with pytest.raises(ValueError):  # a table of another size
        tree.redc_z0(x, torch.zeros((4, L), dtype=torch.int32))
    with pytest.raises(ValueError):  # a batched table
        tree.redc_z1(x, torch.zeros((1, 8, L), dtype=torch.int32))
    with pytest.raises(ValueError):
        tree.modular_reduce(x, torch.zeros((8, L), dtype=torch.int32),
                            torch.zeros((8, L), dtype=torch.int64))


def test_unknown_opcode_is_refused():
    with pytest.raises(ValueError, match="unknown opcode"):
        tsch.check_opcode(8)
    for op in range(8):
        tsch.check_opcode(op)
