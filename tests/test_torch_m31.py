"""M31 (p = 2^31 − 1, one 32-bit limb) through the port on the CPU, where
every wrapper runs its plain int64 PyTorch version, held bit for bit
against the JAX package and the native engine:

- the int64 field ops against ``ecfft_tpu.fields.device._m31_*`` and
  python ints, on the edge values and seeded random ones;
- the plain steps against the JAX ``_muladd1_cols``/``_muladd2_cols``/
  ``_mulss`` and python ints, through the wrappers at a non-zero window
  start;
- the coefficient pool against the JAX pool, row for row (the M31 diagonals
  inverted by Fermat here, by a product scan there);
- ENTER on both executors against the JAX unrolled executor with its
  Pallas kernels in interpret mode (n = 64, B = 4), and EXIT, DEGREE and
  VANISH against the JAX scan executor;
- all eight algorithms on both executors against the native engine at
  n = 256 (the general-modulus REDC and MOD at m = 16), and the Fermat
  chain's length.

Tolerance: none, the arithmetic is exact (0 differing limbs). The
unrolled executor runs with its tile width TW at 8 rows against the native
engine, where these sizes emit every fused form; against the JAX unrolled
executor both packages keep TW = 128."""

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecfft_tpu.fields import device as jfd
from ecfft_tpu.native import build_fftree_native as jbuild
from ecfft_tpu.ops import schedule as jsch
from ecfft_tpu.ops.unrolled import run_unrolled as jrun_unrolled
from ecfft_tpu_torch import S0, S1, FFTree, build_fftree_native
from ecfft_tpu_torch import native
from ecfft_tpu_torch.convert import tables_from_numpy
from ecfft_tpu_torch.fields import device as fd
from ecfft_tpu_torch.fields.registry import FIELDS
from ecfft_tpu_torch.ops import emit, step
from ecfft_tpu_torch.ops import unrolled as tur

SPEC = FIELDS["m31"]
P = SPEC.p
EDGE = [0, 1, P - 1, P - 2, 1 << 30, (P - 1) // 2, 1 << 16]
N, BATCH = 64, 4
EXECUTORS = ["scan", "unrolled"]


def _vals(rng, n: int) -> np.ndarray:
    """n seeded random canonical values, int64."""
    return rng.randint(0, P, size=n).astype(np.int64)


def _pairs(rng, n: int):
    """a, b: every pair of edge values (a repeats, b tiles them), then n
    seeded random values each."""
    E = len(EDGE)
    a = np.concatenate([np.repeat(EDGE, E), _vals(rng, n)]).astype(np.int64)
    b = np.concatenate([np.tile(EDGE, E), _vals(rng, n)]).astype(np.int64)
    return a, b


def _j(a):
    return jnp.asarray(np.asarray(a).astype(np.uint32))


def _np(t) -> np.ndarray:
    return np.asarray(t).astype(np.int64)


# ------------------------------------------------------- field and steps


def test_field_ops_match_jax_and_ints():
    rng = np.random.RandomState(3)
    a, b = _pairs(rng, 200)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    ai, bi = [int(v) for v in a], [int(v) for v in b]
    cases = [
        (fd._m31_mul(ta, tb), jfd._m31_mul(_j(a), _j(b)),
         [x * y % P for x, y in zip(ai, bi)]),
        (fd._m31_add(ta, tb), jfd._m31_add(_j(a), _j(b)),
         [(x + y) % P for x, y in zip(ai, bi)]),
        (fd._m31_sub(ta, tb), jfd._m31_sub(_j(a), _j(b)),
         [(x - y) % P for x, y in zip(ai, bi)]),
    ]
    big = np.concatenate([a + b, a * 2 + 1, np.full(4, (1 << 32) - 1)])
    cases.append((fd._m31_canon(torch.from_numpy(big)),
                  jfd._m31_canon(_j(big)), [int(v) % P for v in big]))
    for got, ref, ints in cases:
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), _np(ref))
        assert got.tolist() == ints
    t32 = ta.int().unsqueeze(-1)
    assert fd.mul(SPEC, t32, tb.int().unsqueeze(-1))[..., 0].tolist() == \
        cases[0][2]
    assert fd.neg(SPEC, t32)[..., 0].tolist() == [-x % P for x in ai]
    inv = fd.inv(SPEC, t32)[..., 0].tolist()
    assert inv == [pow(x, -1, P) if x else 0 for x in ai]
    assert fd.decode(SPEC, fd.encode(SPEC, ai)).tolist() == ai


def _layout(vals):
    """(rows, B) ints → (rows, 1, B) int32."""
    return torch.tensor(np.asarray(vals, dtype=np.int64)).int().unsqueeze(1)


STEPS = ["aff1s_ip", "aff1g_ip", "aff2g_ip", "muladd1", "muladd2", "mulss"]


@pytest.mark.parametrize("kind", STEPS)
def test_step_plain_versions_match_jax_and_ints(kind):
    """Each M31 step on the CPU at a non-zero window start, against the
    JAX package's XLA step function and python ints; rows outside the
    window stay, and the plain path counts no launch."""
    rng = np.random.RandomState(sum(map(ord, kind)))
    W, A, B, start = 80, 56, 3, 16
    a, c = _pairs(rng, 7)  # 56 rows: every edge pair
    x1 = np.stack([_pairs(rng, 7)[0] for _ in range(B)], 1)
    x2 = np.stack([_pairs(rng, 7)[1] for _ in range(B)], 1)
    st = _vals(rng, W * B).reshape(W, B)
    state = _layout(st)
    ca, cc = (torch.tensor(v).int().unsqueeze(-1) for v in (a, c))
    X1, X2 = _layout(x1), _layout(x2)
    wrapper = getattr(step, kind)
    counts = [dict(w.launches) for w in step.STEP_WRAPPERS]
    got = state.clone()
    old = st[start:start + A]
    if kind == "aff1s_ip":
        wrapper(SPEC, cc, got, X2, start)
        ref = jsch._muladd1_cols(SPEC, _j(c)[:, None, None], _j(old)[:, None],
                                 _j(x2)[:, None])
        want = (old + c[:, None] * x2) % P
    elif kind in ("aff1g_ip", "muladd1"):
        args = (cc, got, X1, X2) if kind == "aff1g_ip" else (cc, X1, X2, got)
        wrapper(SPEC, *args, start)
        ref = jsch._muladd1_cols(SPEC, _j(c)[:, None, None], _j(x1)[:, None],
                                 _j(x2)[:, None])
        want = (x1 + c[:, None] * x2) % P
    elif kind in ("aff2g_ip", "muladd2"):
        args = ((ca, cc, got, X1, X2) if kind == "aff2g_ip"
                else (ca, cc, X1, X2, got))
        wrapper(SPEC, *args, start)
        ref = jsch._muladd2_cols(SPEC, _j(a)[:, None, None], _j(x1)[:, None],
                                 _j(c)[:, None, None], _j(x2)[:, None])
        want = (a[:, None] * x1 + c[:, None] * x2) % P
    else:
        wrapper(SPEC, X1, X2, got, start)
        ref = jsch._mulss(SPEC, _j(x1)[:, None], _j(x2)[:, None])
        want = x1 * x2 % P
    win = got[start:start + A, 0].long().numpy()
    np.testing.assert_array_equal(win, _np(ref)[:, 0])
    np.testing.assert_array_equal(win, want)
    assert torch.equal(got[:start], state[:start])
    assert torch.equal(got[start + A:], state[start + A:])
    assert [dict(w.launches) for w in step.STEP_WRAPPERS] == counts


def test_row_products_and_square():
    """The D-engine's one-lane row products (``mul_rows``) and the
    state×state product with one buffer as both factors."""
    rng = np.random.RandomState(9)
    a, b = _pairs(rng, 30)
    ta, tb = (torch.tensor(v).int().unsqueeze(-1) for v in (a, b))
    assert step.mul_rows(SPEC, ta, tb)[:, 0].tolist() == \
        [int(x) * int(y) % P for x, y in zip(a, b)]
    x = _layout(np.stack([a, b], 1))
    out = torch.zeros((len(a) + 8, 1, 2), dtype=torch.int32)
    step.mulss(SPEC, x, x, out, 8)
    np.testing.assert_array_equal(out[8:, 0].long().numpy(),
                                  np.stack([a, b], 1) ** 2 % P)


# ------------------------------------------------------- the tree


@pytest.fixture(scope="module")
def jt():
    return jbuild("m31", N)


def _port_tree(jt):
    np_tables = {
        m: {k: ([tuple(np.asarray(a) for a in q) for q in v]
                if k == "mats" else np.asarray(v)) for k, v in t.items()}
        for m, t in jt.tables.items()}
    return FFTree("m31", jt.n, tables_from_numpy(np_tables), device="cpu")


def test_pool_matches_jax(jt):
    tt = _port_tree(jt)
    assert tt.pool_offsets == jt.pool_offsets
    assert "unscaled" not in tt.pool_offsets
    np.testing.assert_array_equal(tt._pool.numpy().astype(np.uint32),
                                  np.asarray(jt._pool))


@pytest.fixture
def executor(request, monkeypatch):
    """Select the executor named by the test's ``ex`` parameter."""
    ex = request.getfixturevalue("ex")
    if ex == "unrolled":
        monkeypatch.setenv("ECFFT_EXECUTOR", "unrolled")
    else:
        monkeypatch.delenv("ECFFT_EXECUTOR", raising=False)
    return ex


@pytest.fixture(scope="module")
def jax_refs(jt):
    """A numpy-seeded batch, the JAX unrolled ENTER of it (Pallas in
    interpret mode), and the JAX scan's EXIT, DEGREE and VANISH."""
    rng = np.random.RandomState(31)
    coeffs = rng.randint(0, P, size=(BATCH, N, 1)).astype(np.uint32)
    jt.prepare((N,))
    s = jt._scheds[("enter", N)]
    evals = np.asarray(jrun_unrolled(jt.spec, jt._pool, s,
                                     jnp.asarray(coeffs), 2 * N, N, False,
                                     interpret=True))
    back = np.asarray(jt.exit(jnp.asarray(evals)))
    low = coeffs.copy()  # degrees 0, 5, N − 1 and 40
    for b, d in enumerate((0, 5, N - 1, 40)):
        low[b, d + 1:] = 0
        low[b, d] |= 1
    low_ev = np.asarray(jt.enter(jnp.asarray(low)))
    degs = np.asarray(jt.degree(jnp.asarray(low_ev)))
    pts = coeffs[:, :N // 2]
    van = np.asarray(jt.vanish(jnp.asarray(pts)))
    return coeffs, evals, back, low_ev, degs, pts, van


@pytest.mark.parametrize("ex", EXECUTORS)
def test_methods_match_jax(jt, jax_refs, executor, ex):
    coeffs, evals, back, low_ev, degs, pts, van = jax_refs
    tt = _port_tree(jt)

    def t(a):
        return torch.from_numpy(a.astype(np.int32))

    got = tt.enter(t(coeffs))
    assert got.dtype == torch.int32 and tuple(got.shape) == evals.shape
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), evals)
    np.testing.assert_array_equal(tt.exit(t(evals)).numpy(), back)
    np.testing.assert_array_equal(back, coeffs)
    d = tt.degree(t(low_ev))
    assert d.dtype == torch.int32
    assert d.tolist() == degs.tolist() == [0, 5, N - 1, 40]
    np.testing.assert_array_equal(
        tt.vanish(t(pts)).numpy().astype(np.uint32), van)


# ------------------------------------------- against the native engine

NT = 256


@pytest.fixture(scope="module")
def big():
    """Native-built port trees at n = 256 (one per executor: a tree keeps
    its unrolled analysis) and the native engine."""
    return ({ex: build_fftree_native("m31", NT, device="cpu")
             for ex in EXECUTORS}, native.NativeFFTree("m31", NT))


def _redc_native(nt, evals, a, moiety):
    """The engine's REDC by Z0 (moiety 0) or Z1 (1) with modulus table a."""
    out = ctypes.create_string_buffer(32 * len(evals))
    native.lib().ecn_redc(nt._h, native._pack(evals), native._pack(a),
                          len(evals), moiety, out)
    return native._unpack(out.raw)


ALGORITHMS = ["enter-exit", "extend", "mextend", "degree", "redc_z0",
              "redc_z1", "modular_reduce", "vanish", "general-redc_z0",
              "general-redc_z1", "general-modular_reduce"]


@pytest.mark.parametrize("ex", EXECUTORS)
@pytest.mark.parametrize("alg", ALGORITHMS)
def test_algorithm_matches_native(big, executor, monkeypatch, alg, ex):
    if ex == "unrolled":
        monkeypatch.setattr(tur, "TW", 8)
    trees, nt = big
    tree = trees[ex]
    rng = np.random.RandomState(sum(map(ord, alg)))
    m = NT // 2 if alg in ("extend", "mextend", "vanish") else NT
    if alg.startswith("general"):
        m = 16
    x = [[int(v) for v in rng.randint(0, P, size=m)] for _ in range(2)]
    X = tree.encode(x)

    def ints(t):
        return [int(v) for v in tree.decode(t)]

    if alg == "enter-exit":
        ev = tree.enter(X)
        assert [ints(e) for e in ev] == [nt.enter(v) for v in x]
        assert torch.equal(tree.exit(ev), X)
        assert [ints(c) for c in tree.exit(tree.encode(
            [nt.enter(v) for v in x]))] == x
        return
    if alg in ("extend", "mextend"):
        for mo in (S0, S1):
            got = getattr(tree, alg)(X, mo)
            assert [ints(g) for g in got] == [getattr(nt, alg)(v, mo)
                                              for v in x]
        return
    if alg == "degree":
        degs = [0, 1, NT // 2, NT - 1]
        cs = [[int(rng.randint(1, P)) if i <= d else 0 for i in range(NT)]
              for d in degs]
        ev = tree.encode([nt.enter(c) for c in cs])
        assert tree.degree(ev).tolist() == degs
        return
    if alg == "vanish":
        got = tree.vanish(X)
        assert tuple(got.shape) == (2, 2 * m, 1)
        assert [ints(g) for g in got] == [nt.vanish(v) for v in x]
        return
    if alg.startswith("general"):
        a = [int(v) for v in rng.randint(1, P, size=m)]
        c = [int(v) for v in rng.randint(0, P, size=m)]
        A_, C_ = tree.encode(a), tree.encode(c)
    else:
        a, c = nt.table(m, "xnn_s"), nt.table(m, "z0z0_rem_xnn_s")
    method = alg.split("-")[-1]
    if method == "modular_reduce":
        got = (tree.modular_reduce(X, A_, C_) if alg.startswith("general")
               else tree.modular_reduce(X))
        want = [nt.modular_reduce(v, a, c) for v in x]
    else:
        moiety = int(method[-1])
        got = (getattr(tree, method)(X, A_) if alg.startswith("general")
               else getattr(tree, method)(X))
        want = [_redc_native(nt, v, a, moiety) for v in x]
    assert [ints(g) for g in got] == want


def test_fermat_chain_is_short():
    """The general-modulus schedules invert by a^(p − 2); for M31 that is
    a 31-bit exponent: 61 OP_MUL steps, where secp256k1's REDC has 505."""
    off = build_fftree_native("m31", 16, device="cpu").pool_offsets
    ops = emit.general_mod_schedule(off, P, 16, S0, redc_only=True).xs[0]
    n_mul = int((ops == emit.OP_MUL).sum())
    assert n_mul == 61, n_mul
