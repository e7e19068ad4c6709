"""The general prime on the CPU, bit for bit (tolerance: 0 differing
limbs; the arithmetic is exact): the port against the JAX package and the
native engine for the fields of ``tests/torch_general_fields.py`` (M61,
2^256 − 1053, the STARK prime, and CIOS primes of 3 and 13 limbs).

Held here: each field's kernel form; the Montgomery pool and the packed
state against the JAX package's ``_pool_to_mont`` and ``_pack_state``,
and the unpack back out of Montgomery form; the plain step functions and
``_mulss`` against ``ecfft_tpu/ops/schedule.py``'s, and the canonical
product against ``ecfft_tpu/fields/device.py``'s ``mul``; ENTER/EXIT on
both executors against the native engine; and ``field_from_curve_search``
in both packages from one seed. The JAX executors and Pallas kernels are
held in ``tests/test_torch_general_prime_jax.py``, the other algorithms in
``tests/test_torch_general_prime_algorithms.py``."""

import os
import random
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecfft_tpu.fields import device as jfd
from ecfft_tpu.fields import registry as jreg
from ecfft_tpu.native import build_fftree_native as jbuild
from ecfft_tpu.ops import schedule as jsch
from ecfft_tpu_torch import build_fftree_native as tbuild
from ecfft_tpu_torch.fields import device as fd
from ecfft_tpu_torch.fields import registry as treg
from ecfft_tpu_torch.native import NativeFFTree
from ecfft_tpu_torch.ops import schedule as tsch
from ecfft_tpu_torch.ops import step
from ecfft_tpu_torch.ops import unrolled as tur

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_general_fields import CURVES, FORMS, MONT, register  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def fields():
    """Each field registered in both packages: (port spec, JAX spec)."""
    register(jreg)
    return {name: (treg.FIELDS[name], jreg.FIELDS[name]) for name in CURVES}


def _j(t):
    return jnp.asarray(t.numpy().astype(np.uint32))


def _u32(t):
    return np.asarray(t).astype(np.uint32)


def _vals(spec, rng, shape):
    """Canonical values (python ints) of a numpy-seeded draw, the edge
    values 0, 1, p − 1 and R mod p first."""
    n = int(np.prod(shape))
    edge = [0, 1, spec.p - 1, spec.r % spec.p]
    out = [edge[i] if i < len(edge) else
           int.from_bytes(rng.bytes(40), "little") % spec.p
           for i in range(n)]
    return np.asarray(out, dtype=object).reshape(shape)


def _cols(spec, vals):
    """(rows, B) ints → (rows, L, B) int32 limbs."""
    return fd.encode(spec, vals).permute(0, 2, 1).contiguous()


def test_the_fields_take_their_forms(fields):
    for name, (spec, jspec) in fields.items():
        assert step.kernel_form(spec) == FORMS[name]
        assert fd.is_mont(spec) == (name in MONT)
        assert (jspec.num_limbs, jspec.fold_terms) == (spec.num_limbs,
                                                       spec.fold_terms)


@pytest.mark.parametrize("name", MONT)
def test_montgomery_pool_and_state_match_jax(fields, name):
    """The pool converted once, row for row against ``_pool_to_mont``;
    the packed state of an ENTER (its batch rows and the constant 1 at
    one_pos, now R mod p) against ``_pack_state``; the unpack leaves
    Montgomery form."""
    spec, jspec = fields[name]
    n, B = 16, 2
    tt = tbuild(name, n, device="cpu")
    jt = jbuild(name, n)
    tt._ensure_pool()
    jt._ensure_pool()
    want = jsch._pool_to_mont(jspec, jt._pool)
    np.testing.assert_array_equal(_u32(tt._pool), np.asarray(want))
    canon, _ = tsch.build_pool(spec, tt.tables)
    np.testing.assert_array_equal(_u32(canon), np.asarray(jt._pool))
    sched = tt._schedule("enter", n)[0]
    batch = fd.encode(spec, _vals(spec, np.random.RandomState(3), (B, n)))
    seen = []
    out = tsch.run_chunks(spec, sched, batch, 2 * n, n,
                          lambda x: seen.append(x.clone()))
    ref = jsch._pack_state(jspec, _j(batch), sched.W, 2 * n)
    np.testing.assert_array_equal(_u32(seen[0]), np.asarray(ref))
    assert torch.equal(out, batch)  # into Montgomery form and back


@pytest.mark.parametrize("name", list(CURVES))
def test_plain_steps_match_jax(fields, name):
    """``_muladd1_cols``, ``_muladd2_cols`` and ``_mulss`` of both
    packages on the same (Montgomery, for a CIOS prime) inputs, and the
    canonical product ``fields.device.mul``."""
    spec, jspec = fields[name]
    rng = np.random.RandomState(len(name))
    W, B = 12, 3
    C, A = (_cols(spec, _vals(spec, rng, (W, 1))) for _ in range(2))
    x1, x2 = (_cols(spec, _vals(spec, rng, (W, B))) for _ in range(2))
    pairs = [
        (step._muladd1_cols(spec, C, x1, x2),
         jsch._muladd1_cols(jspec, _j(C), _j(x1), _j(x2))),
        (step._muladd2_cols(spec, A, x1, C, x2),
         jsch._muladd2_cols(jspec, _j(A), _j(x1), _j(C), _j(x2))),
        (step._mulss_cols(spec, x1, x2),
         jsch._mulss(jspec, _j(x1), _j(x2))),
    ]
    for got, want in pairs:
        np.testing.assert_array_equal(_u32(got), np.asarray(want))
    a, b = (fd.encode(spec, _vals(spec, rng, (20,))) for _ in range(2))
    np.testing.assert_array_equal(
        _u32(fd.mul(spec, a, b)), np.asarray(jfd.mul(jspec, _j(a), _j(b))))
    assert list(fd.decode(spec, fd.mul(spec, a, b))) == [
        int(u) * int(v) % spec.p for u, v in zip(fd.decode(spec, a),
                                                  fd.decode(spec, b))]


def _coeffs(spec, n, B, seed):
    rng = random.Random(seed)
    return [[rng.randrange(spec.p) for _ in range(n)] for _ in range(B)]


@pytest.mark.parametrize("ex", ["scan", "unrolled"])
@pytest.mark.parametrize("name", list(CURVES))
def test_enter_exit_match_native(fields, monkeypatch, name, ex):
    """ENTER of two polynomials at n = 64 against the native engine, and
    the EXIT round trip; the unrolled executor at TW = 8, where n = 64
    emits every fused form."""
    spec, _ = fields[name]
    n, B = 64, 2
    if ex == "unrolled":
        monkeypatch.setenv("ECFFT_EXECUTOR", "unrolled")
        monkeypatch.setattr(tur, "TW", 8)
    tree = tbuild(name, n, device="cpu")
    nt = NativeFFTree(spec, n)
    cs = _coeffs(spec, n, B, 11)
    x = tree.encode(cs)
    ev = tree.enter(x)
    for b in range(B):
        assert list(tree.decode(ev[b])) == nt.enter(cs[b]), b
    assert torch.equal(tree.exit(ev), x)


def test_field_from_curve_search_matches_jax():
    """One prime (3 limbs, no fold), one seed: both packages register the
    same field and domain."""
    p = 0xff8000000f
    t = treg.field_from_curve_search("gp_search", p, 8, random.Random(5))
    j = jreg.field_from_curve_search("gp_search", p, 8, random.Random(5))
    assert (t.name, t.p, t.num_limbs, t.fold_terms) == (
        j.name, j.p, j.num_limbs, j.fold_terms)
    tc, tq, tg, tk = treg.CUSTOM_DOMAINS["gp_search"]
    jc, jq, jg, jk = jreg.CUSTOM_DOMAINS["gp_search"]
    assert (tc.a, tc.b, tc.p, tk) == (jc.a, jc.b, jc.p, jk) and tk >= 8
    assert (tq.x, tq.y, tg.x, tg.y) == (jq.x, jq.y, jg.x, jg.y)
    assert treg.build_domain(t, 16)[0] == jreg.build_domain(j, 16)[0]
