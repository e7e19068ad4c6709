"""The general prime against the JAX package's executors and Pallas
kernels on the CPU, bit for bit (tolerance: 0 differing limbs): the JAX
scan executor's ENTER (XLA) for the STARK prime and 2^256 − 1053 against
the port's on both executors, and the STARK prime's CIOS Pallas kernels
``pallas_aff1s_ip``, ``pallas_aff2g_ip`` and ``pallas_muladd1`` in
interpret mode against the port's plain wrappers. The fold band is held
on the JAX scan executor only: the JAX unrolled executor's fused kernels
assert that the fold digits sum below 2^10 (``_make_helpers``), a check
its dispatch (``fuse_ok``) does not make first."""

import os
import random
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecfft_tpu.fields import registry as jreg
from ecfft_tpu.native import build_fftree_native as jbuild
from ecfft_tpu.ops.pallas_step import (pallas_aff1s_ip, pallas_aff2g_ip,
                                       pallas_muladd1)
from ecfft_tpu_torch import build_fftree_native as tbuild
from ecfft_tpu_torch.fields import device as fd
from ecfft_tpu_torch.fields import registry as treg
from ecfft_tpu_torch.ops import step
from ecfft_tpu_torch.ops import unrolled as tur

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_general_fields import CURVES, register  # noqa: E402


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


@pytest.mark.parametrize("kind", ["aff1s", "aff2g", "muladd1"])
def test_pallas_interpret_matches_the_plain_wrappers(fields, kind):
    """The STARK prime's CIOS Pallas kernels (interpret mode) against the
    port's wrappers on the CPU, at a window start past Pallas' 8-row
    tile; rows outside the window stay."""
    spec, jspec = fields["gp_stark"]
    rng = np.random.RandomState(5)
    W, A, B, start = 32, 16, 4, 8
    state = _cols(spec, _vals(spec, rng, (W, B)))
    x1, x2 = (_cols(spec, _vals(spec, rng, (A, B))) for _ in range(2))
    ca, cb = (fd.encode(spec, _vals(spec, rng, (A,))) for _ in range(2))
    got = state.clone()
    if kind == "aff1s":
        step.aff1s_ip(spec, cb, got, x2, start)
        ref = pallas_aff1s_ip(jspec, _j(cb), _j(state), _j(x2),
                              jnp.int32(start), True)
    elif kind == "aff2g":
        step.aff2g_ip(spec, ca, cb, got, x1, x2, start)
        ref = pallas_aff2g_ip(jspec, _j(ca), _j(cb), _j(state), _j(x1),
                              _j(x2), jnp.int32(start), True)
    else:
        got = torch.zeros_like(x1)
        step.muladd1(spec, cb, x1, x2, got, 0)
        ref = pallas_muladd1(jspec, _j(cb), _j(x1), _j(x2), True)
    np.testing.assert_array_equal(_u32(got), np.asarray(ref))
    if kind != "muladd1":
        assert torch.equal(got[:start], state[:start])
        assert torch.equal(got[start + A:], state[start + A:])


@pytest.mark.parametrize("name", ["gp_stark", "gp_band"])
def test_jax_scan_enter_matches_both_executors(fields, monkeypatch, name):
    """The JAX package's scan ENTER (XLA on the CPU) against the port's on
    both executors, at n = 16, B = 2."""
    spec, _ = fields[name]
    n = 16
    rng = random.Random(3)
    cs = [[rng.randrange(spec.p) for _ in range(n)] for _ in range(2)]
    jt = jbuild(name, n)
    want = np.asarray(jt.enter(jnp.asarray(_u32(fd.encode(spec, cs)))))
    for ex in ("scan", "unrolled"):
        if ex == "unrolled":
            monkeypatch.setenv("ECFFT_EXECUTOR", "unrolled")
            monkeypatch.setattr(tur, "TW", 8)
        tree = tbuild(name, n, device="cpu")
        got = tree.enter(tree.encode(cs))
        np.testing.assert_array_equal(_u32(got), want)
