"""The port's three step functions (ecfft_tpu_torch/ops/step.py) on the
CPU, where each wrapper runs its plain PyTorch version: held bit-exact
against the JAX package's Pallas step kernels run in interpret mode and
against python ints, on numpy-seeded and edge-value inputs, at a non-zero
window start. Tolerance: 0 differing limbs (the arithmetic is exact)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecfft_tpu.ops.pallas_step import (pallas_aff1g_ip, pallas_aff1s_ip,
                                       pallas_aff2g_ip)
from ecfft_tpu_torch.fields import device as fd
from ecfft_tpu_torch.fields.registry import FIELDS, spec_for_prime
from ecfft_tpu_torch.ops import step

SPEC = FIELDS["secp256k1"]
P = SPEC.p
L = SPEC.num_limbs
EDGE = [0, 1, P - 1, P - 2, P // 2, 2**16, 2**255 % P, (P - 1) // 2]
W, A, B, START = 32, 16, 4, 8  # START is a multiple of Pallas' 8-row tile


def _ints(rng, shape, edge: bool):
    """Canonical field values as python ints: edge values cycled, or
    numpy-drawn 16-bit limbs with a top limb below p's."""
    if edge:
        flat = [EDGE[i % len(EDGE)] for i in range(int(np.prod(shape)))]
        return np.asarray(flat, dtype=object).reshape(shape)
    limbs = rng.randint(0, 1 << 16, size=(*shape, L)).astype(np.int64)
    limbs[..., -1] = rng.randint(0, SPEC.to_limbs(P)[-1], size=shape)
    return fd.decode(SPEC, limbs)


def _layout(vals):
    """(rows, B) ints → (rows, L, B) int32 tensor."""
    return fd.encode(SPEC, vals).permute(0, 2, 1).contiguous()


def _u32(t):
    return t.numpy().astype(np.uint32)


CASES = [(kind, edge) for kind in ("aff1s", "aff1g", "aff2g")
         for edge in (False, True)]


@pytest.mark.parametrize("kind,edge", CASES,
                         ids=[f"{k}-{'edge' if e else 'random'}"
                              for k, e in CASES])
def test_step_matches_pallas_and_ints(kind, edge):
    rng = np.random.RandomState(11)
    st_i = _ints(rng, (W, B), False)
    x1_i = _ints(rng, (A, B), edge)
    x2_i = _ints(rng, (A, B), edge)
    ca_i = _ints(rng, (A,), edge)
    cb_i = _ints(rng, (A,), edge)
    if edge:  # pair every edge coefficient with every edge value
        x2_i = x2_i[::-1].copy()
        cb_i = np.roll(cb_i, 3)
    state = _layout(st_i)
    x1, x2 = _layout(x1_i), _layout(x2_i)
    ca, cb = fd.encode(SPEC, ca_i), fd.encode(SPEC, cb_i)
    j = {name: jnp.asarray(_u32(t)) for name, t in
         (("state", state), ("x1", x1), ("x2", x2), ("ca", ca), ("cb", cb))}
    got = state.clone()
    launches = [dict(w.launches) for w in step.STEP_WRAPPERS]
    if kind == "aff1s":
        step.aff1s_ip(SPEC, cb, got, x2, START)
        ref = pallas_aff1s_ip(SPEC, j["cb"], j["state"], j["x2"],
                              jnp.int32(START), True)
    elif kind == "aff1g":
        step.aff1g_ip(SPEC, cb, got, x1, x2, START)
        ref = pallas_aff1g_ip(SPEC, j["cb"], j["state"], j["x1"], j["x2"],
                              jnp.int32(START), True)
    else:
        step.aff2g_ip(SPEC, ca, cb, got, x1, x2, START)
        ref = pallas_aff2g_ip(SPEC, j["ca"], j["cb"], j["state"], j["x1"],
                              j["x2"], jnp.int32(START), True)
    np.testing.assert_array_equal(_u32(got), np.asarray(ref))
    dec = fd.decode(SPEC, got.permute(0, 2, 1))
    for w in range(W):
        for b in range(B):
            q = w - START
            if not 0 <= q < A:
                exp = st_i[w, b]
            elif kind == "aff1s":
                exp = (st_i[w, b] + cb_i[q] * x2_i[q, b]) % P
            elif kind == "aff1g":
                exp = (x1_i[q, b] + cb_i[q] * x2_i[q, b]) % P
            else:
                exp = (ca_i[q] * x1_i[q, b] + cb_i[q] * x2_i[q, b]) % P
            assert dec[w, b] == exp, (kind, w, b)
    # the plain path counts no launch
    assert [dict(w.launches) for w in step.STEP_WRAPPERS] == launches


def test_field_mul_neg_and_row_products_match_ints():
    rng = np.random.RandomState(5)
    a_i = np.concatenate([_ints(rng, (24,), False), EDGE])
    b_i = np.concatenate([_ints(rng, (24,), False), EDGE[::-1]])
    a, b = fd.encode(SPEC, a_i), fd.encode(SPEC, b_i)
    assert list(fd.decode(SPEC, fd.mul(SPEC, a, b))) == \
        [x * y % P for x, y in zip(a_i, b_i)]
    assert list(fd.decode(SPEC, step.mul_rows(SPEC, a, b))) == \
        [x * y % P for x, y in zip(a_i, b_i)]
    assert list(fd.decode(SPEC, fd.neg(SPEC, a))) == [-x % P for x in a_i]
    assert fd.decode(SPEC, fd.ones(SPEC, (3,)))[2] == 1


def test_mulss_plain_version_matches_ints():
    """The state×state product's plain version against python ints: the
    edge values (0, 1, p − 1, 2^255 among them) each with each, seeded
    random values, and x1 the very buffer x2 is (a square); rows outside
    the window stay, and the plain path counts no launch."""
    rng = np.random.RandomState(19)
    E = len(EDGE)
    x1_i = np.concatenate([np.repeat(np.asarray(EDGE, dtype=object), E),
                           _ints(rng, (A,), False)])[:, None].repeat(B, 1)
    x2_i = np.concatenate([np.tile(np.asarray(EDGE, dtype=object), E),
                           _ints(rng, (A,), False)])[:, None].repeat(B, 1)
    x2_i[:, 1:] = _ints(rng, (E * E + A, B - 1), False)
    rows = E * E + A
    st_i = _ints(rng, (rows + 2 * START, B), False)
    x1, x2, state = _layout(x1_i), _layout(x2_i), _layout(st_i)
    launches = dict(step.mulss.launches)
    got = state.clone()
    step.mulss(SPEC, x1, x2, got, START)
    sq = state.clone()
    step.mulss(SPEC, x2, x2, sq, START)
    assert dict(step.mulss.launches) == launches
    for t in (got, sq):
        assert t.dtype == torch.int32
        assert torch.equal(t[:START], state[:START])
        assert torch.equal(t[START + rows:], state[START + rows:])
    dec = fd.decode(SPEC, got[START:START + rows].permute(0, 2, 1))
    dsq = fd.decode(SPEC, sq[START:START + rows].permute(0, 2, 1))
    for q in range(rows):
        for b in range(B):
            assert dec[q, b] == x1_i[q, b] * x2_i[q, b] % P, (q, b)
            assert dsq[q, b] == x2_i[q, b] ** 2 % P, (q, b)


@pytest.mark.parametrize("bad", ["alias-x1", "alias-x2", "shape", "window"])
def test_mulss_rejects_bad_operands(bad):
    state, _, x = _operands()
    x1, x2, start = x, x.clone(), START
    if bad == "alias-x1":
        x1 = state[:A]
    elif bad == "alias-x2":
        x2 = state[START:START + A]
    elif bad == "shape":
        x1 = x1[:A - 1]
    else:
        start = W - A + 1
    with pytest.raises(ValueError):
        step.mulss(SPEC, x1, x2, state, start)


def _operands():
    z = torch.zeros((W, L, B), dtype=torch.int32)
    return z, torch.zeros((A, L), dtype=torch.int32), \
        torch.zeros((A, L, B), dtype=torch.int32)


@pytest.mark.parametrize("bad", ["dtype", "layout", "shape", "window",
                                 "alias"])
def test_step_wrappers_reject_bad_operands(bad):
    state, c, x2 = _operands()
    start = START
    err = ValueError
    if bad == "dtype":
        x2, err = x2.long(), TypeError
    elif bad == "layout":
        x2 = x2.transpose(0, 2).contiguous().transpose(0, 2)
    elif bad == "shape":
        c = torch.zeros((A - 1, L), dtype=torch.int32)
    elif bad == "window":
        start = W - A + 1
    else:
        x2 = state[:A]
    with pytest.raises(err):
        step.aff1s_ip(SPEC, c, state, x2, start)


@pytest.mark.parametrize("field", ["m61", "cios"])
def test_unported_fields_raise(field):
    """M61 (4 limbs, a fold) and the STARK prime (no fold: the CIOS form,
    Montgomery residents) each have a form of the kernels now, and the
    step computes on the CPU: 1 + 2·3 for M61, and for the STARK prime the
    Montgomery step R·1 + (R·2)(R·3)/R = R·7. A prime of one 16-bit limb
    without a fold is still refused, naming the cause; one with a fold
    (65521) takes the "fold1" form."""
    spec = spec_for_prime(
        (1 << 61) - 1 if field == "m61" else
        0x0800000000000011000000000000000000000000000000000000000000000001)
    assert (spec.num_limbs == 4) == (field == "m61")
    assert (spec.fold_terms is None) == (field == "cios")
    assert step.kernel_form(spec) == ("fold4" if field == "m61"
                                      else "cios16")
    mont = field == "cios"

    def enc(v):
        return fd.encode(spec, [v * spec.r % spec.p if mont else v] * 8)

    out = enc(1).unsqueeze(-1)
    step.aff1s_ip(spec, enc(2), out, enc(3).unsqueeze(-1), 0)
    assert torch.equal(out[..., 0], enc(7))
    assert step.kernel_form(FIELDS["m31"]) == "m31"
    assert step.kernel_form(SPEC) == "fold16"
    assert step.kernel_form(spec_for_prime(65521)) == "fold1"
    small = spec_for_prime(40961)  # one 16-bit limb, no fold
    with pytest.raises(NotImplementedError, match="one 16-bit limb"):
        step.kernel_form(small)
    z = torch.zeros((8, 1, 1), dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="one 16-bit limb"):
        step.aff1s_ip(small, z[..., 0], z.clone(), z, 0)
