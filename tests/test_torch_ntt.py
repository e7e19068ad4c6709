"""The port's classical NTT (``ecfft_tpu_torch/ntt.py``) against the JAX
package's ``NTTPlan`` and against naive evaluation at the root powers, on
the CPU, bit for bit (tolerance: 0 differing limbs): the schedule arrays
at n = 32, 64 and 1024, forward and inverse; ``ntt``/``intt`` over the
STARK prime (Montgomery residents, the "cios16" form's plain versions) at
n = 32 (n = 64 in ``tests/test_torch_ntt_stark64.py``) and over p = 97 (one 16-bit limb with a fold, "fold1") on
both executors. Over 257 and 64513 only naive evaluation is the witness:
the JAX package's one-limb product is wrong at 64513 (fold digit 1023),
so the port is held to Python ints there. Also the constant 1 of an
NTT-shaped state (``ops/schedule.py::to_state``, ``run_chunks``) against
the JAX package's ``to_state``/``_pack_state``, and the refusal of a
one-limb prime without a fold."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecfft_tpu.fields import registry as jreg
from ecfft_tpu.ops import schedule as jsch
from ecfft_tpu_torch.fields import device as fd
from ecfft_tpu_torch.fields.registry import spec_for_prime
from ecfft_tpu_torch.ntt import STARK_GENERATOR, STARK_P, NTTPlan, _bitrev
from ecfft_tpu_torch.ops import schedule as sch
from ecfft_tpu_torch.ops import step
from ecfft_tpu_torch.ops.unrolled import _SchedMeta
from torch_ntt_cases import (check_stark_ntt, draw, generator, jax_out,
                             jplan, naive, run)

@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
@pytest.mark.parametrize("n", [32, 64, 1024])
def test_schedule_arrays_equal_the_jax_plans(n, inverse):
    got = NTTPlan(n, device="cpu")
    want = jplan(n)
    g, w = (got._inv, want._inv) if inverse else (got._fwd, want._fwd)
    assert (g.W, g.A, g.bs_max) == (w.W, w.A, w.bs_max)
    assert g.out_perm is None and w.out_perm is None
    for a, b in zip(g.xs, w.xs, strict=True):
        b = np.asarray(b)
        assert a.dtype == b.dtype and np.array_equal(a, b)
    # every stage is one unhinted OP_AFFINE step, which the unrolled
    # executor's analysis never fuses
    assert len(g.xs[0]) == n.bit_length() - 1 + inverse
    assert set(g.xs[0].tolist()) == {sch.OP_AFFINE}
    assert not any(_SchedMeta(g).fusable)


@pytest.mark.parametrize("executor", ["scan", "unrolled"])
@pytest.mark.parametrize("n", [32])
def test_stark_ntt_equals_the_jax_plan_and_naive(n, executor, monkeypatch):
    """n = 32 here; n = 64 in ``tests/test_torch_ntt_stark64.py``, so the
    two JAX compiles (about a minute each on the CPU) run on two workers."""
    check_stark_ntt(n, executor, monkeypatch)


@pytest.mark.parametrize("executor", ["scan", "unrolled"])
def test_p97_ntt_equals_the_jax_plan_and_naive(executor, monkeypatch):
    p, n, g = 97, 32, 5
    plan = NTTPlan(n, p=p, generator=g, device="cpu")
    assert step.kernel_form(plan.spec) == "fold1"
    assert plan.spec.fold_terms == ((0, 61),)
    cs = draw(p, n, 2, 5)
    ev = run(plan, "ntt", plan.encode(cs), executor, monkeypatch)
    jev = jax_out("ntt", n, cs, p, g)
    assert np.array_equal(ev.numpy().astype(np.uint32), jev)
    for b in range(2):
        assert list(plan.decode(ev[b])) == naive(cs[b], p, g, n)
    back = run(plan, "intt", ev, executor, monkeypatch)
    assert np.array_equal(back.numpy().astype(np.uint32),
                          jax_out("intt", n, cs, p, g, inverse_of=jev))
    assert [list(r) for r in plan.decode(back)] == cs


@pytest.mark.parametrize("executor", ["scan", "unrolled"])
@pytest.mark.parametrize("p,n", [(257, 64), (64513, 64), (65521, 16)])
def test_one_limb_fold_ntt_equals_naive(p, n, executor, monkeypatch):
    """257 (F = 1), 64513 (F = 1023, slack 0: the JAX package's product is
    wrong here) and 65521 (F = 15, slack 0), against Python ints only."""
    g = generator(p)
    plan = NTTPlan(n, p=p, generator=g, device="cpu")
    assert step.kernel_form(plan.spec) == "fold1"
    cs = draw(p, n, 3, p)
    ev = run(plan, "ntt", plan.encode(cs), executor, monkeypatch)
    for b in range(3):
        assert list(plan.decode(ev[b])) == naive(cs[b], p, g, n)
    back = run(plan, "intt", ev, executor, monkeypatch)
    assert [list(r) for r in plan.decode(back)] == cs


def test_one_limb_products_equal_python_ints():
    """fields.device.mul, neg and inv at p = 64513 on every pair of edge
    values (the JAX package reads 40000² as 7972; the truth is 13087)."""
    p = 64513
    spec = spec_for_prime(p)
    edge = [0, 1, 2, 1023, 40000, p // 2, p - 2, p - 1]
    a = fd.encode(spec, [x for x in edge for _ in edge])
    b = fd.encode(spec, [y for _ in edge for y in edge])
    assert list(fd.decode(spec, fd.mul(spec, a, b))) == [
        x * y % p for x in edge for y in edge]
    assert int(fd.decode(spec, fd.mul(spec, fd.encode(spec, [40000]),
                                      fd.encode(spec, [40000])))[0]) == 13087
    assert list(fd.decode(spec, fd.neg(spec, fd.encode(spec, edge)))) == [
        -x % p for x in edge]
    assert list(fd.decode(spec, fd.inv(spec, fd.encode(spec, edge)))) == [
        pow(x, p - 2, p) for x in edge]


def test_ntt_rejects_insufficient_two_adicity():
    with pytest.raises(AssertionError):
        NTTPlan(64, p=97, generator=5, device="cpu")  # 2-adicity 5 < 6


@pytest.mark.parametrize("p", [40961, 12289])
def test_foldless_one_limb_prime_is_refused(p):
    spec = spec_for_prime(p)
    assert spec.num_limbs == 1 and spec.fold_terms is None
    for call in (lambda: NTTPlan(32, p=p, generator=3, device="cpu"),
                 lambda: step.kernel_form(spec),
                 lambda: fd.mul(spec, fd.encode(spec, [2]),
                                fd.encode(spec, [3]))):
        with pytest.raises(NotImplementedError, match="without a "
                                                      "pseudo-Mersenne fold"):
            call()


def test_bitrev():
    assert [_bitrev(i, 3) for i in range(8)] == [0, 4, 2, 6, 1, 5, 3, 7]


@pytest.mark.parametrize("p", [STARK_P, 97])
def test_ntt_state_places_the_one_as_the_jax_package_does(p):
    """An NTT-shaped state at n = 32 (W = 128, one_pos = n − 1 < m): the
    constant 1 goes to pad row W − 1, not to row 31, whose limb 0 would
    overwrite every lane's last coefficient. The packed state (before the
    first step; Montgomery form for the STARK prime) equals the JAX
    package's ``to_state``/``_pack_state`` bits."""
    n = 32
    plan = NTTPlan(n, p=p, generator=STARK_GENERATOR if p == STARK_P else 5,
                   device="cpu")
    W = plan._fwd.W
    assert W == 128 and sch.one_row(W, n, n - 1) == W - 1
    cs = draw(p, n, 2, 9)
    x = plan.encode(cs)
    jx = jnp.asarray(x.numpy().astype(np.uint32))
    got = sch.to_state(x, W, n - 1)
    want = np.asarray(jsch.to_state(jx, W, n - 1))
    assert np.array_equal(got.numpy().astype(np.uint32), want)
    assert got[n - 1, 0].tolist() == [cs[0][-1] % (1 << 16),
                                      cs[1][-1] % (1 << 16)]
    packed = []
    sch.run_chunks(plan.spec, plan._fwd, x, n - 1, n,
                   lambda s: packed.append(s.clone()))
    jspec = jreg.spec_for_prime(p, plan.spec.name)
    want = np.asarray(jsch._pack_state(jspec, jx, W, n - 1))
    assert np.array_equal(packed[0].numpy().astype(np.uint32), want)
    assert torch.equal(run_identity(plan, x), x)


def run_identity(plan, x):
    """run_chunks with no step: the pack and unpack alone."""
    return sch.run_chunks(plan.spec, plan._fwd, x, plan.n - 1, plan.n,
                          lambda s: None)
