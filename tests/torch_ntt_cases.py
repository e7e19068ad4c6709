"""Shared cases of the port's NTT tests (``tests/test_torch_ntt.py``,
``tests/test_torch_ntt_stark64.py``): the JAX plan's outputs, kept once
per process, naive evaluation at the root powers, seeded inputs, and the
STARK-prime comparison. Each JAX compile of the STARK NTT takes about a
minute on the CPU, so each size lives in a file of its own and runs on a
worker of its own under ``--dist loadfile``."""

import random

import jax.numpy as jnp
import numpy as np
import pytest

from ecfft_tpu.ntt import NTTPlan as JPlan
from ecfft_tpu_torch.ntt import STARK_GENERATOR, STARK_P, NTTPlan
from ecfft_tpu_torch.ops import step
from ecfft_tpu_torch.utils.poly import evaluate

_JPLANS, _JOUT = {}, {}


def jplan(n, p=STARK_P, g=STARK_GENERATOR):
    if (n, p) not in _JPLANS:
        _JPLANS[(n, p)] = JPlan(n, p=p, generator=g)
    return _JPLANS[(n, p)]


def jax_out(fn, n, cs, p=STARK_P, g=STARK_GENERATOR, inverse_of=None):
    """The JAX plan's ``fn`` ("ntt" or "intt") on ``cs`` (or, for intt, on
    the uint32 evaluations ``inverse_of``) as uint32, on its scan
    executor, computed once per case for both of the port's executors."""
    key = (fn, n, p)
    if key not in _JOUT:
        jp = jplan(n, p, g)
        with pytest.MonkeyPatch.context() as mp:
            mp.delenv("ECFFT_EXECUTOR", raising=False)
            x = (jp.encode(cs) if inverse_of is None
                 else jnp.asarray(inverse_of))
            _JOUT[key] = np.asarray(getattr(jp, fn)(x))
    return _JOUT[key]


def generator(p: int) -> int:
    """The least generator of the multiplicative group mod p."""
    qs = {q for q in range(2, p) if (p - 1) % q == 0
          and all(q % r for r in range(2, int(q ** 0.5) + 1))}
    return next(g for g in range(2, p)
                if all(pow(g, (p - 1) // q, p) != 1 for q in qs))


def naive(coeffs, p, g, n):
    w = pow(g, (p - 1) // n, p)
    return [evaluate(coeffs, pow(w, i, p), p) for i in range(n)]


def draw(p, n, B, seed):
    """B seeded polynomials of n coefficients, the edge values p − 1,
    p − 2, 0 and 1 at the head of the last."""
    rng = random.Random(seed)
    cs = [[rng.randrange(p) for _ in range(n)] for _ in range(B)]
    cs[-1][:4] = [p - 1, p - 2, 0, 1]
    return cs


def run(plan, fn, x, executor, monkeypatch):
    if executor == "unrolled":
        monkeypatch.setenv("ECFFT_EXECUTOR", "unrolled")
    else:
        monkeypatch.delenv("ECFFT_EXECUTOR", raising=False)
    return getattr(plan, fn)(x)


def check_stark_ntt(n, executor, monkeypatch):
    """ntt and intt over the STARK prime at n, B = 2, against the JAX plan
    (its scan executor: one compile per n, the inverse reusing most of
    it) and against naive evaluation, bit for bit."""
    plan = NTTPlan(n, device="cpu")
    assert step.kernel_form(plan.spec) == "cios16"
    cs = draw(STARK_P, n, 2, n)
    ev = run(plan, "ntt", plan.encode(cs), executor, monkeypatch)
    jev = jax_out("ntt", n, cs)
    assert np.array_equal(ev.numpy().astype(np.uint32), jev)
    for b in range(2):
        assert list(plan.decode(ev[b])) == naive(cs[b], STARK_P,
                                                 STARK_GENERATOR, n)
    back = run(plan, "intt", ev, executor, monkeypatch)
    jback = jax_out("intt", n, cs, inverse_of=jev)
    assert np.array_equal(back.numpy().astype(np.uint32), jback)
    assert [list(r) for r in plan.decode(back)] == cs
