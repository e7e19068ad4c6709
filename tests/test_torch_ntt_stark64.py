"""The port's classical NTT over the STARK prime at n = 64, B = 2, on both
executors, against the JAX package's ``NTTPlan`` and against naive
evaluation at the root powers, bit for bit (tolerance: 0 differing
limbs). It is the n = 32 case of ``tests/test_torch_ntt.py`` at the next
size, in a file of its own so that its JAX compile runs on another
worker."""

import pytest

from torch_ntt_cases import check_stark_ntt


@pytest.mark.parametrize("executor", ["scan", "unrolled"])
@pytest.mark.parametrize("n", [64])
def test_stark_ntt_equals_the_jax_plan_and_naive(n, executor, monkeypatch):
    check_stark_ntt(n, executor, monkeypatch)
