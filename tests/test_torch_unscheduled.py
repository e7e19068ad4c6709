"""The port's unscheduled algorithms over M31 on the CPU: each
``*_unscheduled`` method against the JAX package's at n = 16, B = 2,
and against the port's scheduled method at n = 64, B = 3, bit for bit
(cases in ``tests/torch_unscheduled_cases.py``)."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_unscheduled_cases import (CASES, against_jax,  # noqa: E402
                                     against_scheduled)

FIELD = "m31"


@pytest.mark.parametrize("case", list(CASES))
def test_unscheduled_matches_the_jax_package(case):
    against_jax(FIELD, case)


@pytest.mark.parametrize("case", list(CASES))
def test_unscheduled_matches_the_scheduled_method(case):
    against_scheduled(FIELD, case)
