"""The port's unscheduled DEGREE, REDC (by Z0 and by Z1) and MOD over
secp256k1 on the CPU, by a modulus table given at run time: each
``*_unscheduled`` method against the JAX package's at n = 16, B = 2, and
against the port's scheduled method at n = 64, B = 3, bit for bit (cases
in ``tests/torch_unscheduled_cases.py``)."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_unscheduled_cases import (against_jax,  # noqa: E402
                                     against_scheduled)

FIELD = "secp256k1"
ALGORITHMS = ["degree", "redc_z0", "redc_z1", "mod"]


@pytest.mark.parametrize("case", ALGORITHMS)
def test_unscheduled_matches_the_jax_package(case):
    against_jax(FIELD, case)


@pytest.mark.parametrize("case", ALGORITHMS)
def test_unscheduled_matches_the_scheduled_method(case):
    against_scheduled(FIELD, case)
