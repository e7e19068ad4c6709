"""The port's unscheduled ENTER, EXIT, EXTEND, MEXTEND and VANISH over
secp256k1 on the CPU: each ``*_unscheduled`` method against the JAX
package's at n = 16, B = 2, and against the port's scheduled method at
n = 64, B = 3, bit for bit (cases in ``tests/torch_unscheduled_cases.py``;
DEGREE, REDC and MOD in ``tests/test_torch_unscheduled_secp_mod.py``, so
that two workers share the JAX compiles)."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_unscheduled_cases import (CASES, against_jax,  # noqa: E402
                                     against_scheduled)

FIELD = "secp256k1"
ALGORITHMS = [c for c in CASES if c not in ("degree", "redc_z0", "redc_z1",
                                             "mod")]


@pytest.mark.parametrize("case", ALGORITHMS)
def test_unscheduled_matches_the_jax_package(case):
    against_jax(FIELD, case)


@pytest.mark.parametrize("case", ALGORITHMS)
def test_unscheduled_matches_the_scheduled_method(case):
    against_scheduled(FIELD, case)
