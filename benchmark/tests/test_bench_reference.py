"""The plain reference against naive evaluation in Python integers at
small n, for both fields, and against the program's own CPU path."""

import ast
import copy
import json
import os
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark import reference as ref  # noqa: E402

CONFIGS = ("secp256k1-n16", "m31-n16")


def config(name: str, n: int) -> dict:
    with open(os.path.join(ROOT, "benchmark", "configs",
                           f"{name}.json")) as fh:
        cfg = json.load(fh)
    cfg["n"] = n
    return cfg


def horner(cs, x, p):
    acc = 0
    for c in reversed(cs):
        acc = (acc * x + c) % p
    return acc


def encode(f: ref.Field, vals) -> np.ndarray:
    """Python ints → (len, L) int32 limbs as the program keeps them."""
    mask = (1 << f.limb_bits) - 1
    return np.array([[(v >> (f.limb_bits * k)) & mask
                      for k in range(f.limbs)] for v in vals],
                    dtype=np.int64).astype(np.int32)


def test_reference_imports_nothing_of_the_program():
    with open(os.path.join(ROOT, "benchmark", "reference.py")) as fh:
        tree = ast.parse(fh.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add((node.module or "").split(".")[0])
    assert names <= {"__future__", "random", "numpy"}


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("n", [2, 8, 32])
def test_weights_are_the_naive_ones(name, n):
    f = ref.Field(config(name, n))
    xs = ref.leaves(f)
    lam = ref.weights(f, xs)
    for j in range(n):
        d = 1
        for i in range(n):
            if i != j:
                d = d * (xs[j] - xs[i]) % f.p
        assert lam[j] * d % f.p == 1


@pytest.mark.parametrize("name", CONFIGS)
def test_check_against_naive_evaluation(name):
    n = 32
    f = ref.Field(config(name, n))
    xs = ref.leaves(f)
    chk = ref.Checker(f, xs, ref.weights(f, xs), 99, ref.points_for(f))
    rng = np.random.default_rng(4)
    polys = [[int(v) % f.p for v in rng.integers(0, 2**62, n)]
             for _ in range(3)]
    coeffs = np.stack([encode(f, c) for c in polys])
    evals = np.stack([encode(f, [horner(c, x, f.p) for x in xs])
                      for c in polys])
    assert ref.check(chk, coeffs, evals) == [True] * 3
    assert ref.noncanonical(f, evals) == 0
    wrong = evals.copy()
    wrong[1, 17, 0] ^= 1
    assert ref.check(chk, coeffs, wrong) == [True, False, True]
    swapped = evals.copy()
    swapped[2, [3, 4]] = swapped[2, [4, 3]]  # right values, wrong places
    assert ref.check(chk, coeffs, swapped) == [True, True, False]


@pytest.mark.parametrize("name", CONFIGS)
def test_noncanonical_values_are_counted(name):
    f = ref.Field(config(name, 8))
    vals = np.stack([encode(f, [0, 1, f.p - 1, 5, 6, 7, 8, 9])])
    assert ref.noncanonical(f, vals) == 0
    vals[0, 3] = encode(f, [f.p])[0]
    vals[0, 4, -1] = -1
    vals[0, 5] = encode(f, [f.p + 3])[0] if f.limbs > 1 else (
        encode(f, [f.p])[0])
    assert ref.noncanonical(f, vals) == 3


@pytest.mark.parametrize("name", CONFIGS)
def test_points_for_a_wrong_poly_to_pass_at_most_2_to_the_minus_64(name):
    f = ref.Field(config(name, 1 << 16))
    bits = f.p.bit_length() - 1 - 16
    assert ref.points_for(f) * bits >= 64
    assert (ref.points_for(f) - 1) * bits < 64


@pytest.mark.parametrize("name", CONFIGS)
def test_domain_and_check_agree_with_the_programs_cpu_path(name):
    import torch

    import ecfft_tpu_torch as et

    n = 64
    cfg = config(name, n)
    f = ref.Field(cfg)
    xs = ref.leaves(f)
    tree = et.build_fftree_native(cfg["field"], n, device="cpu")
    assert [int(v) for v in tree.eval_domain()] == xs
    chk = ref.Checker(f, xs, ref.weights(f, xs), 5, ref.points_for(f))
    from benchmark.harness import make_input

    x = make_input(cfg, 3, 11, torch.device("cpu"))
    y = tree.enter(x)
    assert ref.check(chk, x.numpy(), y.numpy()) == [True] * 3
    c = tree.exit(x)
    assert ref.check(chk, c.numpy(), x.numpy()) == [True] * 3


def test_the_configuration_constants_are_checked():
    cfg = copy.deepcopy(config("m31-n16", 8))
    cfg["generator"]["y"] = str(int(cfg["generator"]["y"]) + 1)
    with pytest.raises(ValueError):
        ref.Field(cfg)
