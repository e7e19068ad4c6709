"""The cases of ``tests/test_torch_unscheduled*.py``: each of the port's
``*_unscheduled`` algorithms against the JAX package's on the same tables
(both trees from the native engine, so no JAX bootstrap compiles) and the
same inputs, drawn from a numpy seed, and against the port's scheduled
method. No tolerance: the arithmetic is exact. JAX is imported only where
a JAX tree is built, so ``tests/test_torch_cuda.py`` takes the cases on a
machine without it."""

import numpy as np
import torch

from ecfft_tpu_torch.fftree import S0, S1, build_fftree_native

# name: (the unscheduled call, the scheduled call, whether the input has
# n/2 points); each call takes (tree, batch, modulus table a, table c),
# and the unscheduled one runs on either package's tree
CASES = {
    "extend_s0": (lambda t, x, a, c: t.extend_unscheduled(x, S0),
                  lambda t, x, a, c: t.extend(x, S0), True),
    "extend_s1": (lambda t, x, a, c: t.extend_unscheduled(x, S1),
                  lambda t, x, a, c: t.extend(x, S1), True),
    "mextend_s0": (lambda t, x, a, c: t.mextend_unscheduled(x, S0),
                   lambda t, x, a, c: t.mextend(x, S0), True),
    "mextend_s1": (lambda t, x, a, c: t.mextend_unscheduled(x, S1),
                   lambda t, x, a, c: t.mextend(x, S1), True),
    "enter": (lambda t, x, a, c: t.enter_unscheduled(x),
              lambda t, x, a, c: t.enter(x), False),
    "exit": (lambda t, x, a, c: t.exit_unscheduled(x),
             lambda t, x, a, c: t.exit(x), False),
    "degree": (lambda t, x, a, c: t.degree_unscheduled(x),
               lambda t, x, a, c: t.degree(x), False),
    "redc_z0": (lambda t, x, a, c: t._redc_unscheduled(x, a, S0),
                lambda t, x, a, c: t.redc_z0(x, a), False),
    "redc_z1": (lambda t, x, a, c: t._redc_unscheduled(x, a, S1),
                lambda t, x, a, c: t.redc_z1(x, a), False),
    "mod": (lambda t, x, a, c: t.modular_reduce_unscheduled(x, a, c),
            lambda t, x, a, c: t.modular_reduce(x, a, c), False),
    "vanish": (lambda t, x, a, c: t.vanish_unscheduled(x),
               lambda t, x, a, c: t.vanish(x), True),
}

_TREES = {}


def port_tree(field, n, device="cpu"):
    """The port's native-built tree, cached."""
    if (field, n, device) not in _TREES:
        _TREES[field, n, device] = build_fftree_native(field, n,
                                                       device=device)
    return _TREES[field, n, device]


def jax_tree(field, n):
    """The JAX package's native-built tree, cached."""
    if (field, n, "jax") not in _TREES:
        from ecfft_tpu.native import build_fftree_native as jax_native_tree

        _TREES[field, n, "jax"] = jax_native_tree(field, n)
    return _TREES[field, n, "jax"]


def _values(spec, rng, *shape):
    """Canonical values as (*shape, L) numpy uint32 limbs: 16-bit limbs
    with the top one below p's, or M31 values below p."""
    if spec.limb_bits > 16:
        return rng.integers(0, spec.p, (*shape, 1)).astype(np.uint32)
    x = rng.integers(0, 1 << 16, (*shape, spec.num_limbs))
    x[..., -1] = rng.integers(0, spec.to_limbs(spec.p)[-1], shape)
    return x.astype(np.uint32)


def inputs(tree, case, batch, seed):
    """The batch of ``case`` and the tables a and c, as numpy uint32 limbs
    from ``seed``: DEGREE's lanes are evaluations of polynomials of
    degrees n − 1, n/2, 1 and 0 in turn; a has no zero at its even
    entries."""
    spec, n = tree.spec, tree.n
    rng = np.random.default_rng(seed)
    x = _values(spec, rng, batch, n // 2 if CASES[case][2] else n)
    if case == "degree":
        for b in range(batch):
            x[b, [n, n // 2 + 1, 2, 1][b % 4]:] = 0
        x = tree.enter(torch.from_numpy(x.astype(np.int32))).numpy()
    a, c = _values(spec, rng, n), _values(spec, rng, n)
    a[0::2, 0] = np.maximum(a[0::2, 0], 1)
    return x.astype(np.uint32), a, c


def _port(arr):
    return torch.from_numpy(arr.astype(np.int32))


def against_jax(field, case, batch=2, seed=10):
    tree, jtree = port_tree(field, 16), jax_tree(field, 16)
    x, a, c = inputs(tree, case, batch, seed)
    call = CASES[case][0]
    got = call(tree, _port(x), _port(a), _port(c)).numpy()
    want = np.asarray(call(jtree, x, a, c)).astype(got.dtype)
    np.testing.assert_array_equal(got, want)


def against_scheduled(field, case, n=64, batch=3, seed=11):
    tree = port_tree(field, n)
    x, a, c = (_port(v) for v in inputs(tree, case, batch, seed))
    unscheduled, scheduled, _ = CASES[case]
    assert torch.equal(unscheduled(tree, x, a, c), scheduled(tree, x, a, c))
