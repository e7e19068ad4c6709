"""The port's host oracle (``ecfft_tpu_torch.host.fftree``), a jax-free
copy of ``ecfft_tpu.host.fftree``, on python ints.

- Over m31 and secp256k1 at n = 16, 64 and 256 the port's ``HostFFTree``
  equals the JAX package's, int for int, on all eight algorithms (ENTER,
  EXIT, EXTEND and MEXTEND onto S0 and S1, DEGREE, REDC by Z0 and Z1, MOD,
  VANISH) on the same numpy-seeded inputs; ``build_host_fftree``'s layers,
  maps and tables and ``subtree_with_size`` are the same too.
- At n = 64 the port's CPU ``FFTree`` (native-built tables, the kernels'
  plain versions) equals the port's ``HostFFTree`` on each algorithm.
- The m31 n = 4 tree goes through the independent ark writer
  (``tests/ark_layout.py``) to the frozen fixtures' bytes.

Tolerance: none, the arithmetic is exact."""

import os
import sys

import numpy as np
import pytest

from ecfft_tpu.host import fftree as jhost
from ecfft_tpu_torch.errors import UnknownFieldError
from ecfft_tpu_torch.host import fftree as thost

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from ark_layout import ark_bytes_for_host_tree  # noqa: E402

FIELDS = ["m31", "secp256k1"]
SIZES = [16, 64, 256]
S0, S1 = thost.S0, thost.S1
FIX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")

_TREES: dict = {}


def _trees(field, n):
    """(the port's host tree, the JAX package's), built once a module."""
    if (field, n) not in _TREES:
        _TREES[field, n] = (thost.build_host_fftree(field, n),
                            jhost.build_host_fftree(field, n))
    return _TREES[field, n]


def _vals(p, count, rng):
    """``count`` canonical values below p from numpy 16-bit draws."""
    words = rng.randint(0, 1 << 16, size=(count, 16))
    return [sum(int(w) << (16 * i) for i, w in enumerate(row)) % p
            for row in words]


def _cases(tree, n, rng):
    """name → (method, its arguments) for the eight algorithms at size n."""
    p = tree.p
    ev, half = _vals(p, n, rng), _vals(p, n // 2, rng)
    a = tree.xnn_s
    low = tree.enter(_vals(p, n // 4, rng) + [0] * (n - n // 4))
    return {
        "enter": ("enter", (_vals(p, n, rng),)),
        "exit": ("exit", (ev,)),
        "extend-S0": ("extend", (half, S0)),
        "extend-S1": ("extend", (half, S1)),
        "mextend-S0": ("mextend", (half, S0)),
        "mextend-S1": ("mextend", (half, S1)),
        "degree": ("degree", (ev,)),
        "degree-low": ("degree", (low,)),
        "redc-z0": ("redc_z0", (ev, a)),
        "redc-z1": ("redc_z1", (ev, a)),
        "redc-z0-random": ("redc_z0", (ev, _vals(p, n, rng))),
        "mod": ("modular_reduce", (ev, a, tree.z0z0_rem_xnn_s)),
        "vanish": ("vanish", (half,)),
    }


CASES = list(_cases(thost.build_host_fftree("m31", 4), 4,
                    np.random.RandomState(0)))


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("field", FIELDS)
def test_algorithms_match_the_jax_host_tree(field, n, case):
    tt, jt = _trees(field, n)
    method, args = _cases(tt, n, np.random.RandomState(n))[case]
    got = getattr(tt, method)(*args)
    assert got == getattr(jt, method)(*args)
    if case == "exit":  # and back
        assert tt.enter(got) == args[0]
    if case == "degree-low":
        assert got < n // 4


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("field", FIELDS)
def test_build_matches_the_jax_host_tree(field, n):
    tt, jt = _trees(field, n)
    assert type(tt.F).__name__ == "FpHost" and tt.F.p == jt.F.p
    assert tt.f_layers == jt.f_layers
    assert [(m.numerator, m.denominator, m.p) for m in tt.rational_maps] \
        == [(m.numerator, m.denominator, m.p) for m in jt.rational_maps]
    for name in ("recombine_layers", "decompose_layers", "xnn_s",
                 "xnn_s_inv", "z0_s1", "z1_s0", "z0_inv_s1", "z1_inv_s0",
                 "z0z0_rem_xnn_s", "z1z1_rem_xnn_s"):
        assert getattr(tt, name) == getattr(jt, name), name
    m = 2
    while m <= n:
        ts, js = tt.subtree_with_size(m), jt.subtree_with_size(m)
        assert ts.n == m and ts.f_layers == js.f_layers
        assert (ts.z0z0_rem_xnn_s, ts.z1_s0) == (js.z0z0_rem_xnn_s, js.z1_s0)
        m *= 2
    with pytest.raises(ValueError, match="too small"):
        tt.subtree_with_size(2 * n)


@pytest.fixture(scope="module")
def port_cpu_trees():
    from ecfft_tpu_torch import build_fftree_native

    return {f: build_fftree_native(f, 64, device="cpu") for f in FIELDS}


# the port's REDC and MOD run by the tree's own modulus X^(n/2): the host
# oracle's cases with a = xnn_s and c = z0z0_rem_xnn_s
PORT_CASES = ["enter", "exit", "extend-S0", "extend-S1", "mextend-S0",
              "mextend-S1", "degree", "redc-z0", "redc-z1", "mod", "vanish"]


@pytest.mark.parametrize("case", PORT_CASES)
@pytest.mark.parametrize("field", FIELDS)
def test_port_fftree_matches_the_host_oracle(port_cpu_trees, field, case):
    n = 64
    tree, ht = port_cpu_trees[field], _trees(field, n)[0]
    rng = np.random.RandomState(7)
    method, args = _cases(ht, n, rng)[case]
    x = [_vals(ht.p, len(args[0]), rng) for _ in range(2)]
    if method == "degree":  # and a lane of degree below n/4
        x[1] = ht.enter(_vals(ht.p, n // 4, rng) + [0] * (n - n // 4))
    enc = tree.encode(x)
    if method in ("extend", "mextend"):
        got = getattr(tree, method)(enc, args[1])
    else:
        got = getattr(tree, method)(enc)
    for b in range(2):
        want = getattr(ht, method)(x[b], *args[1:])
        if method == "degree":
            assert int(got[b].reshape(-1)[0]) == want
        else:
            assert [int(v) for v in tree.decode(got[b])] == want


@pytest.mark.parametrize("compress", [True, False])
def test_m31_n4_tree_reproduces_the_ark_fixtures(compress):
    tree = thost.build_host_fftree("m31", 4)
    name = f"m31_n4_{'compressed' if compress else 'uncompressed'}.bin"
    with open(os.path.join(FIX, name), "rb") as f:
        want = f.read()
    assert ark_bytes_for_host_tree(tree, 4, compress)[0] == want


def test_unknown_sizes_and_fields():
    assert thost.build_host_fftree("m31", 1 << 29) is None
    with pytest.raises(UnknownFieldError):
        thost.build_host_fftree("no-such-field", 16)
