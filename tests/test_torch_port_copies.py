"""The port stands alone: ``ecfft_tpu_torch`` imports neither jax nor
``ecfft_tpu`` and builds a tree with both blocked, and its jax-free copies
of the reference's host modules match their originals — source for
source, and in what they compute (field constants, the secp256k1 leaf
domain and isogeny maps, the native engine's tables)."""

import importlib
import inspect
import os
import re
import subprocess
import sys

import numpy as np
import pytest

from ecfft_tpu.fields import registry as jreg
from ecfft_tpu.native import build_fftree_native
from ecfft_tpu_torch.fields import registry as treg
from ecfft_tpu_torch.native import build_tables_native

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "ecfft_tpu_torch")


def test_imports_and_builds_with_jax_blocked():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['ecfft_tpu'] = None\n"
        "import torch\n"
        "import ecfft_tpu_torch as ec\n"
        "tree = ec.build_fftree_native('secp256k1', 16)\n"
        "x = tree.encode([[3 * i + 1 for i in range(16)]])\n"
        "assert torch.equal(tree.exit(tree.enter(x)), x)\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'ecfft_tpu.'))\n"
        "               for m in sys.modules if sys.modules[m] is not None)\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


_FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|ecfft_tpu)\b(?!_torch)",
                        re.M)


def test_no_jax_imports_in_the_port():
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PKG):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    for path in paths:
        with open(path) as f:
            assert not _FORBIDDEN.search(f.read()), path


COPIES = ["errors", "fields.host", "utils.poly", "ec.curve",
          "fields.registry"]


@pytest.mark.parametrize("mod", COPIES)
def test_copies_have_their_originals_source(mod):
    """Every class and function of a copied module has the source of its
    original, up to the package name."""
    port = importlib.import_module(f"ecfft_tpu_torch.{mod}")
    orig = importlib.import_module(f"ecfft_tpu.{mod}")
    names = [n for n, obj in vars(port).items()
             if (inspect.isfunction(obj) or inspect.isclass(obj))
             and obj.__module__ == port.__name__]
    assert names
    for name in names:
        want = inspect.getsource(getattr(orig, name)).replace(
            "ecfft_tpu.", "ecfft_tpu_torch.")
        assert inspect.getsource(getattr(port, name)) == want, name


@pytest.mark.parametrize("field", ["secp256k1", "m31"])
def test_field_spec_constants_match(field):
    a, b = jreg.FIELDS[field], treg.FIELDS[field]
    assert (a.name, a.p, a.num_limbs, a.montgomery, a.limb_bits) == \
        (b.name, b.p, b.num_limbs, b.montgomery, b.limb_bits)
    assert (a.fold_terms, a.n_prime, a.r_mod_p, a.r2_mod_p) == \
        (b.fold_terms, b.n_prime, b.r_mod_p, b.r2_mod_p)
    assert a.to_limbs(a.p - 2) == b.to_limbs(b.p - 2)


@pytest.mark.parametrize("n", [64, 256])
def test_build_domain_matches(n):
    jl, jm = jreg.build_domain(jreg.FIELDS["secp256k1"], n)
    tl, tm = treg.build_domain(treg.FIELDS["secp256k1"], n)
    assert tl == jl
    assert [(m.numerator, m.denominator, m.p) for m in tm] == \
        [(m.numerator, m.denominator, m.p) for m in jm]


def test_native_tables_match():
    n = 64
    jt = build_fftree_native("secp256k1", n)
    tt = build_tables_native("secp256k1", n)
    assert sorted(tt) == sorted(jt.tables)
    for m, t in tt.items():
        assert sorted(t) == sorted(jt.tables[m]), m
        for name, v in t.items():
            if name == "mats":
                ref = [a for quad in jt.tables[m][name] for a in quad]
                got = [a for quad in v for a in quad]
            else:
                ref, got = [jt.tables[m][name]], [v]
            assert len(got) == len(ref), (m, name)
            for g, r in zip(got, ref):
                assert g.dtype == np.uint32
                np.testing.assert_array_equal(g, np.asarray(r))
