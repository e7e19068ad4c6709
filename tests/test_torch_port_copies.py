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
from ecfft_tpu_torch.native import build_tree_native

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "ecfft_tpu_torch")


def test_imports_and_builds_with_jax_blocked():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['ecfft_tpu'] = None\n"
        "import torch\n"
        "import ecfft_tpu_torch as ec\n"
        "tree = ec.build_fftree_native('secp256k1', 16, device='cpu')\n"
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
    paths = [os.path.join(REPO, p) for p in (
        "chip_smoke.py", "tools/sass_count.py", "tools/ab_step_kernels.py",
        "tools/profile_torch_enter.py")]
    for root, _, files in os.walk(PKG):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    for path in paths:
        with open(path) as f:
            assert not _FORBIDDEN.search(f.read()), path


COPIES = ["errors", "fields.host", "utils.poly", "ec.curve",
          "fields.registry", "find_curve"]


def _source(obj) -> str:
    """An object's source up to the package name and the location of the
    reference's checkout in citations (an absolute directory before
    ``reference/src/`` names the same file as ``reference/src/``)."""
    return re.sub(r"/\w+/reference/src/", "reference/src/",
                  inspect.getsource(obj).replace("ecfft_tpu.",
                                                 "ecfft_tpu_torch."))


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
        assert _source(getattr(port, name)) == _source(getattr(orig, name)), \
            name


# the ark-layout codec of serialize.py: every helper the two entry points
# call, copied (the entry points differ in what they touch: tensors, and
# the device a tree is built on)
SERIALIZE_COPIES = [
    "_felt_size", "_limbs_to_bytes", "_bytes_to_limbs", "_ints_to_limbs",
    "_limbs_to_ints", "_take", "_take_len", "_check_canonical", "_w_vec",
    "_r_vec", "_w_vec_mat", "_r_vec_mat", "_w_maps", "_r_maps",
    "_heap_from_layers", "_layers_from_heap", "_identity_mats",
    "TreeSection", "_write_section", "_host_batch_inv", "_read_section"]


@pytest.mark.parametrize("name", SERIALIZE_COPIES)
def test_serialize_codec_has_its_originals_source(name):
    from ecfft_tpu import serialize as jser
    from ecfft_tpu_torch import serialize as tser

    assert _source(getattr(tser, name)) == _source(getattr(jser, name))


NATIVE_METHODS = ["_io", "enter", "exit", "extend", "mextend", "degree",
                  "redc_z0", "modular_reduce", "vanish", "table", "mats",
                  "layer"]


@pytest.mark.parametrize("name", NATIVE_METHODS)
def test_native_bindings_have_their_originals_source(name):
    """Each method of the port's ``NativeFFTree`` that calls the engine
    has the source of its original."""
    from ecfft_tpu import native as jnat
    from ecfft_tpu_torch import native as tnat

    assert inspect.getsource(getattr(tnat.NativeFFTree, name)) == \
        inspect.getsource(getattr(jnat.NativeFFTree, name))


@pytest.mark.parametrize("name", ["find_curve_native",
                                  "find_curve_parallel"])
def test_find_curve_bindings_have_their_originals_source(name):
    """FIND_CURVE's native search, one thread and raced over threads."""
    from ecfft_tpu import native as jnat
    from ecfft_tpu_torch import native as tnat

    assert inspect.getsource(getattr(tnat, name)) == \
        inspect.getsource(getattr(jnat, name))


def test_native_bindings_declare_the_originals_argument_types():
    from ecfft_tpu import native as jnat
    from ecfft_tpu_torch import native as tnat

    for fn in ("ecn_enter", "ecn_exit", "ecn_extend", "ecn_mextend",
               "ecn_degree", "ecn_redc", "ecn_mod", "ecn_vanish",
               "ecn_table", "ecn_mats", "ecn_batch_inv", "ecn_find_curve",
               "ecn_layer"):
        port, orig = getattr(tnat.lib(), fn), getattr(jnat.lib(), fn)
        assert port.argtypes == orig.argtypes, fn
    for fn in ("ecn_degree", "ecn_layer"):
        assert getattr(tnat.lib(), fn).restype is \
            getattr(jnat.lib(), fn).restype, fn


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


def test_native_layers_and_maps_match():
    """The domain's layers and maps a native-built tree carries for
    serialization, as the JAX package's native builder fills them."""
    jt = build_fftree_native("m31", 64)
    _, layers, maps = build_tree_native("m31", 64)
    assert layers == jt.f_layers
    assert [(m.numerator, m.denominator, m.p) for m in maps] == \
        [(m.numerator, m.denominator, m.p) for m in jt.maps]


def test_native_tables_match():
    n = 64
    jt = build_fftree_native("secp256k1", n)
    tt = build_tree_native("secp256k1", n)[0]
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


def test_tile_extend_has_its_originals_source_and_tables():
    """``fftree._tile_extend``, the EXTEND tables of the unscheduled forms
    and the bootstrap: its original's source, and the same tables from
    one tree's matrices."""
    from ecfft_tpu import fftree as jft
    from ecfft_tpu_torch import fftree as tft

    assert _source(tft._tile_extend) == _source(jft._tile_extend)
    tree = tft.build_fftree_native("secp256k1", 16, device="cpu")
    for m in (2, 8, 16):
        got = tft._tile_extend(tree.spec, tree.tables[m]["mats"], m)
        want = jft._tile_extend(jreg.FIELDS["secp256k1"], [
            tuple(q.numpy().astype(np.uint32) for q in quad)
            for quad in tree.tables[m]["mats"]], m)
        np.testing.assert_array_equal(got["shifts"], want["shifts"])
        for k in ("s0", "s1"):
            for g, w in zip(got[k], want[k]):
                np.testing.assert_array_equal(g.astype(np.uint32), w)
