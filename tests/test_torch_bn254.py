"""BN254's base field ``bn254_fq`` (Grumpkin's scalar field), a built-in
field of the port (``ecfft_tpu_torch/fields/bn254.py``).

On the CPU, at n ≤ 64 and B ≤ 3: its constants (the modulus, a good
curve whose generator has order exactly 2^21, a coset offset outside the
generator's subgroup, the "cios16" kernel form), the name known from a
plain ``import ecfft_tpu_torch`` in a fresh process, the pool kept in
Montgomery form by ``prepare``'s cache, ENTER and EXIT against the
benchmark's plain reference (``benchmark/reference.py`` over
``benchmark/configs/bn254fq-n16.json`` with n set to 64), which refuses a
one-limb fault, and the call record's Montgomery conversions: their rows
and launches on a ``bn254_fq`` call, nothing on a ``secp256k1`` call.
Marked ``cuda`` (skips without a card): the round trip at n = 2^16 on the
default path, with graph replay. No JAX here.
"""

import json
import os
import random
import subprocess
import sys

import pytest
import torch

import ecfft_tpu_torch as ec
from ecfft_tpu_torch.ec.curve import GoodCurve, Point
from ecfft_tpu_torch.fields import bn254
from ecfft_tpu_torch.fields import device as fd
from ecfft_tpu_torch.fields.registry import CUSTOM_DOMAINS, FIELDS
from ecfft_tpu_torch.native import NativeFFTree
from ecfft_tpu_torch.ops import schedule, step
from ecfft_tpu_torch.serialize_native import load_tables_npz, save_tables_npz
from ecfft_tpu_torch.utils import profiling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from benchmark import reference as ref  # noqa: E402

# BN254's base-field modulus (EIP-196's field modulus)
BN254_Q = 0x30644e72e131a029b85045b68181585d97816a916871ca8d3c208c16d87cfd47
N, B = 64, 3
SPEC = FIELDS["bn254_fq"]


def config(n: int) -> dict:
    with open(os.path.join(ROOT, "benchmark", "configs",
                           "bn254fq-n16.json")) as fh:
        cfg = json.load(fh)
    cfg["n"] = n
    return cfg


def values(seed: int, n: int, b: int) -> list:
    rng = random.Random(seed)
    return [[rng.randrange(BN254_Q) for _ in range(n)] for _ in range(b)]


# ------------------------------------------------------------ constants


def test_the_constants():
    q = bn254.P
    assert q == BN254_Q == SPEC.p and SPEC.name == "bn254_fq"
    assert pow(3, q - 1, q) == 1 and q % 4 == 3  # 2-adicity of q − 1: 1
    curve = GoodCurve.new_odd(bn254.CURVE_A, bn254.CURVE_BB, q)
    gen, coset = Point(*bn254.GENERATOR, curve), Point(*bn254.COSET_OFFSET,
                                                       curve)
    assert curve.contains(gen.x, gen.y) and curve.contains(coset.x, coset.y)
    acc = gen
    for _ in range(bn254.TWO_ADICITY - 1):
        acc = acc.double()
    assert not acc.is_zero() and acc.double().is_zero()  # order 2^21
    acc = coset
    for _ in range(bn254.TWO_ADICITY):
        acc = acc.double()
    assert not acc.is_zero()  # 2^21·C ≠ O: C lies outside ⟨G⟩
    assert CUSTOM_DOMAINS["bn254_fq"][3] == bn254.TWO_ADICITY
    assert step.kernel_form(SPEC) == "cios16" and fd.is_mont(SPEC)
    cfg = config(N)
    assert (int(cfg["p"]), int(cfg["curve"]["a2"]), int(cfg["curve"]["a4"]),
            int(cfg["curve"]["a6"])) == (q, bn254.CURVE_A, bn254.CURVE_BB, 0)
    assert ((int(cfg["generator"]["x"]), int(cfg["generator"]["y"])),
            (int(cfg["coset_offset"]["x"]), int(cfg["coset_offset"]["y"])),
            cfg["generator"]["two_adicity"]) == (
        bn254.GENERATOR, bn254.COSET_OFFSET, bn254.TWO_ADICITY)


def test_the_name_resolves_after_a_plain_import():
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['ecfft_tpu'] = None\n"
            "import ecfft_tpu_torch as ec\n"
            "t = ec.build_fftree_native('bn254_fq', 16, device='cpu')\n"
            "print(t.spec.name, sorted(ec.FIELDS))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split()[0] == "bn254_fq"
    assert "'bn254_fq'" in res.stdout


def test_the_tables_round_trip_through_a_file(tmp_path):
    tree = ec.build_fftree_native("bn254_fq", 16, device="cpu")
    path = str(tmp_path / "tree.npz")
    save_tables_npz(tree, path)
    back = load_tables_npz(path, device="cpu")
    x = back.encode(values(3, 16, 1))
    assert back.spec is SPEC
    assert torch.equal(back.enter(x), tree.enter(x))


def test_prepare_keeps_the_resident_pool(tmp_path, monkeypatch):
    """``prepare(cache_dir=…)`` writes the canonical pool and, for a field
    with Montgomery residents, the pool in that form; a later tree reads
    the latter and converts nothing. A canonical field writes no such
    file."""
    first = ec.build_fftree_native("bn254_fq", 16, device="cpu")
    first.prepare(cache_dir=str(tmp_path))
    pools = sorted(f for f in os.listdir(tmp_path) if f.startswith(".pool_"))
    assert len(pools) == 2 and pools[1] == pools[0][:-4] + "_cios16.npz"
    ec.build_fftree_native("secp256k1", 16, device="cpu").prepare(
        cache_dir=str(tmp_path))
    assert not [f for f in os.listdir(tmp_path) if f.endswith("_fold16.npz")]

    def refused(spec, rows):
        raise AssertionError("the pool was converted again")

    monkeypatch.setattr(step, "to_resident", refused)
    again = ec.build_fftree_native("bn254_fq", 16, device="cpu")
    again.prepare(cache_dir=str(tmp_path))
    assert torch.equal(again._pool, first._pool)
    assert again.pool_offsets == first.pool_offsets
    x = again.encode(values(4, 16, 2))
    assert torch.equal(again.enter(x), first.enter(x))
    # a cache with only the canonical pool (the JAX package's file): read,
    # converted once, and the resident file written
    monkeypatch.undo()
    os.remove(tmp_path / pools[1])
    third = ec.build_fftree_native("bn254_fq", 16, device="cpu")
    third.prepare(cache_dir=str(tmp_path))
    assert torch.equal(third._pool, first._pool)
    assert os.path.isfile(tmp_path / pools[1])


# ---------------------------------------------- against the reference


@pytest.fixture(scope="module")
def checker():
    f = ref.Field(config(N))
    xs = ref.leaves(f)
    return ref.Checker(f, xs, ref.weights(f, xs), 11, ref.points_for(f))


@pytest.fixture(scope="module")
def tree():
    return ec.build_fftree_native("bn254_fq", N, device="cpu")


def test_enter_against_the_reference(tree, checker):
    x = tree.encode(values(1, N, B))
    y = tree.enter(x)
    assert ref.check(checker, x.numpy(), y.numpy()) == [True] * B
    assert ref.noncanonical(checker.f, y.numpy()) == 0
    bad = y.clone()
    bad[1, 17, 0] ^= 1  # one limb of one value
    assert ref.check(checker, x.numpy(), bad.numpy()) == [True, False, True]


def test_exit_against_the_reference(tree, checker):
    e = tree.encode(values(2, N, B))
    c = tree.exit(e)
    assert ref.check(checker, c.numpy(), e.numpy()) == [True] * B
    assert ref.noncanonical(checker.f, c.numpy()) == 0
    bad = c.clone()
    bad[2, 40, 15] ^= 1
    assert ref.check(checker, bad.numpy(), e.numpy()) == [True, True, False]


# ----------------------------------------------------- the call record


def test_the_record_counts_the_conversions(monkeypatch):
    """A ``bn254_fq`` call notes a conversion into Montgomery form of the
    input's rows and one out of it of the output's, each with the launch
    that the wrapper counts on a card (stood in for here: the plain path
    counts none), and an event before and after each; a ``secp256k1``
    call notes none and marks no more than before."""
    redc = schedule._redc_rows

    def counted(spec, x, m, src, factor):
        redc(spec, x, m, src, factor)
        step.count(step.aff1s_ip, spec, m, x.shape[2])  # as on a card

    monkeypatch.setattr(schedule, "_redc_rows", counted)
    n = 16
    t = ec.build_fftree_native("bn254_fq", n, device="cpu")
    t.enter(t.encode(values(4, n, 2)))
    rec = profiling.recorded()[-1]
    assert [(cv.span, cv.rows, cv.lanes, cv.launches)
            for cv in rec.converts()] == [("ecfft.to_mont", n, 2, 1),
                                          ("ecfft.from_mont", n, 2, 1)]
    assert len(rec.marks) == 2 + 6 * len(rec.chunks)
    assert all(i + 1 == j < len(rec.marks)
               for i, j in (cv.marks for cv in rec.converts()))
    assert rec.launches()[("aff1s_ip", n, 2)] == 2
    assert rec.convert_ns() is None  # no events on the CPU

    s = ec.build_fftree_native("secp256k1", n, device="cpu")
    s.enter(s.encode(values(5, n, 2)))
    rec = profiling.recorded()[-1]
    assert rec.converts() == [] and rec.launches() == {}
    assert len(rec.marks) == 4 and rec.convert_ns() is None


def test_convert_ns_sums_the_events_around_each_conversion(monkeypatch):
    rec = profiling.Call("enter", N, 1)
    cvs = (profiling.Convert("ecfft.to_mont", N, 1, 1, (1, 2)),
           profiling.Convert("ecfft.from_mont", N, 1, 1, (4, 5)))
    rec.chunks.append(profiling.Chunk(1, 1, "replay", None, [], True, 0,
                                      cvs))
    device = [0, 100, 350, 400, 900, 1000, 1010]
    monkeypatch.setattr(profiling.Call, "device_ns", lambda self: device)
    assert rec.convert_ns() == 250 + 100


# ------------------------------------------------------------- the card


@pytest.mark.cuda
def test_round_trip_on_the_card_with_graph_replay():
    """exit(enter(x)) == x at n = 2^16, B = 3 on the default path: the
    scan executor's kept step plan, graph replay, the cios16 kernels and
    the conversions around each chunk; the second call replays."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    n = 1 << 16
    t = ec.build_fftree_native("bn254_fq", n, device="cuda")
    x = t.encode(values(6, n, B))
    before = step.aff1s_ip.launches["cios16"]
    for _ in range(2):  # capture, then replay
        y = t.enter(x)
        back = t.exit(y)
        torch.cuda.synchronize()
        assert torch.equal(back, x)
    assert step.aff1s_ip.launches["cios16"] > before
    enter, exit_ = profiling.recorded()[-2:]
    for rec in (enter, exit_):
        assert [ch.how for ch in rec.chunks] == ["replay"]
        assert all(ch.plan for ch in rec.chunks)
        assert [cv.launches for cv in rec.converts()] == [1, 1]
    lane = values(6, n, 1)[0]
    assert NativeFFTree("bn254_fq", n).enter(lane) == \
        [SPEC.from_limbs(v) for v in y[0].cpu().tolist()]
