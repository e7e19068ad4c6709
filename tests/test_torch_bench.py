"""The port's main bench (``python -m ecfft_tpu_torch.bench``) on the CPU,
with ``ECFFT_BENCH_DEVICE=cpu`` at n ≤ 16, B = 3: its one JSON line, its
gate inputs against bench.py's numpy recipe, its gate failing on a wrong
ENTER or EXIT (the native engine is the witness), no executor fallback,
the refusal without a card, the tree cache, and a run with JAX blocked."""

import ast
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import ecfft_tpu_torch.bench as bench
from ecfft_tpu_torch import FFTree
from ecfft_tpu_torch.fields.registry import FIELDS
from ecfft_tpu_torch.ops import unrolled
from ecfft_tpu_torch.ops._build import native_library

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, BATCH, REPS = 16, 3, 2
KEYS = {"metric", "value", "unit", "vs_baseline", "gpu_s_per_poly",
        "native_1core_s_per_poly", "native_baseline_reps_s", "executor",
        "device"}


@pytest.fixture
def knobs(monkeypatch, tmp_path):
    """The bench on the CPU at a small size, its caches in ``tmp_path``."""
    monkeypatch.setenv("ECFFT_BENCH_DEVICE", "cpu")
    monkeypatch.setenv("ECFFT_BENCH_N", str(N))
    monkeypatch.setenv("ECFFT_BENCH_BATCH", str(BATCH))
    monkeypatch.setenv("ECFFT_BENCH_REPS", str(REPS))
    monkeypatch.setenv("ECFFT_BENCH_FIELD", "secp256k1")
    monkeypatch.delenv("ECFFT_EXECUTOR", raising=False)
    monkeypatch.setattr(bench, "CACHE_DIR", str(tmp_path))
    return monkeypatch


def _spy(monkeypatch, name, change=None):
    """Record each call of ``FFTree.<name>`` as (input, output); ``change``
    may alter the first call's output in place."""
    calls = []
    orig = getattr(FFTree, name)

    def spy(self, x, *a, **k):
        out = orig(self, x, *a, **k)
        if change is not None and not calls:
            change(out)
        calls.append((x.clone(), out.clone()))
        return out

    monkeypatch.setattr(FFTree, name, spy)
    return calls


@pytest.mark.parametrize("field,executor", [
    ("secp256k1", "scan"), ("secp256k1", "unrolled"), ("m31", "scan"),
    ("m31", "unrolled")])
def test_one_json_line(knobs, capsys, field, executor):
    """Exactly one stdout line, with bench.py's keys as the port changes
    them, value = B / the best warm time and vs_baseline = value × the
    native s/poly (best of its 3 reps)."""
    knobs.setenv("ECFFT_BENCH_FIELD", field)
    if executor == "unrolled":
        knobs.setenv("ECFFT_EXECUTOR", "unrolled")
    got = bench.main()
    out, err = capsys.readouterr()
    lines = out.splitlines()
    assert len(lines) == 1
    res = json.loads(lines[0])
    assert res == got
    assert set(res) == KEYS
    assert res["unit"] == "polys/sec"
    assert res["executor"] == executor
    assert res["device"] == "cpu"
    assert res["metric"] == (f"batched ENTER throughput, {field}, n=2^4, "
                             f"batch {BATCH}, 1 CPU")
    times = ast.literal_eval(re.search(r"warm times: (\[.*?\])", err)[1])
    assert len(times) == REPS
    assert res["value"] == BATCH / min(times)
    assert res["gpu_s_per_poly"] == min(times) / BATCH
    assert len(res["native_baseline_reps_s"]) == 3
    native = res["native_1core_s_per_poly"]
    assert native == min(res["native_baseline_reps_s"])
    assert res["vs_baseline"] == pytest.approx(res["value"] * native,
                                               rel=1e-12)
    assert "correctness gate passed" in err
    for stage in ("tree built in", "prepare (", "first call: "):
        assert stage in err


@pytest.mark.parametrize("field", ["secp256k1", "m31"])
def test_gate_inputs_are_bench_py_recipe(knobs, field):
    """The first call's input is bench.py's numpy draw, bit for bit
    (``bench.py``'s lines recomputed here)."""
    knobs.setenv("ECFFT_BENCH_FIELD", field)
    calls = _spy(knobs, "enter")
    bench.main()
    spec = FIELDS[field]
    L = spec.num_limbs
    rng = np.random.RandomState(1)
    if L == 1:
        coeffs = rng.randint(0, spec.p, size=(BATCH, N, 1)).astype(np.uint32)
    else:
        top = spec.to_limbs(spec.p)[-1]
        coeffs = rng.randint(0, 1 << 16, size=(BATCH, N, L)).astype(np.uint32)
        coeffs[..., -1] = rng.randint(0, top, size=(BATCH, N))
    np.testing.assert_array_equal(calls[0][0].numpy().astype(np.uint32),
                                  coeffs)
    # every timed rep gets fresh inputs by the same value recipe
    assert len(calls) == 1 + REPS
    for i, (x, _) in enumerate(calls[1:]):
        assert not torch.equal(x, calls[0][0])
        assert all(not torch.equal(x, y) for y, _ in calls[2 + i:])
        assert (x >= 0).all()
        if L == 1:
            assert (x < spec.p).all()
        else:
            assert (x < 1 << 16).all() and (x[..., -1] < top).all()


def test_a_flipped_limb_in_the_last_poly_fails_the_gate(knobs, capsys):
    def flip(out):
        out[BATCH - 1, 5, 3] ^= 1

    _spy(knobs, "enter", flip)
    with pytest.raises(bench.GateError,
                       match=rf"ENTER .* native engine \(poly {BATCH - 1}, "
                             r"first at position 5\)"):
        bench.main()
    assert capsys.readouterr().out == ""


def test_a_broken_exit_round_trip_fails_the_gate(knobs, capsys):
    def flip(out):
        out[0, 0, 0] ^= 1

    _spy(knobs, "exit", flip)
    with pytest.raises(bench.GateError,
                       match=r"EXIT .* round-trip ENTER \(poly 0\)"):
        bench.main()
    assert capsys.readouterr().out == ""


def test_an_unrolled_failure_raises_and_starts_no_subprocess(knobs, capsys):
    """bench.py retries a failed non-scan executor on the scan executor in
    a fresh process; the port's bench raises."""
    native_library()  # built before subprocesses are counted
    knobs.setenv("ECFFT_EXECUTOR", "unrolled")
    started = []

    def record(*a, **k):
        started.append(a)
        raise AssertionError("the bench started a process")

    for name in ("run", "Popen", "call", "check_call", "check_output"):
        knobs.setattr(subprocess, name, record)
    knobs.setattr(os, "execv", record)

    def broken(*a, **k):
        raise RuntimeError("the unrolled executor broke")

    knobs.setattr(unrolled, "run_unrolled", broken)
    with pytest.raises(RuntimeError, match="the unrolled executor broke"):
        bench.main()
    assert started == []
    assert capsys.readouterr().out == ""


def test_without_a_card_the_bench_refuses(knobs, capsys):
    knobs.delenv("ECFFT_BENCH_DEVICE")
    knobs.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        bench.main()
    assert "no CUDA device" in str(exc.value.code)
    assert "ECFFT_BENCH_DEVICE=cpu" in str(exc.value.code)
    assert capsys.readouterr().out == ""


def test_an_unknown_device_is_refused(knobs, capsys):
    knobs.setenv("ECFFT_BENCH_DEVICE", "gpu")
    with pytest.raises(SystemExit, match="ECFFT_BENCH_DEVICE='gpu'"):
        bench.main()
    assert capsys.readouterr().out == ""


def test_the_cache_written_first_is_read_second(knobs, tmp_path):
    from ecfft_tpu_torch import fftree, serialize_native

    bench.main()
    cache = tmp_path / f".bench_tree_secp256k1_{N}.npz"
    assert cache.exists()
    assert list(tmp_path.glob(".pool_secp256k1_*.npz"))
    assert len(list(tmp_path.glob(".sched_secp256k1_*.npz"))) == 2
    loaded = []
    load = serialize_native.load_tables_npz

    def spy(path, device="cuda"):
        loaded.append(path)
        return load(path, device)

    def no_build(*a, **k):
        raise AssertionError("the cached tree was built again")

    knobs.setattr(serialize_native, "load_tables_npz", spy)
    knobs.setattr(fftree, "build_fftree_native", no_build)
    bench.main()
    assert loaded == [str(cache)]


def _run(code, env):
    full = {k: v for k, v in os.environ.items()
            if not k.startswith("ECFFT_") and k != "PYTHONPATH"}
    full.update(env, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    return subprocess.run(
        [sys.executable, "-c",
         "import sys\nsys.modules['jax'] = None\n"
         "sys.modules['ecfft_tpu'] = None\n" + code],
        cwd=REPO, env=full, capture_output=True, text=True, timeout=300)


def test_the_bench_runs_with_jax_blocked(tmp_path):
    """The module imports, and the whole bench runs, with ``jax`` and
    ``ecfft_tpu`` blocked from import."""
    res = _run("import ecfft_tpu_torch.bench as b\n"
               f"b.CACHE_DIR = {str(tmp_path)!r}\n"
               "b.main()\n",
               {"ECFFT_BENCH_DEVICE": "cpu", "ECFFT_BENCH_N": "8",
                "ECFFT_BENCH_BATCH": "2", "ECFFT_BENCH_REPS": "1",
                "ECFFT_BENCH_FIELD": "m31"})
    assert res.returncode == 0, res.stderr
    assert json.loads(res.stdout)["executor"] == "scan"


def test_python_m_without_a_card_exits_non_zero(tmp_path):
    """``python -m ecfft_tpu_torch.bench`` on a machine without a card
    names the cause, prints no result and never runs on the CPU."""
    res = _run("import runpy\n"
               "runpy.run_module('ecfft_tpu_torch.bench', "
               "run_name='__main__')\n", {})
    assert res.returncode != 0
    assert res.stdout == ""
    assert "no CUDA device" in res.stderr
