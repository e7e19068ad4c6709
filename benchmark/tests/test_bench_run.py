"""A run end to end on the CPU at a small size: the harness's look for a
card skipped, everything else as on the card. It must come out correct,
and not correct with its timed path broken (each fault a cell can have)
or with the control's lower precision; without a card the command must
fail rather than measure the CPU; and no run may hold JAX."""

import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark import harness  # noqa: E402
from benchmark.control import lower_precision  # noqa: E402

CELLS = ("secp256k1-n16.enter-b135", "m31-n16.enter-b158",
         "secp256k1-n16.enter-b13", "m31-n16.exit-b158")
SEED = 2**33 + 5  # more than 32 signed bits hold


def small(cell: str, tmp_path, **kw) -> dict:
    """One run of ``cell`` on the CPU at n = 64, 5 polys a call (not a
    power of two, as in the cells), every lane of every call kept for the
    check."""
    c = harness.Cell(cell)
    cfg = dict(c.config, n=64)
    traffic = dict(c.traffic, batch=5, keep=5, check_polys=10_000,
                   trace_calls=0)
    return harness.run_cell(cell, SEED, 0.3, False, device="cpu",
                            cache=str(tmp_path), config=cfg,
                            traffic=traffic, **kw)


def test_forbidden_modules_compare_top_level_names_whole():
    names = ["ecfft_tpu_torch", "ecfft_tpu_torch.ops.graphs", "jaxtyping",
             "numpy", "benchmark.harness", "flaxen"]
    assert harness.forbidden_modules(names) == []
    assert harness.forbidden_modules(
        names + ["jax", "jax.numpy", "jaxlib.xla_client", "flax",
                 "ecfft_tpu", "ecfft_tpu.ops"]) == [
        "ecfft_tpu", "ecfft_tpu.ops", "flax", "jax", "jax.numpy",
        "jaxlib.xla_client"]


def test_without_a_card_the_command_fails_and_prints_nothing():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", CELLS[1],
         "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout == ""
    assert "CUDA card" in proc.stderr


@pytest.mark.parametrize("cell", CELLS)
def test_a_small_run_is_correct(cell, tmp_path):
    r = small(cell, tmp_path)
    assert r["correct"], r["checks"]
    assert list(r)[-1] == "checks" and list(r)[0] == "correct"
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert r["checks"]["checked_polys"]["value"] == 5 * r["attempted"]
    assert {"polys_per_s", "setup_s"} <= set(r["metrics"])
    assert harness.forbidden_modules(list(sys.modules)) == []


def unchanged_state(monkeypatch):
    """A step loop that returns its state unchanged."""
    from ecfft_tpu_torch.ops import schedule

    monkeypatch.setattr(schedule, "_run_steps", lambda *a: None)


def half_batch(method):
    """Half of the batch left out: its outputs zero."""
    def run(x):
        out = method(x)
        out[x.shape[0] // 2:] = 0
        return out
    return run


def altered(method):
    """An answer altered where it is produced: one element of each
    output off by one in its lowest limb."""
    def run(x):
        out = method(x)
        out[:, 5, 0] ^= 1
        return out
    return run


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", ["unchanged", "half", "altered",
                                   "control"])
def test_a_broken_timed_path_is_not_correct(cell, fault, tmp_path,
                                            monkeypatch):
    wrap = {"half": half_batch, "altered": altered}.get(fault)
    if fault == "unchanged":
        unchanged_state(monkeypatch)
    if fault == "control":
        wrap = lower_precision(harness.Cell(cell).config)
    r = small(cell, tmp_path, wrap=wrap)
    assert not r["correct"], r["checks"]
    assert r["checks"]["wrong_polys"]["value"] > 0


def test_the_control_command(tmp_path):
    # control.py drives the same set-up and window; at full size it runs
    # on the card, here its pieces at a small size
    c = harness.Cell(CELLS[0])
    cfg = dict(c.config, n=64)
    wrap = lower_precision(cfg)
    import torch

    x = harness.make_input(cfg, 2, 3, torch.device("cpu"))
    low = wrap(lambda t: t.clone())(x)
    assert (low[..., 0] == 0).all() and torch.equal(low[..., 1:], x[..., 1:])
    m = harness.Cell(CELLS[1])
    mcfg = dict(m.config, n=64)
    y = harness.make_input(mcfg, 2, 3, torch.device("cpu"))
    ly = lower_precision(mcfg)(lambda t: t)(y)
    assert ly.dtype == torch.int32 and int(ly.max()) < 2**31 - 1
    assert not torch.equal(ly, y)


def test_result_line_is_json(tmp_path):
    r = small(CELLS[1], tmp_path)
    line = json.dumps(r)
    assert json.loads(line)["device"]["platform"] == "cpu"
