"""The port's examples as users run them (``python -m
ecfft_tpu_torch.examples.<name>``), each in a process of its own with
``jax`` and ``ecfft_tpu`` blocked: ``interp_eval`` at n = 2^6, batch 2 on
the CPU (ENTER checked against naive evaluation, the EXIT round trip),
``find_curve`` at k = 8, and ``interp_eval``'s refusal to run without a
card unless the CPU is asked for."""

import os
import subprocess
import sys

import pytest
import torch

from ecfft_tpu_torch.examples import interp_eval

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_RUN = ("import runpy, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['ecfft_tpu'] = None\n"
        "name, sys.argv = sys.argv[1], sys.argv[1:]\n"
        "runpy.run_module(f'ecfft_tpu_torch.examples.{name}',\n"
        "                 run_name='__main__', alter_sys=True)\n")


def _run(name, *args):
    full = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    full["PYTHONPATH"] = REPO
    return subprocess.run([sys.executable, "-c", _RUN, name, *args],
                          cwd=REPO, env=full, capture_output=True, text=True,
                          timeout=300)


def test_interp_eval_on_the_cpu():
    res = _run("interp_eval", "6", "2", "--device", "cpu")
    assert res.returncode == 0, res.stderr
    lines = res.stdout.splitlines()
    assert lines[0].startswith("FFTree generation time: ")
    assert lines[1].startswith("evaluation time (fft), batch 2: ")
    assert lines[-1] == "roundtrip exact ✓"


def test_interp_eval_refuses_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device .*--device cpu"):
        interp_eval.main(["4", "1"])
    assert "roundtrip" not in capsys.readouterr().out


def test_find_curve():
    res = _run("find_curve", "8", "2")
    assert res.returncode == 0, res.stderr
    first = res.stdout.splitlines()[0]
    assert first.startswith("found n=") and int(first[8:].split()[0]) >= 8
    assert "  curve: y^2 = x(x^2 + " in res.stdout
