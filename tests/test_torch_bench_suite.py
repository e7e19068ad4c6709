"""The port's per-op bench suite (``ecfft_tpu_torch/bench_suite.py``) on
the CPU at a tiny size: it runs every row of the JAX package's suite
(``ecfft_tpu/bench_suite.py``), under the same names, and prints a table
of positive times; ``--comparison`` adds the NTT's two lines."""

import os
import re

import pytest

from ecfft_tpu_torch import bench_suite

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def jax_row_names():
    """The row names the JAX suite prints, read from its source (running
    it would compile eight JAX transforms)."""
    with open(os.path.join(REPO, "ecfft_tpu", "bench_suite.py")) as f:
        src = f.read()
    names = re.findall(r'\(\s*"([^"]+)",\s*(?:lambda|gen_s|time\.time)', src)
    names += re.findall(r'rows\.append\(\("([^"]+)"', src)
    return list(dict.fromkeys(names))


def table(out: str) -> dict:
    rows = {}
    for line in out.splitlines():
        m = re.match(r"^(.+?)\s+(\d+\.\d{4})\s+(\d+\.\d{3})$", line)
        if m:
            rows[m.group(1).strip()] = (float(m.group(2)), float(m.group(3)))
    return rows


@pytest.mark.parametrize("native", [False, True], ids=["device", "native"])
def test_suite_prints_the_jax_suites_rows(capsys, native):
    want = [n for n in jax_row_names() if native or "native ENTER" not in n
            and "native EXTEND" not in n]
    assert {"tree generate (native)", "ENTER", "VANISH",
            "deserialize compressed"} <= set(want)
    bench_suite.main(["--device", "cpu", "--n", "16", "--batch", "2",
                      "--reps", "1"] + ["--native"] * native)
    out, err = capsys.readouterr()
    assert "# field=m31 n=16 batch=2 device=cpu" in err
    assert out.splitlines()[0].split() == ["op", "total", "s", "per",
                                           "poly", "ms"]
    rows = table(out)
    assert list(rows) == want
    assert all(secs >= 0 for secs, _ in rows.values())


def test_comparison_adds_the_ntt(capsys, monkeypatch):
    """--comparison: the NTT over the STARK prime beside secp256k1's rows
    (at n = 16 here instead of 8192)."""
    monkeypatch.setattr(bench_suite, "COMPARISON_N", 16)
    bench_suite.main(["--device", "cpu", "--comparison", "--batch", "2",
                      "--reps", "1"])
    out, err = capsys.readouterr()
    assert "# NTT evaluate (STARK prime):" in err
    assert "# NTT interpolate (STARK prime):" in err
    assert "field=secp256k1 n=16 batch=2" in err
    assert list(table(out))[:3] == ["tree generate (native)", "ENTER", "EXIT"]


def test_trace_writes_a_chrome_trace_and_time_op_returns_the_result(
        tmp_path):
    import json

    import torch

    from ecfft_tpu_torch.utils.profiling import time_op, trace

    x = torch.arange(64, dtype=torch.int64)
    with trace(str(tmp_path / "prof")):
        best, out = time_op(lambda: x * 3, reps=2)
    assert best >= 0 and torch.equal(out, x * 3)
    with open(tmp_path / "prof" / "trace.json") as f:
        assert json.load(f)["traceEvents"]
