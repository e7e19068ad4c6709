"""The port's build of its native code (ecfft_tpu_torch/ops/_build.py),
with the compiler replaced by a stand-in that records its command and
writes the output file: where ninja is missing, the step kernels go
through nvcc for sm_90a into a temporary file that is moved into place,
a fresh library is not rebuilt, and a failed build raises and leaves no
file behind. The real builds run on a card (tests/test_torch_cuda.py)."""

import os
import subprocess

import pytest
from torch.utils import cpp_extension

from ecfft_tpu_torch.ops import _build


@pytest.fixture
def compiler(monkeypatch, tmp_path):
    """Build into ``tmp_path`` without ninja; returns the list of compile
    commands run, and a switch that makes the next compile fail."""
    monkeypatch.setattr(cpp_extension, "is_ninja_available", lambda: False)
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    calls, fail = [], []

    def run(argv, **kw):
        calls.append(argv)
        if fail:
            return subprocess.CompletedProcess(argv, 1, "", "error: stand-in")
        with open(argv[argv.index("-o") + 1], "w") as f:
            f.write("library")
        return subprocess.CompletedProcess(argv, 0, "", "")

    monkeypatch.setattr(_build.subprocess, "run", run)
    return calls, fail


def test_nvcc_build_is_atomic_and_not_repeated(compiler, tmp_path):
    calls, _ = compiler
    out = _build.kernel_library()
    assert os.path.dirname(out) == str(tmp_path)
    assert os.path.exists(out)
    (argv,) = calls
    assert os.path.basename(argv[0]) == "nvcc"
    assert _build.CUDA_ARCH in argv and "-shared" in argv
    assert argv[argv.index("-o") + 1] != out  # written aside, then moved
    assert _build.kernel_library() == out
    assert len(calls) == 1
    assert os.listdir(tmp_path) == [os.path.basename(out)]


def test_failed_build_raises_and_leaves_nothing(compiler, tmp_path):
    _, fail = compiler
    fail.append(True)
    with pytest.raises(RuntimeError, match="stand-in"):
        _build.kernel_library()
    assert os.listdir(tmp_path) == []
