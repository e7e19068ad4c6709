"""The port's build of its native code (ecfft_tpu_torch/ops/_build.py),
with the compiler replaced by a stand-in that records its command and
writes the output file: each form's kernel library goes through nvcc for
sm_90a, with its limb count and reduction as macros, into a temporary
file that is moved into place; a fresh library is not rebuilt, one older
than a shared header is; several forms build at once, one nvcc each; an
unknown form is refused; and a failed build raises and leaves no file
behind. The real builds run on a card (tests/test_torch_cuda.py)."""

import os
import subprocess

import pytest

from ecfft_tpu_torch.ops import _build


@pytest.fixture
def compiler(monkeypatch, tmp_path):
    """Build into ``tmp_path``; returns the list of compile commands run,
    and a switch that makes the next compile fail."""
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
    out = _build.kernel_library("fold16")
    assert os.path.dirname(out) == str(tmp_path)
    assert os.path.basename(out) == "libecfft_fold16.so"
    assert os.path.exists(out)
    (argv,) = calls
    assert os.path.basename(argv[0]) == "nvcc"
    assert _build.CUDA_ARCH in argv and "-shared" in argv
    assert "-DECFFT_NL=16" in argv and "-DECFFT_MONT=0" in argv
    assert all(src in argv for src in _build.KERNEL_SOURCES)
    assert argv[argv.index("-o") + 1] != out  # written aside, then moved
    assert _build.kernel_library("fold16") == out
    assert len(calls) == 1
    assert os.listdir(tmp_path) == [os.path.basename(out)]


def test_a_newer_header_rebuilds(compiler, tmp_path, tmp_path_factory,
                                 monkeypatch):
    """Only the header changed since the build: the form rebuilds."""
    calls, _ = compiler
    header = tmp_path_factory.mktemp("csrc") / "word_arith.cuh"
    header.write_text("// stand-in header\n")
    monkeypatch.setattr(_build, "KERNEL_HEADERS", [str(header)])
    out = _build.kernel_library("cios13")
    assert _build.kernel_library("cios13") == out and len(calls) == 1
    later = os.path.getmtime(out) + 10
    os.utime(header, (later, later))
    assert _build.kernel_library("cios13") == out
    assert len(calls) == 2
    assert all(src in calls[1] for src in _build.KERNEL_SOURCES)
    assert "-DECFFT_NL=13" in calls[1] and "-DECFFT_MONT=1" in calls[1]


def test_forms_build_at_once_each_from_its_sources(compiler, tmp_path):
    """Three forms in one call: one nvcc each, the M31 form from its own
    source without the word forms' macros; an unknown form (a CIOS form
    of one limb among them) is refused before any compile."""
    calls, _ = compiler
    got = _build.build_kernels(["fold16", "m31", "cios3", "fold16"])
    assert sorted(got) == ["cios3", "fold16", "m31"]
    assert sorted(os.listdir(tmp_path)) == [
        "libecfft_cios3.so", "libecfft_fold16.so", "libecfft_m31.so"]
    assert len(calls) == 3
    (m31,) = [a for a in calls if _build.M31_SOURCES[0] in a]
    assert not any(a.startswith("-DECFFT") for a in m31)
    for bad in ("cios1", "fold0", "cios17", "limbs16", "m61"):
        with pytest.raises(ValueError, match="no kernel form"):
            _build.kernel_library(bad)
    assert len(calls) == 3
    # one 16-bit limb takes the fold form only
    assert _build.form_sources("fold1") == (
        _build.KERNEL_SOURCES, ["-DECFFT_NL=1", "-DECFFT_MONT=0"])


def test_failed_build_raises_and_leaves_nothing(compiler, tmp_path):
    _, fail = compiler
    fail.append(True)
    with pytest.raises(RuntimeError, match="stand-in"):
        _build.kernel_library("fold4")
    assert os.listdir(tmp_path) == []
