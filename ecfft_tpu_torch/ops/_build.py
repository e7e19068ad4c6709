"""Builds the port's native code at first use, into ``ecfft_tpu_torch/_build``.

Two kinds of library, each with a plain C interface opened through ctypes:

- the kernels, one library per form (``ops/step.py::kernel_form``), for
  Hopper (``sm_90a``) with ``nvcc``:

  - a word form ("fold16", "cios3", "fold1", ...: the fold or the CIOS
    reduction at a limb count) from ``csrc/step_kernels.cu`` and
    ``csrc/fused_kernels.cu`` (``csrc/word_arith.cuh``,
    ``csrc/levels.cuh``, ``csrc/warp_cascade.cuh``), compiled with
    ``-DECFFT_NL=<limbs> -DECFFT_MONT=<0|1>``: ``libecfft_<form>.so``;
  - the M31 form from ``csrc/m31_kernels.cu`` (``csrc/levels.cuh``,
    ``csrc/m31_arith.cuh``, ``csrc/warp_cascade.cuh``):
    ``libecfft_m31.so``.

  The sources include no PyTorch header, so a form builds in seconds. A
  form is built where a CUDA tensor of its field first reaches a kernel's
  wrapper (no card, no build), the counterpart of the JAX package's
  per-field ``jit``; :func:`build_kernels` builds several at once, one
  ``nvcc`` each, all started together.
- the native C++ engine, from the unchanged ``native/ecfft_native.cpp``,
  with ``g++``.

A library is rebuilt when it is missing or older than its sources or
headers. Each build writes a temporary file and moves it into place with
``os.replace``, so processes that build at once never load a half-written
library. A failed build raises; nothing falls back.
"""

from __future__ import annotations

import os
import re
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(_PKG, "_build")
_CSRC = os.path.join(_PKG, "csrc")
# the word forms' sources, and the M31 form's
KERNEL_SOURCES = [os.path.join(_CSRC, f)
                  for f in ("step_kernels.cu", "fused_kernels.cu")]
M31_SOURCES = [os.path.join(_CSRC, "m31_kernels.cu")]
KERNEL_HEADERS = [os.path.join(_CSRC, f)
                  for f in ("word_arith.cuh", "m31_arith.cuh", "levels.cuh",
                            "warp_cascade.cuh")]
NATIVE_SOURCE = os.path.join(os.path.dirname(_PKG), "native",
                             "ecfft_native.cpp")
CUDA_ARCH = "-gencode=arch=compute_90a,code=sm_90a"
_WORD_FORM = re.compile(r"^(fold|cios)(\d+)$")


def _stale(out: str, sources: list) -> bool:
    return (not os.path.exists(out) or os.path.getmtime(out)
            < max(os.path.getmtime(s) for s in sources))


def _compile(argv_for, out: str) -> None:
    """Run ``argv_for(tmp_path)`` and move the result to ``out``."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
    os.close(fd)
    try:
        proc = subprocess.run(argv_for(tmp), capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"building {os.path.basename(out)} failed:\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def native_library() -> str:
    """Path of the native engine's shared library, built if stale."""
    out = os.path.join(BUILD_DIR, "libecfft_native.so")
    if _stale(out, [NATIVE_SOURCE]):
        _compile(lambda o: ["g++", "-O3", "-march=native", "-shared",
                            "-fPIC", "-o", o, NATIVE_SOURCE], out)
    return out


def form_sources(form: str) -> tuple[list, list]:
    """(sources, extra nvcc flags) of a form's library."""
    if form == "m31":
        return M31_SOURCES, []
    m = _WORD_FORM.match(form)
    if m is None or not 1 <= int(m.group(2)) <= 16 or form == "cios1":
        raise ValueError(f"no kernel form {form!r}")
    return KERNEL_SOURCES, [f"-DECFFT_NL={int(m.group(2))}",
                            f"-DECFFT_MONT={int(m.group(1) == 'cios')}"]


def kernel_library(form: str = "fold16") -> str:
    """Path of the kernels' library of ``form``, built if stale."""
    from torch.utils import cpp_extension

    sources, flags = form_sources(form)
    out = os.path.join(BUILD_DIR, f"libecfft_{form}.so")
    if _stale(out, sources + KERNEL_HEADERS):
        nvcc = os.path.join(cpp_extension.CUDA_HOME or "/usr/local/cuda",
                            "bin", "nvcc")
        _compile(lambda o: [nvcc, CUDA_ARCH, "-std=c++17", "-O3", "-shared",
                            "-Xcompiler", "-fPIC", *flags, "-o", o,
                            *sources], out)
    return out


def build_kernels(forms) -> dict:
    """Build the libraries of ``forms`` at once, one ``nvcc`` each; returns
    {form: path}."""
    forms = list(dict.fromkeys(forms))
    with ThreadPoolExecutor(max_workers=max(len(forms), 1)) as ex:
        return dict(zip(forms, ex.map(kernel_library, forms)))
