"""Builds the port's native code at first use, into ``ecfft_tpu_torch/_build``.

Two libraries, each with a plain C interface opened through ctypes:

- the kernels, from ``csrc/step_kernels.cu`` (which includes
  ``csrc/field_arith.cuh`` and ``csrc/word_arith.cuh``),
  ``csrc/fused_kernels.cu`` (``csrc/levels.cuh``, ``csrc/word_arith.cuh``)
  and ``csrc/m31_kernels.cu`` (``csrc/levels.cuh``,
  ``csrc/m31_arith.cuh``), for Hopper (``sm_90a``),
  with ``torch.utils.cpp_extension.load`` (one call, all sources, which
  tracks the header through nvcc's dependency files) where ``ninja`` is
  installed, else with ``nvcc`` directly. The sources include no PyTorch
  header, so either way the build takes seconds. This runs only where a
  CUDA tensor reaches a kernel's wrapper: no card, no build.
- the native C++ engine, from the unchanged ``native/ecfft_native.cpp``,
  with ``g++``.

A library is rebuilt when it is missing or older than its sources or
headers. Each
build writes a temporary file and moves it into place with ``os.replace``,
so processes that build at once never load a half-written library. A
failed build raises; nothing falls back.
"""

from __future__ import annotations

import os
import subprocess
import tempfile

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(_PKG, "_build")
KERNEL_SOURCES = [os.path.join(_PKG, "csrc", f)
                  for f in ("step_kernels.cu", "fused_kernels.cu",
                            "m31_kernels.cu")]
KERNEL_HEADERS = [os.path.join(_PKG, "csrc", f)
                  for f in ("field_arith.cuh", "word_arith.cuh",
                            "m31_arith.cuh", "levels.cuh")]
NATIVE_SOURCE = os.path.join(os.path.dirname(_PKG), "native",
                             "ecfft_native.cpp")
CUDA_ARCH = "-gencode=arch=compute_90a,code=sm_90a"


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


def kernel_library() -> str:
    """Path of the kernels' shared library, built if stale."""
    from torch.utils import cpp_extension

    if cpp_extension.is_ninja_available():
        kdir = os.path.join(BUILD_DIR, "kernels")
        os.makedirs(kdir, exist_ok=True)
        name = "ecfft_kernels"
        cpp_extension.load(
            name=name, sources=KERNEL_SOURCES, build_directory=kdir,
            extra_cuda_cflags=["-O3", CUDA_ARCH], is_python_module=False,
            verbose=False)
        return os.path.join(kdir, f"{name}.so")
    out = os.path.join(BUILD_DIR, "libecfft_kernels.so")
    if _stale(out, KERNEL_SOURCES + KERNEL_HEADERS):
        nvcc = os.path.join(cpp_extension.CUDA_HOME or "/usr/local/cuda",
                            "bin", "nvcc")
        _compile(lambda o: [nvcc, CUDA_ARCH, "-std=c++17", "-O3", "-shared",
                            "-Xcompiler", "-fPIC", "-o", o,
                            *KERNEL_SOURCES], out)
    return out
