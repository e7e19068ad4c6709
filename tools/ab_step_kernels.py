#!/usr/bin/env python3
"""Time the three in-place step kernels from several builds on one card.

Usage, from the repository root, with a ``step_kernels.cu`` of an earlier
commit (one that holds its own field arithmetic, as the first slice's
does) unpacked somewhere::

    python3 tools/ab_step_kernels.py OLD_STEP_KERNELS_CU [--resident]

Builds four libraries into ``ecfft_tpu_torch/_build/ab``: the old source
and the port's current sources (``KERNEL_SOURCES``), each with ``nvcc``
alone and with ``torch.utils.cpp_extension.load`` (the port's route where
``ninja`` is installed), and prints the cubins each holds
(``cuobjdump -lelf``). Then times ``ecfft_aff1s_ip``, ``ecfft_aff1g_ip``
and ``ecfft_aff2g_ip`` from each at the main path's step shape (state W
131200, window A 65536 at row 65536, L 16, B 256; seeded random
operands, the same for every library): CUDA events over 20 launches
after a warm-up, the libraries in turns (first to last, then last to
first), with the SM clock and power draw read after each. The current
build is also timed through its Python wrapper, as ``chip_smoke.py``
times it. All of that runs twice: as it starts, and again after one run
of the 2-mul step's plain version at that shape (tens of GB of int64
temporaries through the caching allocator, then ``empty_cache``), as
``chip_smoke.py`` runs one just before it times each kernel.
``--resident`` first builds the main path's tree, pool and schedules on
the card, as ``chip_smoke.py`` does before it times the kernels. Imports
nothing of JAX. Needs one CUDA card and ``nvcc``.
"""

import ctypes
import os
import shutil
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
from ecfft_tpu_torch import build_fftree_native  # noqa: E402
from ecfft_tpu_torch.fields.registry import FIELDS  # noqa: E402
from ecfft_tpu_torch.ops import _build, step  # noqa: E402

SPEC = FIELDS["secp256k1"]
L = SPEC.num_limbs
W, A, B = 131200, 65536, 256
START = W - A - 128
KERNELS = {"ecfft_aff1s_ip": 3, "ecfft_aff1g_ip": 4, "ecfft_aff2g_ip": 5}
REPS = 20


def build(name: str, sources: list, route: str) -> str:
    from torch.utils import cpp_extension

    out_dir = os.path.join(_build.BUILD_DIR, "ab", name)
    os.makedirs(out_dir, exist_ok=True)
    if route == "load":
        cpp_extension.load(name=name, sources=sources,
                           build_directory=out_dir,
                           extra_cuda_cflags=["-O3", _build.CUDA_ARCH],
                           is_python_module=False, verbose=False)
        return os.path.join(out_dir, f"{name}.so")
    out = os.path.join(out_dir, f"lib{name}.so")
    nvcc = os.path.join(cpp_extension.CUDA_HOME or "/usr/local/cuda", "bin",
                        "nvcc")
    subprocess.run([nvcc, _build.CUDA_ARCH, "-std=c++17", "-O3", "-shared",
                    "-Xcompiler", "-fPIC", "-o", out, *sources], check=True)
    return out


def cubins(lib: str) -> str:
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([tool, "-lelf", lib], capture_output=True,
                         text=True).stdout
    return " ".join(line.split()[-1] for line in out.splitlines() if line)


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def operands(dev):
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)

    def limbs(*shape):
        x = torch.randint(0, 1 << 16, (*shape, L), generator=gen,
                          device=dev, dtype=torch.int32)
        x[..., -1] = torch.randint(0, SPEC.to_limbs(SPEC.p)[-1], shape,
                                   generator=gen, device=dev,
                                   dtype=torch.int32)
        return x

    state = limbs(W, B).permute(0, 2, 1).contiguous()
    x1, x2 = (limbs(A, B).permute(0, 2, 1).contiguous() for _ in range(2))
    return state, limbs(A), limbs(A), x1, x2


def launcher(lib: str, name: str, ops):
    """A function that launches kernel ``name`` of ``lib`` once."""
    fn = getattr(ctypes.CDLL(lib), name)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fn.restype = i32
    fn.argtypes = [ptr] * (1 + KERNELS[name]) + [i32] * 3 + [ptr]
    state, ca, cb, x1, x2 = ops
    args = {"ecfft_aff1s_ip": (cb, x2, state),
            "ecfft_aff1g_ip": (cb, x1, x2, state),
            "ecfft_aff2g_ip": (ca, cb, x1, x2, state)}[name]
    ptrs = [a.data_ptr() for a in args]
    fld = step._field(SPEC)

    def run():
        err = fn(ctypes.byref(fld), *ptrs, START, A, B,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{name} from {lib}: error {err}")
    return run


def wrapper(name: str, ops):
    state, ca, cb, x1, x2 = ops
    if name == "ecfft_aff1s_ip":
        return lambda: step.aff1s_ip(SPEC, cb, state, x2, START)
    if name == "ecfft_aff1g_ip":
        return lambda: step.aff1g_ip(SPEC, cb, state, x1, x2, START)
    return lambda: step.aff2g_ip(SPEC, ca, cb, state, x1, x2, START)


def ms(fn) -> float:
    fn()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(REPS):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / REPS


def main(argv) -> int:
    if not torch.cuda.is_available() or len(argv) < 2:
        print(__doc__, file=sys.stderr)
        return 1
    old = os.path.abspath(argv[1])
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    libs = {"old-nvcc": build("ab_old_nvcc", [old], "nvcc"),
            "old-load": build("ab_old_load", [old], "load"),
            "cur-nvcc": build("ab_cur_nvcc", _build.KERNEL_SOURCES, "nvcc"),
            "cur-load": step.load_kernels()._name}
    for k, lib in libs.items():
        print(f"{k}: {lib}: cubins {cubins(lib)}")
    if "--resident" in argv:
        tree = build_fftree_native("secp256k1", 1 << 16, device=dev).prepare()
        print(f"resident: tree, pool ({tree._pool.shape[0]} rows) and "
              f"schedules; {torch.cuda.memory_allocated(dev) / 1e9:.3f} GB "
              "allocated")
    ops = operands(dev)
    order = list(libs) + list(libs)[::-1]
    for when in ("as it starts", "after a plain run"):
        if when != "as it starts":
            state, ca, cb, x1, x2 = ops
            step._muladd2_cols(SPEC, ca.unsqueeze(-1), x1, cb.unsqueeze(-1),
                               x2)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
        for name in KERNELS:
            runs = {k: launcher(lib, name, ops) for k, lib in libs.items()}
            times = [(k, ms(runs[k]), smi()) for k in order]
            times.append(("cur-load via the wrapper",
                          ms(wrapper(name, ops)), smi()))
            print(f"{when}, {name}: " + "; ".join(
                f"{k} {t:.4f} ms ({s})" for k, t, s in times), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
