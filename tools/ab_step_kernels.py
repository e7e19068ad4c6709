#!/usr/bin/env python3
"""Time the port's nine kernels of one form from older source trees and
the current one, in turns, on one card.

Usage, from the repository root, with the kernel sources of an earlier
commit unpacked into a directory (the form's ``.cu`` files and the
headers they include)::

    mkdir -p OLD && for f in step_kernels.cu fused_kernels.cu \
        m31_kernels.cu word_arith.cuh m31_arith.cuh levels.cuh; do \
        git show COMMIT:ecfft_tpu_torch/csrc/$f > OLD/$f; done

(and ``field_arith.cuh`` from a commit that still has it)
    python3 tools/ab_step_kernels.py [--form FORM] [--only NAME] OLD \
        [MORE_DIRS ...]

``FORM`` is the kernel form to build and time (``ops/_build.py``'s
``form_sources``), each at its main shape in ``chip_smoke.py`` (state W
131200 rows, window A 65536; seeded random canonical operands, the same
for every library):

- "fold16" (the default): secp256k1, L 16, B 256;
- "cios16": the STARK prime's constants, L 16, B 256;
- "fold4": M61 = 2^61 − 1, L 4, B 1024;
- "m31": M31, L 1, B 2048 (``m31_kernels.cu``; its entry points take no
  field constants).

Builds one library from each directory and one from the current sources,
each with ``nvcc`` alone into ``ecfft_tpu_torch/_build/ab``, all builds
started together. A directory may hold a variant of one source only: the
files it lacks are the current ones. A word form's build passes
``-DECFFT_NL`` and ``-DECFFT_MONT``, which sources older than the forms
ignore (so only "fold16" is timed from those). Prints what ``-Xptxas
-v`` says of each kernel of each build (registers, shared bytes, spills).
A build whose ``word_arith.cuh`` still declares p's 16-bit limbs first in
``struct Field`` (before the general prime) takes that layout
(:class:`OldField`), any other the current one. Then times each kernel
from each library in turns (the directories, the current build, then the
same in reverse: old, new, new, old for one directory) with CUDA events
over 20 launches after 0.25 s of warm-up launches, and once more through
the port's own wrapper (the library as ``ops/step.py`` loads it), with the
SM clock and power draw read after each. The cascade runs 14 levels
(halves 64 .. 1 twice, the eighth of kind 1), the pair levels half 128
and then half 16384. ``--only NAME`` times only the kernels whose entry
point's name holds NAME (``--only cascade``). A kernel that an older
library lacks (``ecfft_mulss`` before it was written) is timed from the
libraries that have it. Prints one line per kernel and shape. Imports
nothing of JAX. Needs one CUDA card and ``nvcc``.
"""

import ctypes
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
from ecfft_tpu_torch.fields.registry import (FIELDS,  # noqa: E402
                                             spec_for_prime)
from ecfft_tpu_torch.ops import _build, step, unrolled  # noqa: E402

STARK = 0x0800000000000011000000000000000000000000000000000000000000000001
# form: (a field of that form, lanes B at its main shape)
FORMS = {"fold16": (FIELDS["secp256k1"], 256),
         "cios16": (spec_for_prime(STARK), 256),
         "fold4": (spec_for_prime((1 << 61) - 1), 1024),
         "m31": (FIELDS["m31"], 2048)}
SPEC, B = FORMS["fold16"]  # the form main() times (--form)
W, A = 131200, 65536
START = W - A - 128  # the step kernels' window
FSTART, HALF = A, 128  # the fused kernels' window and pair distance
FAR_HALF = A // 4      # the pair levels' second distance
HALVES = (64, 32, 16, 8, 4, 2, 1) * 2
KINDS = (0,) * 7 + (1,) + (0,) * 6
REPS, SETTLE_S = 20, 0.25


def build(name: str, sources: list, flags: list) -> tuple:
    """(library, one line per kernel of what ``-Xptxas -v`` reports)."""
    from torch.utils import cpp_extension

    out_dir = os.path.join(_build.BUILD_DIR, "ab", name)
    os.makedirs(out_dir, exist_ok=True)
    out = os.path.join(out_dir, f"lib{name}.so")
    nvcc = os.path.join(cpp_extension.CUDA_HOME or "/usr/local/cuda", "bin",
                        "nvcc")
    proc = subprocess.run(
        [nvcc, _build.CUDA_ARCH, "-std=c++17", "-O3", "-shared", "-Xptxas",
         "-v", "-Xcompiler", "-fPIC", *flags, "-I",
         os.path.dirname(_build.KERNEL_SOURCES[0]), "-o", out, *sources],
        capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"building {name} failed:\n{proc.stderr}")
    return out, ptxas_lines(proc.stderr)


def short_name(mangled: str) -> str:
    """``pair_kernelILb0E`` from a mangled kernel name: the identifier
    that ends in ``_kernel`` (or ``_cascade``: ``word_warp_cascadeILi8E``)
    and stands behind its own length, with its template argument."""
    for m in re.finditer(r"_(kernel|cascade)(IL[bi]\d+E)?E", mangled):
        end = m.start() + 1 + len(m.group(1))
        for n in range(len(m.group(1)) + 2, 64):
            name, size = mangled[end - n:end], str(n)
            if (re.fullmatch(r"[a-z]\w*", name)
                    and mangled[:end - n].endswith(size)):
                return name + (m.group(2) or "")
    return mangled


def ptxas_lines(log: str) -> list:
    """``ptxas -v``'s report, one line per kernel: registers, shared
    bytes, stack and spills."""
    out = []
    for m in re.finditer(
            r"Function properties for (\S+)\n\s*(\d+) bytes stack frame, "
            r"(\d+) bytes spill stores, (\d+) bytes spill loads\n"
            r"ptxas info\s*: Used (\d+) registers(?:, used \d+ barriers)?"
            r"(?:, \d+ bytes cumulative stack size)?(?:, (\d+) bytes smem)?",
            log):
        out.append(f"{short_name(m.group(1))}: "
                   f"{m.group(5)} registers, {m.group(6) or 0} B shared, "
                   f"stack {m.group(2)} B, spill stores {m.group(3)} B, "
                   f"loads {m.group(4)} B")
    return out


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def operands(dev):
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    L = SPEC.num_limbs

    def limbs(*shape):  # canonical: M31 values, or a top limb below p's
        if L == 1:
            return torch.randint(0, SPEC.p, (*shape, 1), generator=gen,
                                 device=dev, dtype=torch.int32)
        x = torch.randint(0, 1 << 16, (*shape, L), generator=gen,
                          device=dev, dtype=torch.int32)
        x[..., -1] = torch.randint(0, SPEC.to_limbs(SPEC.p)[-1], shape,
                                   generator=gen, device=dev,
                                   dtype=torch.int32)
        return x

    state = limbs(W, B).permute(0, 2, 1).contiguous()
    x1, x2 = (limbs(A, B).permute(0, 2, 1).contiguous() for _ in range(2))
    return {"state": state, "ca": limbs(A), "cb": limbs(A), "x1": x1,
            "x2": x2, "cw": limbs(len(HALVES), A),
            "aw": limbs(sum(KINDS), A)}


def kernel_args(name: str, o: dict, lv, half: int) -> tuple:
    """The C interface's arguments after the field, before the stream."""
    s, ca, cb, x1, x2 = o["state"], o["ca"], o["cb"], o["x1"], o["x2"]
    step_ints = (START, A, B)
    return {
        "ecfft_aff1s_ip": (cb, x2, s, *step_ints),
        "ecfft_aff1g_ip": (cb, x1, x2, s, *step_ints),
        "ecfft_aff2g_ip": (ca, cb, x1, x2, s, *step_ints),
        "ecfft_muladd1": (cb, x1, x2, s, *step_ints),
        "ecfft_muladd2": (ca, cb, x1, x2, s, *step_ints),
        "ecfft_fused_bf1": (cb, s, FSTART, half, A, B),
        "ecfft_fused_bf2": (ca, cb, s, FSTART, half, A, B),
        "ecfft_fused_cascade": (ctypes.byref(lv), o["cw"], o["aw"], s,
                                FSTART, unrolled.TW, A, B),
        "ecfft_mulss": (x1, x2, s, *step_ints),
    }[name]


def wrapper_call(name: str, o: dict, half: int):
    s, ca, cb, x1, x2 = o["state"], o["ca"], o["cb"], o["x1"], o["x2"]
    return {
        "ecfft_aff1s_ip": lambda: step.aff1s_ip(SPEC, cb, s, x2, START),
        "ecfft_aff1g_ip": lambda: step.aff1g_ip(SPEC, cb, s, x1, x2, START),
        "ecfft_aff2g_ip": lambda: step.aff2g_ip(SPEC, ca, cb, s, x1, x2,
                                                START),
        "ecfft_muladd1": lambda: step.muladd1(SPEC, cb, x1, x2, s, START),
        "ecfft_muladd2": lambda: step.muladd2(SPEC, ca, cb, x1, x2, s,
                                              START),
        "ecfft_fused_bf1": lambda: unrolled.fused_bf1(SPEC, s, cb, FSTART,
                                                      half),
        "ecfft_fused_bf2": lambda: unrolled.fused_bf2(SPEC, s, ca, cb,
                                                      FSTART, half),
        "ecfft_fused_cascade": lambda: unrolled.fused_cascade(
            SPEC, s, o["cw"], o["aw"], FSTART, HALVES, KINDS),
        "ecfft_mulss": lambda: step.mulss(SPEC, x1, x2, s, START),
    }[name]


class OldField(ctypes.Structure):
    """``struct Field`` as word_arith.cuh declared it before the general
    prime: p's and F's 16-bit limbs, the slack, then p and F in words."""
    _fields_ = [("p", ctypes.c_uint32 * 16), ("f", ctypes.c_uint32 * 16),
                ("slack", ctypes.c_int), ("pw", ctypes.c_uint32 * 8),
                ("fw", ctypes.c_uint32 * 8)]


def field_for(header: str):
    """The field constants in the layout of ``header``'s struct Field
    (None for M31, whose kernels take none)."""
    if step.kernel_form(SPEC) == "m31":
        return None
    new = step._field(SPEC)
    if "uint32_t p[NL];" not in open(header).read():
        return new
    L = SPEC.num_limbs
    f = [0] * L
    for off, digit in SPEC.fold_terms:
        f[off] += digit
    return OldField((ctypes.c_uint32 * 16)(*SPEC.to_limbs(SPEC.p)),
                    (ctypes.c_uint32 * 16)(*f), new.slack, new.pw, new.fw)


def launcher(lib: str, name: str, o: dict, lv, half: int, fld):
    """A function that launches kernel ``name`` of ``lib`` once, with the
    field constants ``fld``."""
    n_ptrs, n_ints = step._SIGNATURES[name]
    lead = () if fld is None else (ctypes.byref(fld),)
    fn = getattr(ctypes.CDLL(lib), name if lead else step._m31_name(name))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fn.restype = i32
    fn.argtypes = [ptr] * (len(lead) + n_ptrs) + [i32] * n_ints + [ptr]
    args = [a.data_ptr() if isinstance(a, torch.Tensor) else a
            for a in kernel_args(name, o, lv, half)]

    def run():
        err = fn(*lead, *args, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{name} from {lib}: error {err}")
    return run


def ms(fn) -> float:
    fn()
    torch.cuda.synchronize()
    end = time.perf_counter() + SETTLE_S
    while time.perf_counter() < end:
        fn()
        torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(REPS):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / REPS


def main(argv) -> int:
    global SPEC, B
    args = argv[1:]
    form, only = "fold16", ""
    while args and args[0] in ("--form", "--only"):
        if args[0] == "--form":
            form = args[1]
        else:
            only = args[1]
        args = args[2:]
    dirs = [os.path.abspath(d) for d in args]
    if not torch.cuda.is_available() or not dirs or form not in FORMS:
        print(__doc__, file=sys.stderr)
        return 1
    SPEC, B = FORMS[form]
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    print(f"form {form}: {SPEC.name}, W {W}, A {A}, L {SPEC.num_limbs}, "
          f"B {B}")
    sources, flags = _build.form_sources(form)
    jobs = {os.path.basename(d.rstrip("/")): [
        os.path.join(d, os.path.basename(src))
        if os.path.exists(os.path.join(d, os.path.basename(src))) else src
        for src in sources] for d in dirs}
    jobs["current"] = sources
    header = {k: next((h for h in (os.path.join(d, "word_arith.cuh"),)
                       if os.path.exists(h)), _build.KERNEL_HEADERS[0])
              for k, d in zip(jobs, dirs)}
    header["current"] = _build.KERNEL_HEADERS[0]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(jobs)) as pool:
        futs = {k: pool.submit(build, f"ab_{form}_{i}", srcs, flags)
                for i, (k, srcs) in enumerate(jobs.items())}
        built = {k: f.result() for k, f in futs.items()}
    libs = {k: lib for k, (lib, _) in built.items()}
    step.load_kernels(form)
    print(f"built {list(libs)} in {time.perf_counter() - t0:.1f} s")
    for k, (lib, lines) in built.items():
        print(f"{k} ({lib}):\n  " + "\n  ".join(lines))
    o = operands(dev)
    lv = unrolled._Levels(len(HALVES),
                          (ctypes.c_int * unrolled.MAX_LEVELS)(*HALVES),
                          (ctypes.c_int * unrolled.MAX_LEVELS)(*KINDS))
    order = list(libs) + list(libs)[::-1]
    cases = [(name, HALF) for name in step._SIGNATURES] + [
        (name, FAR_HALF) for name in ("ecfft_fused_bf1", "ecfft_fused_bf2")]
    entry = step._m31_name if form == "m31" else (lambda name: name)
    for name, half in cases:
        if only not in name:
            continue
        runs = {k: launcher(lib, name, o, lv, half, field_for(header[k]))
                for k, lib in libs.items()
                if hasattr(ctypes.CDLL(lib), entry(name))}
        times = [(k, ms(runs[k]), smi()) for k in order if k in runs]
        times.append(("current via the wrapper",
                      ms(wrapper_call(name, o, half)), smi()))
        what = f"{name} half {half}" if "_bf" in name else name
        print(f"[{form}] {what}: " + "; ".join(
            f"{k} {t:.4f} ms ({s})" for k, t, s in times), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
