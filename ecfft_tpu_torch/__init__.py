"""ecfft-tpu on PyTorch and CUDA: the port of ``ecfft_tpu`` to an NVIDIA
H100, slice by slice. This package imports torch, numpy and the standard
library only, never jax or ``ecfft_tpu``.

The port carries the FFTree's eight algorithms (ENTER, EXIT, EXTEND,
MEXTEND, DEGREE, REDC, MOD, VANISH) over secp256k1 (16 limbs of 16 bits),
M31 (one 32-bit limb), BN254's base field ``bn254_fq`` (Grumpkin's scalar
field; 16 limbs, Montgomery residents on the card: ``fields.bn254``) and
any other odd prime below 2^256 the JAX package runs
(``fields.registry``), on the schedule machine, on the scan executor
or (``ECFFT_EXECUTOR=unrolled``) the unrolled one, with every step kernel
written in CUDA for Hopper; the classical NTT it is compared with
(``ntt.NTTPlan``); tree persistence (``serialize``, ``serialize_native``,
``FFTree.prepare(cache_dir=…)``, ``FFTree.place_on``); the per-op
bench suite (``python -m ecfft_tpu_torch.bench_suite``); the device
bootstrap (``FFTree.build``), the unscheduled forms of the eight
algorithms (``FFTree.*_unscheduled``, ``ops/core.py``) and batch sharding
over several devices (``parallel.sharding``). Trees and plans live on
the card unless the caller passes ``device="cpu"``::

    import ecfft_tpu_torch as ec

    tree = ec.build_fftree("secp256k1", 1 << 10)  # native tables, "cuda"
    coeffs = tree.encode([[...], [...]])   # (B, n, 16) int32 limbs
    evals = tree.enter(coeffs)             # coeffs -> evals
    back = tree.exit(evals)                # evals -> coeffs
    boot = ec.FFTree.build("secp256k1", 1 << 10)  # tables built on the card
    same = boot.enter_unscheduled(coeffs)  # no schedule: level scans
"""

from ecfft_tpu_torch.errors import (
    CurveError,
    EcfftError,
    SerializationError,
    SizeError,
    TreeConstructionError,
    UnknownFieldError,
)
from ecfft_tpu_torch.fftree import (S0, S1, FFTree, build_fftree,
                                    build_fftree_native)
from ecfft_tpu_torch.fields import bn254  # noqa: F401  (registers bn254_fq)
from ecfft_tpu_torch.fields.registry import FIELDS

__all__ = [
    "FFTree", "S0", "S1", "build_fftree", "build_fftree_native", "FIELDS",
    "EcfftError", "UnknownFieldError", "SizeError", "CurveError",
    "TreeConstructionError", "SerializationError",
]
