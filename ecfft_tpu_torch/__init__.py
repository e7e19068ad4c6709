"""ecfft-tpu on PyTorch and CUDA: the port of ``ecfft_tpu`` to an NVIDIA
H100, slice by slice. This package imports torch, numpy and the standard
library only, never jax or ``ecfft_tpu``.

The first slice is ENTER and EXIT over secp256k1 on the schedule machine,
with the three in-place step kernels written in CUDA for Hopper::

    import ecfft_tpu_torch as ec

    tree = ec.build_fftree_native("secp256k1", 1 << 10, device="cuda")
    coeffs = tree.encode([[...], [...]])   # (B, n, 16) int32 limbs
    evals = tree.enter(coeffs)             # coeffs -> evals
    back = tree.exit(evals)                # evals -> coeffs
"""

from ecfft_tpu_torch.errors import (
    CurveError,
    EcfftError,
    SizeError,
    TreeConstructionError,
    UnknownFieldError,
)
from ecfft_tpu_torch.fftree import FFTree, build_fftree_native
from ecfft_tpu_torch.fields.registry import FIELDS

__all__ = [
    "FFTree", "build_fftree_native", "FIELDS",
    "EcfftError", "UnknownFieldError", "SizeError", "CurveError",
    "TreeConstructionError",
]
