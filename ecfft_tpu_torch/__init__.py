"""ecfft-tpu on PyTorch and CUDA: the port of ``ecfft_tpu`` to an NVIDIA
H100, slice by slice. This package imports torch, numpy and the standard
library only, never jax or ``ecfft_tpu``.

The port carries ENTER and EXIT over secp256k1 on the schedule machine,
on the scan executor or (``ECFFT_EXECUTOR=unrolled``) the unrolled one,
with every step kernel written in CUDA for Hopper. Trees live on the card
unless the caller passes ``device="cpu"``::

    import ecfft_tpu_torch as ec

    tree = ec.build_fftree_native("secp256k1", 1 << 10)  # on "cuda"
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
