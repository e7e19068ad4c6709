"""ecfft-tpu on PyTorch and CUDA: the port of ``ecfft_tpu`` to an NVIDIA
H100, slice by slice. This package imports torch, numpy and the standard
library only, never jax or ``ecfft_tpu``.

The port carries the FFTree's eight algorithms (ENTER, EXIT, EXTEND,
MEXTEND, DEGREE, REDC, MOD, VANISH) over two fields, secp256k1 (16 limbs
of 16 bits) and M31 (one 32-bit limb), on the schedule machine, on the
scan executor or (``ECFFT_EXECUTOR=unrolled``) the unrolled one, with
every step kernel written in CUDA for Hopper. Trees live on the card
unless the caller passes ``device="cpu"``::

    import ecfft_tpu_torch as ec

    tree = ec.build_fftree("secp256k1", 1 << 10)  # on "cuda"
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
from ecfft_tpu_torch.fftree import (S0, S1, FFTree, build_fftree,
                                    build_fftree_native)
from ecfft_tpu_torch.fields.registry import FIELDS

__all__ = [
    "FFTree", "S0", "S1", "build_fftree", "build_fftree_native", "FIELDS",
    "EcfftError", "UnknownFieldError", "SizeError", "CurveError",
    "TreeConstructionError",
]
