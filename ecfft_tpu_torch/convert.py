"""Carry FFTree tables into the port.

The JAX package's ``FFTree.tables`` and the tables of
:func:`ecfft_tpu_torch.native.build_tree_native` share one layout:
``{m: {name: (rows, L) uint32 limbs, "mats": [4-tuples of (half, 2, 2,
L)]}}``. The port keeps the same layout with int32 tensors (a 16-bit limb
fits), so both packages compute on identical state.
"""

from __future__ import annotations

import numpy as np
import torch


def _tensor(arr) -> torch.Tensor:
    return torch.from_numpy(np.asarray(arr).astype(np.int32))


def tables_from_numpy(tables: dict) -> dict:
    """{m: {name: array, "mats": [...]}} of numpy (or array-like) uint32
    limbs → the same dict of int32 CPU tensors."""
    return {
        m: {name: ([tuple(_tensor(a) for a in quad) for quad in v]
                   if name == "mats" else _tensor(v))
            for name, v in t.items()}
        for m, t in tables.items()
    }
