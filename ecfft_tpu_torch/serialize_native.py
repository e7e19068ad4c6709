"""Fast native checkpoint format for FFTrees: one .npz of the tables.

The port's counterpart of ``ecfft_tpu/serialize_native.py``, with the
same keys (``<m>/<table>``, ``<m>/mats/<depth>/<part>``, ``__n__``,
``__field__``) and uint32 limb arrays, so a file either package wrote
loads into the other. The ark-compatible byte format
(``serialize.py``) is the interop path; this is the fast one: raw limb
arrays, no python-int conversion. The domain's layers and maps are not
kept, so a loaded tree computes but does not serialize.
"""

from __future__ import annotations

import numpy as np

from ecfft_tpu_torch.fields.registry import FIELDS


def save_tables_npz(tree, path: str) -> None:
    flat = {}
    for m, t in tree.tables.items():
        for k, v in t.items():
            if k == "mats":
                for d, parts in enumerate(v):
                    for pi, arr in enumerate(parts):
                        flat[f"{m}/mats/{d}/{pi}"] = (
                            arr.numpy().astype(np.uint32))
            else:
                flat[f"{m}/{k}"] = v.numpy().astype(np.uint32)
    flat["__n__"] = np.asarray([tree.n], dtype=np.int64)
    flat["__field__"] = np.frombuffer(
        tree.spec.name.encode(), dtype=np.uint8
    )
    np.savez(path, **flat)


def load_tables_npz(path: str, device="cuda"):
    """The tree saved at ``path``, its tables as int32 CPU tensors, on
    ``device``."""
    from ecfft_tpu_torch.convert import tables_from_numpy
    from ecfft_tpu_torch.fftree import FFTree

    with np.load(path) as z:
        field = bytes(z["__field__"]).decode()
        spec = FIELDS[field]
        n = int(z["__n__"][0])
        tables: dict[int, dict] = {}
        mats_acc: dict[int, dict[int, list]] = {}
        for key in z.files:
            if key.startswith("__"):
                continue
            parts = key.split("/")
            m = int(parts[0])
            t = tables.setdefault(m, {})
            if parts[1] == "mats":
                d, pi = int(parts[2]), int(parts[3])
                mats_acc.setdefault(m, {}).setdefault(d, [None] * 4)[pi] = \
                    z[key]
            else:
                t[parts[1]] = z[key]
    for m, byd in mats_acc.items():
        tables[m]["mats"] = [tuple(byd[d]) for d in sorted(byd)]
    for m in tables:
        tables[m].setdefault("mats", [])
    return FFTree(spec, n, tables_from_numpy(tables), device)
