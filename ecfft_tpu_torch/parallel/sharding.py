"""Batch sharding over a list of devices.

The port's counterpart of ``ecfft_tpu/parallel/sharding.py``. The natural
scaling axis of ECFFT workloads is the batch of polynomials: every
algorithm is batch-parallel (no cross-polynomial term anywhere in
fftree.rs:72-316), so

- the tree's tables, domain and schedules are shared and each device holds
  its own copy of what runs there (the pool, the schedules' residual banks,
  the unscheduled forms' tables): :func:`replicate_tree`;
- the batch is split along its leading axis, one shard a device:
  :func:`shard_batch`;
- each device runs the identical program on its shard, on its own
  current stream, and no tensor crosses between devices: outputs stay
  sharded, a list of per-device tensors in device order, with no gather.

The "mesh" is a plain list of ``torch.device``s, which may repeat (two
shards on one card, or on the CPU in the tests). Sharding the n (domain)
axis is not done, as in the JAX package: EXTEND's butterfly pairs
positions (i, i + k/2) at every level, which would need an all-to-all per
level.
"""

from __future__ import annotations

import copy

import numpy as np
import torch


def make_mesh(devices=None) -> list:
    """The devices a batch is split over: ``devices`` (names or
    ``torch.device``s; entries may repeat), or every visible card. Raises
    where a card is named, or none is given, and this machine has none."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device; name the devices "
                               "(e.g. [\"cpu\", \"cpu\"]) to shard on the CPU")
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    mesh = [torch.device(d) for d in devices]
    if not mesh:
        raise ValueError("make_mesh: no device given")
    if any(d.type == "cuda" for d in mesh) and not torch.cuda.is_available():
        raise RuntimeError("make_mesh: a CUDA device is named and this "
                           "machine has none")
    return mesh


def replicate_tree(tree, mesh: list) -> list:
    """One tree per device of ``mesh``, in its order: the CPU tables, the
    domain, the pool's offsets and the emitted schedules shared; each with
    its own pool, residual banks and unscheduled tables on its device
    (``FFTree.place_on`` moves them on a copy, never on ``tree``)."""
    out = []
    for device in mesh:
        t = copy.copy(tree)
        t._scheds = {k: list(v) for k, v in tree._scheds.items()}
        out.append(t.place_on(device))
    return out


def shard_batch(mesh: list, arr) -> list:
    """An (..., n, L) batch split along its leading axis into len(mesh)
    equal shards, each contiguous on its device; a list of shards (a
    sharded output) is moved shard by shard. A batch that does not split
    evenly is refused, naming both sizes."""
    if isinstance(arr, (list, tuple)):
        if len(arr) != len(mesh):
            raise ValueError(f"{len(arr)} shards for {len(mesh)} devices")
        return [a.to(d) for a, d in zip(arr, mesh)]
    if arr.dim() < 1 or arr.shape[0] % len(mesh):
        raise ValueError(f"a batch of {arr.shape[0] if arr.dim() else 0} "
                         f"does not split evenly over {len(mesh)} devices")
    return [s.to(d).contiguous()
            for s, d in zip(arr.chunk(len(mesh)), mesh)]


class ShardedFFTree:
    """An FFTree run across the devices of a mesh, batch-sharded.

    Usage::

        mesh = make_mesh()                 # every card
        stree = ShardedFFTree(tree, mesh).prepare()
        evals = stree.enter(coeffs)        # a list: one shard a device

    Methods mirror :class:`ecfft_tpu_torch.fftree.FFTree`; an input is
    one batch (split on entry) or a list of shards (a sharded output, so
    sharded calls compose), and an output is a list of per-device tensors
    in device order, with no gather. Tables given at run time (REDC's and
    MOD's ``a``, ``c``) go to every device whole.
    """

    def __init__(self, tree, mesh: list | None = None):
        self.mesh = mesh if mesh is not None else make_mesh()
        self.tree = tree
        self.trees = replicate_tree(tree, self.mesh)

    def prepare(self, sizes: tuple | None = None,
                cache_dir: str | None = None) -> "ShardedFFTree":
        """Build (or load) the pool and the ENTER/EXIT schedules once, on
        the tree, and replicate them to every device."""
        self.tree.prepare(sizes, cache_dir=cache_dir)
        self.trees = replicate_tree(self.tree, self.mesh)
        return self

    def _call(self, method: str, arr, *args) -> list:
        return [getattr(t, method)(
            x, *(a.to(t.device) if isinstance(a, torch.Tensor) else a
                 for a in args))
            for t, x in zip(self.trees, shard_batch(self.mesh, arr))]

    def enter(self, coeffs):
        return self._call("enter", coeffs)

    def exit(self, evals):
        return self._call("exit", evals)

    def extend(self, evals, moiety):
        return self._call("extend", evals, moiety)

    def mextend(self, evals, moiety):
        return self._call("mextend", evals, moiety)

    def degree(self, evals):
        return self._call("degree", evals)

    def vanish(self, points):
        return self._call("vanish", points)

    def redc_z0(self, evals, a=None):
        return self._call("redc_z0", evals, a)

    def redc_z1(self, evals, a=None):
        return self._call("redc_z1", evals, a)

    def modular_reduce(self, evals, a=None, c=None):
        return self._call("modular_reduce", evals, a, c)

    def encode(self, values) -> torch.Tensor:
        return self.tree.encode(values)

    def decode(self, arr) -> np.ndarray:
        """A batch or a list of shards → object array of python ints (the
        shards' in order)."""
        if isinstance(arr, (list, tuple)):
            return np.concatenate([self.tree.decode(a) for a in arr])
        return self.tree.decode(arr)
