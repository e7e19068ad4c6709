"""The FFTree: precomputed tables plus the ENTER/EXIT transforms.

The port's counterpart of ``ecfft_tpu/fftree.py`` for the first slice:
ENTER (coefficients → evaluations) and EXIT (evaluations → coefficients)
on the schedule machine, over fold-friendly 16-bit-limb fields such as
secp256k1.

The tables (``{m: {name: (rows, L) int32, "mats": [...]}}``, the JAX
package's layout) stay on the CPU: they feed only the coefficient pool,
which is built there once (:meth:`FFTree.prepare`) and then moved to the
tree's device with the schedules' residual banks. Batches are (..., n, L)
int32 tensors of 16-bit limbs on that device: the card (``"cuda"``)
unless the caller names another. Constructing a tree touches no device.

``ECFFT_EXECUTOR=unrolled`` runs the transforms on the unrolled executor
(``ops/unrolled.py``); its per-schedule fusion analysis is cached beside
the schedule, made in :meth:`FFTree.prepare` when that executor is
selected.
"""

from __future__ import annotations

import numpy as np
import torch

from ecfft_tpu_torch.convert import tables_from_numpy
from ecfft_tpu_torch.errors import SizeError
from ecfft_tpu_torch.fields import device as fd
from ecfft_tpu_torch.fields.registry import FieldSpec, get_spec
from ecfft_tpu_torch.native import build_tables_native
from ecfft_tpu_torch.ops import emit
from ecfft_tpu_torch.ops.schedule import (build_pool, run_schedule,
                                          unrolled_selected)
from ecfft_tpu_torch.ops.unrolled import _SchedMeta

_EMITTERS = {"enter": emit.enter_schedule, "exit": emit.exit_schedule}


class FFTree:
    """ECFFT evaluation-domain tables for one field and size ``n``, serving
    every power-of-two size ≤ n, with batch-first ENTER and EXIT."""

    def __init__(self, spec: str | FieldSpec, n: int, tables: dict,
                 device="cuda"):
        self.spec = get_spec(spec)
        fd.check_fold(self.spec)
        self.n = n
        self.tables = tables
        self.device = torch.device(device)
        self._pool = None
        self._pool_off = None
        self._scheds: dict = {}

    def encode(self, values) -> torch.Tensor:
        """Python ints → (..., L) int32 limbs on the tree's device."""
        return fd.encode(self.spec, values, self.device)

    def decode(self, arr) -> np.ndarray:
        """(..., L) limbs → object array of python ints."""
        return fd.decode(self.spec, arr)

    def _size_check(self, m: int):
        if m < 1 or m & (m - 1):
            raise SizeError("input size must be a power of two")
        if m > self.n:
            raise SizeError("FFTree is too small")

    @property
    def pool_offsets(self) -> dict:
        self.prepare(())
        return self._pool_off

    def prepare(self, sizes: tuple | None = None) -> "FFTree":
        """Build the coefficient pool (on the CPU, then moved to the
        device) and the ENTER/EXIT schedules for ``sizes`` (default: n),
        with the unrolled executor's analysis where it is selected, ahead
        of the first transform."""
        if self._pool is None:
            pool, self._pool_off = build_pool(self.spec, self.tables)
            self._pool = pool.to(self.device)
        for m in (self.n,) if sizes is None else sizes:
            for alg in _EMITTERS:
                self._schedule(alg, m)
        return self

    def _schedule(self, alg: str, m: int):
        """[schedule, residual bank on the device, unrolled analysis or
        None] for ``alg`` at size m, built at first use."""
        key = (alg, m)
        if key not in self._scheds:
            self.prepare(())
            s = _EMITTERS[alg](self._pool_off, m)
            bank = torch.from_numpy(s.xs[5]).to(self.device, torch.int64)
            self._scheds[key] = [s, bank, None]
        entry = self._scheds[key]
        if entry[2] is None and unrolled_selected():
            entry[2] = _SchedMeta(entry[0])
        return entry

    def _run_sched(self, alg: str, batch) -> torch.Tensor:
        m = batch.shape[-2]
        self._size_check(m)
        if (batch.dtype != torch.int32 or batch.device != self.device
                or batch.shape[-1] != self.spec.num_limbs):
            raise ValueError(
                f"expected (..., {m}, {self.spec.num_limbs}) int32 limbs on "
                f"{self.device}, got {tuple(batch.shape)} {batch.dtype} on "
                f"{batch.device}")
        sched, bank, meta = self._schedule(alg, m)
        flat = batch.reshape(-1, m, self.spec.num_limbs)
        out = run_schedule(self.spec, self._pool, sched, bank, flat,
                           one_pos=2 * m, m_out=m, meta=meta)
        return out.reshape(batch.shape)

    def enter(self, coeffs) -> torch.Tensor:
        """Coefficients → evaluations (fftree.rs:164-167)."""
        return self._run_sched("enter", coeffs)

    def exit(self, evals) -> torch.Tensor:
        """Evaluations → coefficients (fftree.rs:227-230)."""
        return self._run_sched("exit", evals)


def build_fftree_native(field: str | FieldSpec, n: int,
                        device="cuda") -> FFTree | None:
    """A size-``n`` FFTree whose tables the native engine builds; None
    when n exceeds the field's curve two-adicity."""
    spec = get_spec(field)
    fd.check_fold(spec)
    tables = build_tables_native(spec, n)
    if tables is None:
        return None
    return FFTree(spec, n, tables_from_numpy(tables), device)
