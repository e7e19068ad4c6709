"""The FFTree: precomputed tables plus the eight transforms.

The port's counterpart of ``ecfft_tpu/fftree.py``: ENTER (coefficients →
evaluations), EXIT (evaluations → coefficients), EXTEND, MEXTEND, DEGREE,
REDC, MOD and VANISH on the schedule machine, over any odd prime below
2^256 the JAX package runs, on the card and on the CPU alike: M31, primes
of 2 to 16 limbs of 16 bits with a pseudo-Mersenne fold (secp256k1,
2^255 − 19, M61 = 2^61 − 1, 2^256 − 1053), and every other such prime in
Montgomery form with CIOS reduction (the STARK prime, a fresh prime from
``fields.registry.field_from_curve_search``); see
``ops.step.kernel_form``. Only a prime below 2^16 other than M31 is
refused. The methods carry the JAX package's names and arguments; its
``*_unscheduled`` cross-validation forms are not ported.

The tables (``{m: {name: (rows, L) int32, "mats": [...]}}``, the JAX
package's layout) stay on the CPU: they feed only the coefficient pool,
which is built there once (:meth:`FFTree.prepare`) and then moved to the
tree's device with the schedules' residual banks. Batches are (..., n, L)
int32 tensors on that device (L limbs of 16 bits, or M31's one 32-bit
limb) of canonical values: the card (``"cuda"``) unless the caller names
another. Constructing a tree touches no device. With Montgomery residents
the pool is converted once, when it is built, and each call's state on
the way in and out (``ops/schedule.py::run_chunks``).

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
from ecfft_tpu_torch.ops import emit, step
from ecfft_tpu_torch.ops.schedule import (build_pool, run_schedule,
                                          unrolled_selected)
from ecfft_tpu_torch.ops.emit import S0, S1
from ecfft_tpu_torch.ops.unrolled import _SchedMeta

# algorithm → emitter(pool offsets, prime, size, moiety)
_EMITTERS = {
    "enter": lambda off, p, m, mo: emit.enter_schedule(off, m),
    "exit": lambda off, p, m, mo: emit.exit_schedule(off, m),
    "extend": lambda off, p, m, mo: emit.extend_schedule(off, m, mo),
    "mextend": lambda off, p, m, mo: emit.extend_schedule(off, m, mo,
                                                          mextend=True),
    "degree": lambda off, p, m, mo: emit.degree_schedule(off, m),
    "redc": lambda off, p, m, mo: emit.mod_schedule(off, m, redc_only=True),
    "redc1": lambda off, p, m, mo: emit.mod_schedule(off, m, redc_only=True,
                                                     moiety=S1),
    "mod": lambda off, p, m, mo: emit.mod_schedule(off, m),
    "gredc": lambda off, p, m, mo: emit.general_mod_schedule(
        off, p, m, mo, redc_only=True),
    "gmod": lambda off, p, m, mo: emit.general_mod_schedule(
        off, p, m, S0, redc_only=False),
    "vanish": lambda off, p, m, mo: emit.vanish_schedule(off, m),
}


class FFTree:
    """ECFFT evaluation-domain tables for one field and size ``n``, serving
    every power-of-two size ≤ n, with the eight batch-first algorithms."""

    def __init__(self, spec: str | FieldSpec, n: int, tables: dict,
                 device="cuda"):
        self.spec = get_spec(spec)
        self.device = torch.device(device)
        _check_field(self.spec, self.device)
        self.n = n
        self.tables = tables
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

    def eval_domain(self, size: int | None = None) -> np.ndarray:
        """Leaf domain of the size-``size`` (sub)tree, as python ints
        (fftree.rs:502-504)."""
        size = size or self.n
        return fd.decode(self.spec, self.tables[size]["leaves"])

    @property
    def pool_offsets(self) -> dict:
        self._ensure_pool()
        return self._pool_off

    def _ensure_pool(self) -> None:
        """Build the coefficient pool (on the CPU, then moved to the
        device) once; with Montgomery residents it is converted there, one
        row product by R² mod p per row (a kernel launch on the card), as
        the JAX package converts it once per call chain
        (``_pool_to_mont``)."""
        if self._pool is None:
            pool, self._pool_off = build_pool(self.spec, self.tables)
            pool = pool.to(self.device)
            if fd.is_mont(self.spec):
                r2 = fd.encode(self.spec, self.spec.r2_mod_p, self.device)
                pool = step.mul_rows(self.spec, r2.expand_as(pool), pool)
            self._pool = pool

    def prepare(self, sizes: tuple | None = None) -> "FFTree":
        """Build the coefficient pool and the ENTER/EXIT schedules for
        ``sizes`` (default, or empty: n; the other algorithms' schedules
        are made at first use), with the unrolled executor's analysis
        where it is selected, ahead of the first transform."""
        self._ensure_pool()
        for m in sizes or (self.n,):
            for alg in ("enter", "exit"):
                self._schedule(alg, m)
        return self

    def _schedule(self, alg: str, m: int, moiety: int | None = None):
        """[schedule, residual bank on the device, unrolled analysis or
        None] for ``alg`` at size m (and, where the algorithm has one, a
        moiety), emitted at first use and kept under the JAX package's
        keys: ("enter", m), ("extend", m, moiety), ("gredc", m, moiety)."""
        key = (alg, m) if moiety is None else (alg, m, moiety)
        if key not in self._scheds:
            self._ensure_pool()
            s = _EMITTERS[alg](self._pool_off, self.spec.p, m, moiety)
            bank = torch.from_numpy(s.xs[5]).to(self.device, torch.int64)
            self._scheds[key] = [s, bank, None]
        entry = self._scheds[key]
        if entry[2] is None and unrolled_selected():
            entry[2] = _SchedMeta(entry[0])
        return entry

    def _check_limbs(self, t, what: str, lead: str = "..., ") -> None:
        if (t.dtype != torch.int32 or t.device != self.device
                or t.shape[-1] != self.spec.num_limbs):
            raise ValueError(
                f"expected {what} as ({lead}{t.shape[-2]}, "
                f"{self.spec.num_limbs}) int32 limbs on {self.device}, got "
                f"{tuple(t.shape)} {t.dtype} on {t.device}")

    def _run_sched(self, alg: str, batch, m_out: int, one_pos: int,
                   moiety: int | None = None, extras: tuple = (),
                   tree: int = 1) -> torch.Tensor:
        """Run ``alg``'s schedule on a (..., m, L) batch, on a subtree of
        ``tree``·m points; returns (..., m_out, L). ``extras`` are
        unbatched (m, L) tables packed after the batch along the position
        axis."""
        m, L = batch.shape[-2], self.spec.num_limbs
        self._size_check(m * tree)
        self._check_limbs(batch, "the batch")
        for e in extras:
            self._check_limbs(e, "a modulus table", "")
            if tuple(e.shape) != (m, L):
                raise ValueError(f"a modulus table must be ({m}, {L}), got "
                                 f"{tuple(e.shape)}")
        sched, bank, meta = self._schedule(alg, m, moiety)
        flat = batch.reshape(-1, m, L)
        out = run_schedule(self.spec, self._pool, sched, bank,
                           (flat, *extras) if extras else flat,
                           one_pos=one_pos, m_out=m_out, meta=meta)
        return out.reshape(*batch.shape[:-2], m_out, L)

    def extend(self, evals, moiety: int = S1) -> torch.Tensor:
        """⟨P ≀ moiety⟩ from ⟨P ≀ other moiety⟩, deg P < m
        (fftree.rs:123-126)."""
        m = evals.shape[-2]
        return self._run_sched("extend", evals, m, m, moiety, tree=2)

    def mextend(self, evals, moiety: int = S1) -> torch.Tensor:
        """EXTEND for monic polys of degree exactly m (fftree.rs:138-141)."""
        m = evals.shape[-2]
        return self._run_sched("mextend", evals, m, m, moiety, tree=2)

    def enter(self, coeffs) -> torch.Tensor:
        """Coefficients → evaluations (fftree.rs:164-167)."""
        n = coeffs.shape[-2]
        return self._run_sched("enter", coeffs, n, 2 * n)

    def exit(self, evals) -> torch.Tensor:
        """Evaluations → coefficients (fftree.rs:227-230)."""
        n = evals.shape[-2]
        return self._run_sched("exit", evals, n, 2 * n)

    def degree(self, evals) -> torch.Tensor:
        """Degree of the interpolant, one int32 per batch entry, on the
        tree's device (fftree.rs:195-198). OP_CMPSEL steps take the
        reference's data-dependent branch per batch lane; the accumulator
        rides the state as a field element and its first limbs (two, or
        M31's one) are decoded here, after the state has left Montgomery
        form where it was in it."""
        n = evals.shape[-2]
        if n == 1:
            self._size_check(n)
            return torch.zeros(evals.shape[:-2], dtype=torch.int32,
                               device=self.device)
        acc = self._run_sched("degree", evals, 1, n + 2)[..., 0, :]
        val = acc[..., 0]
        if acc.shape[-1] > 1:
            val = val | acc[..., 1] << self.spec.limb_bits
        return val

    def redc_z0(self, evals, a=None) -> torch.Tensor:
        """⟨P·Z₀⁻¹ mod a ≀ S⟩ (fftree.rs:264-267). With ``a=None`` the
        modulus is the canonical a = X^(m/2), the tree's own ``xnn_s``
        table; an explicit (m, L) ``a`` table takes the general path, which
        inverts a's even entries on the device by a Fermat chain."""
        if a is not None:
            return self._redc(evals, a, S0)
        m = evals.shape[-2]
        return self._run_sched("redc", evals, m, 2 * m)

    def redc_z1(self, evals, a=None) -> torch.Tensor:
        """⟨P·Z₁⁻¹ mod a ≀ S⟩ (fftree.rs:272-275), as :meth:`redc_z0`."""
        if a is not None:
            return self._redc(evals, a, S1)
        m = evals.shape[-2]
        return self._run_sched("redc1", evals, m, 2 * m)

    def _redc(self, evals, a, moiety: int) -> torch.Tensor:
        """General-modulus REDC: [evals ‖ a] packed along the position
        axis (see ``emit.general_mod_schedule``)."""
        m = evals.shape[-2]
        return self._run_sched("gredc", evals, m, 2 * m + 3 * (m // 2),
                               moiety, extras=(a,))

    def modular_reduce(self, evals, a=None, c=None) -> torch.Tensor:
        """MOD: remainder of P by ``a`` given c = ⟨Z₀² mod a ≀ S⟩
        (fftree.rs:286-289). With neither, the canonical form: a = X^(m/2)
        with the precomputed c = z0z0_rem_xnn_s. Explicit (m, L) tables
        ``a`` and ``c`` take the general path."""
        m = evals.shape[-2]
        if a is None and c is None:
            return self._run_sched("mod", evals, m, 2 * m)
        if a is None or c is None:
            raise TypeError(
                "modular_reduce needs both a and c (or neither for the "
                "canonical X^(m/2) form)")
        return self._run_sched("gmod", evals, m, 3 * m + 3 * (m // 2),
                               extras=(a, c))

    def vanish(self, points) -> torch.Tensor:
        """⟨Z ≀ S⟩ for Z(x) = Π (x − aᵢ) over the size-2v subtree
        (fftree.rs:313-316); the pairwise merges are OP_MUL steps."""
        v = points.shape[-2]
        return self._run_sched("vanish", points, 2 * v, 4 * v, tree=2)


def _check_field(spec: FieldSpec, device: torch.device) -> None:
    """Refuse a field the port cannot compute in (a prime below 2^16 other
    than M31), naming the cause; on the card also one no kernel form
    takes (``ops.step.kernel_form``)."""
    fd.check_fold(spec)
    if device.type == "cuda":
        step.kernel_form(spec)


def build_fftree_native(field: str | FieldSpec, n: int,
                        device="cuda") -> FFTree | None:
    """A size-``n`` FFTree whose tables the native engine builds; None
    when n exceeds the field's curve two-adicity."""
    spec = get_spec(field)
    _check_field(spec, torch.device(device))
    tables = build_tables_native(spec, n)
    if tables is None:
        return None
    return FFTree(spec, n, tables_from_numpy(tables), device)


# the JAX package's ``build_fftree``: the port has no device bootstrap, so
# the native engine builds the tables
build_fftree = build_fftree_native
