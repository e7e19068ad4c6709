"""The FFTree: precomputed tables plus the eight transforms.

The port's counterpart of ``ecfft_tpu/fftree.py``: ENTER (coefficients →
evaluations), EXIT (evaluations → coefficients), EXTEND, MEXTEND, DEGREE,
REDC, MOD and VANISH on the schedule machine, over any odd prime below
2^256 the JAX package runs, on the card and on the CPU alike: M31, primes
of 1 to 16 limbs of 16 bits with a pseudo-Mersenne fold (secp256k1,
2^255 − 19, M61 = 2^61 − 1, 2^256 − 1053, 64513), and every other such
prime of 2 limbs or more in Montgomery form with CIOS reduction (the
STARK prime, a fresh prime from
``fields.registry.field_from_curve_search``); see
``ops.step.kernel_form``. Only a prime below 2^16 without a fold is
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

Persistence: a tree carries its domain's layers and rational maps
(``f_layers``, ``maps``) for ``serialize.serialize_fftree``;
:meth:`FFTree.prepare` with a ``cache_dir`` keeps the pool and the
ENTER/EXIT schedules in the JAX package's files (the same names and keys,
the canonical pool as uint32), so a cache either package wrote loads into
the other; :meth:`FFTree.place_on` moves a tree between devices.
"""

from __future__ import annotations

import hashlib
import json
import os

import numpy as np
import torch

from ecfft_tpu_torch.convert import tables_from_numpy
from ecfft_tpu_torch.errors import SizeError
from ecfft_tpu_torch.fields import device as fd
from ecfft_tpu_torch.fields.registry import FieldSpec, get_spec
from ecfft_tpu_torch.native import build_tree_native
from ecfft_tpu_torch.ops import emit, step
from ecfft_tpu_torch.ops.schedule import (build_pool, pool_to_mont,
                                          run_schedule, schedule_entry,
                                          with_analysis)
from ecfft_tpu_torch.ops.emit import S0, S1

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

# the JAX package's cache format (``ecfft_tpu/fftree.py``'s _POOL_FORMAT):
# bumped there on any pool or schedule layout change, so a stale file
# never loads
_POOL_FORMAT = 6


class FFTree:
    """ECFFT evaluation-domain tables for one field and size ``n``, serving
    every power-of-two size ≤ n, with the eight batch-first algorithms."""

    def __init__(self, spec: str | FieldSpec, n: int, tables: dict,
                 device="cuda", f_layers: list | None = None,
                 maps: list | None = None):
        self.spec = get_spec(spec)
        self.device = torch.device(device)
        _check_field(self.spec, self.device)
        self.n = n
        self.tables = tables
        # host-int domain layers + rational maps, kept for serialization
        self.f_layers = f_layers
        self.maps = maps
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

    def _ensure_pool(self, pool=None, offsets=None) -> None:
        """Build the coefficient pool (on the CPU, then moved to the
        device) once, or take a canonical ``pool`` and its ``offsets``
        (read from a cache file); with Montgomery residents it is
        converted there, one row product by R² mod p per row (a kernel
        launch on the card), as the JAX package converts it once per call
        chain (``_pool_to_mont``)."""
        if self._pool is None:
            if pool is None:
                pool, offsets = build_pool(self.spec, self.tables)
            self._pool_off = offsets
            self._pool = pool_to_mont(self.spec, pool.to(self.device))

    def _cache_digest(self) -> str:
        """Short content digest of the tree identity for cache filenames:
        the prime and the full leaf domain (which determines every table),
        hashed as the JAX package hashes them, so both packages name a
        tree's files alike."""
        h = hashlib.sha256()
        h.update(self.spec.p.to_bytes((self.spec.p.bit_length() + 7) // 8,
                                      "little"))
        h.update(self.tables[self.n]["leaves"].numpy().astype(np.uint32)
                 .tobytes())
        return h.hexdigest()[:12]

    def prepare(self, sizes: tuple | None = None,
                cache_dir: str | None = None) -> "FFTree":
        """Build the coefficient pool and the ENTER/EXIT schedules for
        ``sizes`` (default, or empty: n; the other algorithms' schedules
        are made at first use), with the unrolled executor's analysis
        where it is selected, ahead of the first transform.

        ``cache_dir``: keep the pool in
        ``<dir>/.pool_<field>_<n>_<fmt>_<digest>.npz`` (the canonical
        pool as uint32 and its offsets as JSON) and each schedule in
        ``<dir>/.sched_<field>_<alg>_<m>_<fmt>_<digest>.npz``, the JAX
        package's names and keys: a file that exists is read instead of
        built (the pool only while the tree has none yet), one that does
        not is written."""
        tag = f"{_POOL_FORMAT}_{self._cache_digest()}"
        if cache_dir is not None and self._pool is None:
            path = os.path.join(
                cache_dir, f".pool_{self.spec.name}_{self.n}_{tag}.npz")
            if os.path.exists(path):
                with np.load(path, allow_pickle=False) as z:
                    pool = torch.from_numpy(z["pool"].astype(np.int32))
                    offsets = json.loads(str(z["offsets"]))
            else:
                pool, offsets = build_pool(self.spec, self.tables)
                np.savez(path, pool=pool.numpy().astype(np.uint32),
                         offsets=json.dumps(offsets))
            self._ensure_pool(pool, offsets)
        self._ensure_pool()
        for m in sizes or (self.n,):
            for alg in ("enter", "exit"):
                key = (alg, m)
                spath = None if cache_dir is None else os.path.join(
                    cache_dir, f".sched_{self.spec.name}_{alg}_{m}_{tag}.npz")
                if key not in self._scheds and spath is not None:
                    if os.path.exists(spath):
                        with np.load(spath, allow_pickle=False) as z:
                            s = emit.Schedule(
                                int(z["W"]), int(z["A"]), int(z["bs_max"]),
                                tuple(z[f"xs{i}"] for i in range(6)),
                                z["out_perm"] if "out_perm" in z.files
                                else None)
                        self._scheds[key] = schedule_entry(s, self.device)
                    else:
                        s = self._schedule(alg, m)[0]
                        arrs = {f"xs{i}": a for i, a in enumerate(s.xs)}
                        if s.out_perm is not None:
                            arrs["out_perm"] = s.out_perm
                        np.savez(spath, W=s.W, A=s.A, bs_max=s.bs_max,
                                 **arrs)
                self._schedule(alg, m)
        return self

    def place_on(self, device) -> "FFTree":
        """Move the tree to ``device``: the pool and the schedules'
        residual banks (the tables, which feed only the pool, and the
        unrolled analysis, host numpy, stay on the CPU); later batches
        go on that device."""
        device = torch.device(device)
        _check_field(self.spec, device)
        self.device = device
        if self._pool is not None:
            self._pool = self._pool.to(device)
        for entry in self._scheds.values():
            entry[1] = entry[1].to(device)
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
            self._scheds[key] = schedule_entry(s, self.device)
        return with_analysis(self._scheds[key])

    def _check_limbs(self, t, what: str, lead: str = "..., ") -> None:
        if (t.dtype != torch.int32 or not fd.on_device(t, self.device)
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
    """Refuse a field the port cannot compute in (a prime below 2^16
    without a fold), naming the cause; on the card also one no kernel form
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
    built = build_tree_native(spec, n)
    if built is None:
        return None
    tables, f_layers, maps = built
    return FFTree(spec, n, tables_from_numpy(tables), device, f_layers, maps)


# the JAX package's ``build_fftree``: the port has no device bootstrap, so
# the native engine builds the tables
build_fftree = build_fftree_native
