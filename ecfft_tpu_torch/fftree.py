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
refused. The methods carry the JAX package's names and arguments, the
``*_unscheduled`` cross-validation forms among them: the same eight
algorithms as direct level scans with no schedule (``ops/core.py``), on
the same kernels.

Two builders fill the tables. :func:`build_fftree_native` (alias
``build_fftree``) has the native engine compute them on the host;
:meth:`FFTree.build` is the JAX package's device bootstrap: the tables
computed bottom-up on the tree's device (the card unless the caller names
the CPU), every product a kernel launch, in the reference's dependency
order, the Fermat inversions of the tables that depend on the domain alone
batched into one chain each. Both give the same bits (held in the tests
and on the card); ``build_fftree`` stays the native builder because every
CPU test builds its trees with it, and the bootstrap's plain int64 Fermat
chains there would cost seconds a tree.

The tables (``{m: {name: (rows, L) int32, "mats": [...]}}``, the JAX
package's layout) stay on the CPU, whichever builder made them: they feed
the coefficient pool, which is built there once (:meth:`FFTree.prepare`)
and then moved to the tree's device with the schedules' residual banks,
and the unscheduled forms, which keep their tables in a cache on the
device (the EXTEND coefficients of each size, :func:`_tile_extend`).
Batches are (..., n, L) int32 tensors on that device (L limbs of 16 bits,
or M31's one 32-bit limb) of canonical values: the card (``"cuda"``)
unless the caller names another. Constructing a tree from tables touches
no device. With Montgomery residents the pool is converted once, when it
is built, and each call's state on the way in and out
(``ops/schedule.py::run_chunks``). On a card each schedule's step loop
is captured as a CUDA graph at its first call and replayed at every
later one (``ops/graphs.py``); the tree keeps the graphs, and the scan
executor's step plans (``ops.schedule.StepPlan``: each schedule's index
rows and D-engine rows, made at its first call), beside its schedules,
and they go with it.

``ECFFT_EXECUTOR=unrolled`` runs the transforms on the unrolled executor
(``ops/unrolled.py``); its per-schedule fusion analysis is cached beside
the schedule, made in :meth:`FFTree.prepare` when that executor is
selected.

Persistence: a tree carries its domain's layers and rational maps
(``f_layers``, ``maps``) for ``serialize.serialize_fftree``;
:meth:`FFTree.prepare` with a ``cache_dir`` keeps the pool and the
ENTER/EXIT schedules in the JAX package's files (the same names and keys,
the canonical pool as uint32), so a cache either package wrote loads into
the other, and a field with Montgomery residents its pool in that form
too, in a file of the port's own; :meth:`FFTree.place_on` moves a tree
between devices.
"""

from __future__ import annotations

import hashlib
import json
import os

import numpy as np
import torch

from ecfft_tpu_torch.convert import tables_from_numpy
from ecfft_tpu_torch.errors import SizeError, TreeConstructionError
from ecfft_tpu_torch.fields import device as fd
from ecfft_tpu_torch.fields.registry import FieldSpec, build_domain, get_spec
from ecfft_tpu_torch.native import build_tree_native
from ecfft_tpu_torch.ops import core, emit, step
from ecfft_tpu_torch.ops.graphs import GraphCache
from ecfft_tpu_torch.ops.schedule import (build_pool, run_schedule,
                                          schedule_entry, with_analysis)
from ecfft_tpu_torch.ops.emit import S0, S1
from ecfft_tpu_torch.utils import profiling

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


def _ilog2(n: int) -> int:
    return n.bit_length() - 1


def _tile_extend(spec: FieldSpec, mats, tree_size: int) -> dict:
    """Pre-scatter the Lemma-3.2 matrices into per-position butterfly
    coefficient tables for the compile-flat EXTEND (see ops.core.extend).

    For flat position p at depth d (butterfly bit b, half = 2^b):
      bit clear: out[p] = M[i',0,0]·x[p] + M[i',0,1]·x[p^half]  (row 0)
      bit set:   out[p] = M[i',1,1]·x[p] + M[i',1,0]·x[p^half]  (row 1)
    with i' = p & (half−1) the shared matrix index. Returns
    {"shifts": (logm,), S0: (dec, rec), S1: (dec, rec)} with coeff arrays
    (logm, m, 2, L). Pure numpy — the tables are constants and eager
    device ops here would pay per-op dispatch on remote backends.
    """
    m = tree_size // 2
    L = spec.num_limbs
    logm = _ilog2(m)
    out = {"shifts": np.asarray([m >> (d + 1) for d in range(logm)],
                                dtype=np.int32)}
    mats_np = [tuple(np.asarray(x) for x in quad) for quad in mats]
    for moiety in (S0, S1):
        mkey = "s0" if moiety == S0 else "s1"
        if logm == 0:
            z = np.zeros((0, 1, 2, L), dtype=np.uint32)
            out[mkey] = (z, z)
            continue
        dec_list, rec_list = [], []
        for d in range(logm):
            half = m >> (d + 1)
            iota = np.arange(m)
            bitv = ((iota & half) != 0)[:, None]
            ipr = iota & (half - 1)
            dec = mats_np[d][0 if moiety == S0 else 1]
            rec = mats_np[d][2 if moiety == S0 else 3]
            for src, acc in ((dec, dec_list), (rec, rec_list)):
                sel = np.take(src, ipr, axis=0)  # (m, 2, 2, L)
                c_self = np.where(bitv, sel[:, 1, 1, :], sel[:, 0, 0, :])
                c_part = np.where(bitv, sel[:, 1, 0, :], sel[:, 0, 1, :])
                acc.append(np.stack([c_self, c_part], axis=1))
        out[mkey] = (np.stack(dec_list), np.stack(rec_list))
    return out


def _ext_on(spec: FieldSpec, mats, tree_size: int, device) -> dict:
    """:func:`_tile_extend`'s tables for ``ops.core``: int32 tensors on
    ``device``, the coefficients in the residents' form."""
    def put(a):
        t = torch.from_numpy(np.asarray(a).astype(np.int32)).to(device)
        if not t.numel():
            return t
        return step.to_resident(spec, t.reshape(-1, spec.num_limbs)
                                ).reshape(t.shape)

    ext = _tile_extend(spec, [tuple(q.cpu() for q in quad) for quad in mats],
                       tree_size)
    return {"shifts": ext["shifts"],
            **{k: tuple(put(a) for a in ext[k]) for k in ("s0", "s1")}}


def _require(device: torch.device) -> None:
    """Raise where ``device`` is a card and this machine has none: an entry
    point that computes on the card never carries on on the CPU."""
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"no CUDA device for {device}: pass "
                           "device=\"cpu\" to compute on the CPU")


# ----------------------------------------------------- device bootstrap


def _horner(spec: FieldSpec, coeffs: list, x):
    """Evaluate a (short, host-known) polynomial at device points."""
    acc = fd.encode(spec, coeffs[-1], x.device).expand_as(x)
    for c in reversed(coeffs[:-1]):
        acc = fd.add(spec, step.mul(spec, acc, x),
                     fd.encode(spec, c, x.device))
    return acc


def _build_mats(spec: FieldSpec, den_coeffs: tuple, layer_pts):
    """Recombine matrices for one layer of one tree size, and their
    determinants, whose inverses :func:`_dec_mats` takes: the bootstrap
    inverts every size's determinants in one Fermat chain, since they
    depend on the domain alone.

    Lemma 3.2 of ECFFT-I (fftree.rs:345-362): with v the denominator of
    the layer's rational map and (s0, s1) a matched point pair,
    v0 = v(s0)^(d/2−1), R = [[v0, s0·v0], [v1, s1·v1]], D = R⁻¹.
    Returns ((d, 2, 2, L) recombine, (d, L) determinants).
    """
    d = layer_pts.shape[0] // 2
    v = step.pow_int(spec, _horner(spec, list(den_coeffs), layer_pts),
                     d // 2 - 1)
    sv = step.mul(spec, layer_pts, v)
    r00, r01, r10, r11 = v[:d], sv[:d], v[d:], sv[d:]
    rec = torch.stack([torch.stack([r00, r01], dim=-2),
                       torch.stack([r10, r11], dim=-2)], dim=-3)
    det = fd.sub(spec, step.mul(spec, r00, r11), step.mul(spec, r01, r10))
    return rec, det


def _dec_mats(spec: FieldSpec, rec, det_inv):
    """D = R⁻¹ = [[r11, −r01], [−r10, r00]]·det⁻¹ of (d, 2, 2, L)
    recombine matrices."""
    adj = torch.stack([rec[:, 1, 1], fd.neg(spec, rec[:, 0, 1]),
                       fd.neg(spec, rec[:, 1, 0]), rec[:, 0, 0]], dim=1)
    return step.mul(spec, adj, det_inv[:, None]).reshape(rec.shape)


def _xnn_step(spec: FieldSpec, leaves: dict, sizes):
    """⟨X^(m/2) ≀ S⟩ and ⟨X^(m/4) ≀ S⟩ of every size m (the second from
    m = 4), with their inverses: the tables depend on the leaves alone,
    so one Fermat chain inverts them all. Returns {m: (xnn_s, xnn_s_inv,
    xnnnn_s, xnnnn_s_inv)}, size 2's without the last two."""
    pows = [(m, step.pow_int(spec, leaves[m], e))
            for m in sizes for e in (m // 2, m // 4) if e]
    if not pows:
        return {}
    invs = step.inv(spec, torch.cat([x for _, x in pows])).split(
        [x.shape[0] for _, x in pows])
    out: dict = {}
    for (m, x), xi in zip(pows, invs):
        out[m] = out.get(m, ()) + (x, xi)
    return out


def _z_step(spec: FieldSpec, ext, s, xnn, st, vt_prev, leaves2):
    """One size's z-table bootstrap on the device (fftree.rs:384-460), in
    the reference's dependency order: z0_s1 (the half-size tables and
    EXTEND), z1_s0 (VANISH, which needs z0_s1), both inverted in one
    Fermat chain, then z0z0/z1z1 (MOD and EXTEND). ``xnn`` = the size's
    tables of :func:`_xnn_step`, ``st`` = the half-size tables,
    ``vt_prev`` = {size: {ext, z0_s1}} for all smaller sizes (what VANISH
    consumes).
    """
    m = s.shape[0]
    zeros_half = torch.zeros_like(st["z0_s1"])
    st_z0_s0 = core._interleave(zeros_half, st["z0_s1"])
    st_z1_s0 = core._interleave(st["z1_s0"], zeros_half)
    st_z0_s1 = core.extend(spec, ext, st_z0_s0, S1)
    st_z1_s1 = core.extend(spec, ext, st_z1_s0, S1)
    z0_s1 = step.mul(spec, st_z0_s1, st_z1_s1)

    vt = dict(vt_prev)
    vt[m] = {"ext": ext, "z0_s1": z0_s1}
    z1_s = core.vanish(spec, vt, leaves2, s[1::2])
    z1_s0 = z1_s[0::2].contiguous()

    z0_inv_s1, z1_inv_s0 = step.inv(spec, torch.cat([z0_s1, z1_s0])).split(
        m // 2)

    xnn_s, xnn_s_inv, xnnnn_s, xnnnn_s_inv = xnn
    sq_s0 = step.mul(spec, st["z0z0_rem_xnn_s"], st["z1z1_rem_xnn_s"])
    rem_s0 = core.modular_reduce(
        spec,
        st["ext"],
        st["z0_inv_s1"],
        sq_s0,
        st["xnn_s"][1::2],
        st["xnn_s_inv"][0::2],
        st["z0z0_rem_xnn_s"],
    )
    rem_s1 = core.extend(spec, ext, rem_s0, S1)
    z0z0_rem_xnnnn_s = core._interleave(rem_s0, rem_s1)
    z0_s = core._interleave(torch.zeros_like(z0_s1), z0_s1)
    z0_rem_xnn_sq_s = step.square(spec, fd.sub(spec, z0_s, xnn_s))
    hi = step.mul(
        spec, fd.sub(spec, z0_rem_xnn_sq_s, z0z0_rem_xnnnn_s), xnnnn_s_inv
    )
    hi_rem = core.modular_reduce(
        spec,
        ext,
        z0_inv_s1,
        hi,
        xnnnn_s[1::2],
        xnnnn_s_inv[0::2],
        z0z0_rem_xnnnn_s,
    )
    z0z0_rem_xnn_s = fd.add(
        spec, z0z0_rem_xnnnn_s, step.mul(spec, xnnnn_s, hi_rem)
    )
    z1_s = core._interleave(z1_s0, torch.zeros_like(z1_s0))
    z1z1 = step.square(spec, fd.sub(spec, z1_s, xnn_s))
    z1z1_rem_xnn_s = core.modular_reduce(
        spec,
        ext,
        z0_inv_s1,
        z1z1,
        xnn_s[1::2],
        xnn_s_inv[0::2],
        z0z0_rem_xnn_s,
    )
    return {
        "xnn_s": xnn_s,
        "xnn_s_inv": xnn_s_inv,
        "z0_s1": z0_s1,
        "z1_s0": z1_s0,
        "z0_inv_s1": z0_inv_s1,
        "z1_inv_s0": z1_inv_s0,
        "z0z0_rem_xnn_s": z0z0_rem_xnn_s,
        "z1z1_rem_xnn_s": z1z1_rem_xnn_s,
    }


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
        # the step loops' CUDA graphs of the schedules above, by key
        self._graphs = GraphCache()
        # the unscheduled algorithms' tables on the device: ("ext", m) →
        # the size's EXTEND coefficients, (name, m) → a table
        self._dev_cache: dict = {}

    # ---------------------------------------------------------- bootstrap

    @classmethod
    def build(cls, field: str | FieldSpec, n: int,
              device="cuda") -> "FFTree | None":
        """F::build_fftree(n) (lib.rs:14-16, 40-84, 199-214) by the device
        bootstrap, on ``device`` (the card unless the caller names the
        CPU): None when n exceeds the field's curve two-adicity."""
        spec = get_spec(field)
        device = torch.device(device)
        _require(device)
        _check_field(spec, device)
        dom = build_domain(spec, n)
        if dom is None:
            return None
        leaves, maps = dom
        # host: fill internal domain layers (fftree.rs:56-67), exact ints,
        # checking the 2-to-1 property map(s_i) == map(s_{i+half}) per node
        # (the reference's debug_assert, fftree.rs:63-66)
        f_layers = [leaves]
        for li, rmap in enumerate(maps):
            prev = f_layers[-1]
            half = len(prev) // 2
            nxt = [rmap(x) for x in prev[:half]]
            mirror = [rmap(x) for x in prev[half:]]
            if nxt != mirror:
                raise TreeConstructionError(
                    f"rational map {li} is not 2-to-1 on its layer "
                    "(fftree.rs:65)"
                )
            f_layers.append(nxt)
        return cls.from_domain_layers(spec, f_layers, maps, device)

    @classmethod
    def from_domain_layers(cls, spec, f_layers, maps,
                           device="cuda") -> "FFTree":
        """Device bootstrap in the reference's exact dependency order
        (fftree.rs:318-463), iterating sizes bottom-up instead of
        recursing top-down, every product on the kernels of ``device``
        (``ops.step``); the tables then go to the CPU, where every tree
        keeps them, and the sizes' EXTEND tables stay in the tree's
        device cache for the ``*_unscheduled`` forms."""
        spec = get_spec(spec)
        device = torch.device(device)
        _require(device)
        _check_field(spec, device)
        n = len(f_layers[0])
        enc_layers = [fd.encode(spec, layer, device) for layer in f_layers]
        sizes = [1 << i for i in range(1, _ilog2(n) + 1)]
        leaves = {m: enc_layers[0][::n // m].contiguous() for m in sizes}
        # extend matrices (layers with d ≥ 2 only — the 2-wide layer is
        # identity and never consulted) and the xnn tables: both depend on
        # the domain alone, so each kind takes one Fermat chain for all
        # sizes
        pairs = [(m, li) for m in sizes for li in range(_ilog2(m) - 1)]
        mats: dict[int, list] = {m: [] for m in sizes}
        if pairs:
            recs, dets = zip(*[
                _build_mats(spec, tuple(maps[li].denominator),
                            enc_layers[li][::n // m].contiguous())
                for m, li in pairs])
            dis = step.inv(spec, torch.cat(dets)).split(
                [d.shape[0] for d in dets])
            for (m, _), rec, di in zip(pairs, recs, dis):
                dec = _dec_mats(spec, rec, di)
                # moiety selection: dec skip 1/0, rec skip 0/1 for S0/S1
                # (fftree.rs:87-91,108-112)
                mats[m].append((dec[1::2], dec[0::2], rec[0::2], rec[1::2]))
        xnn = _xnn_step(spec, leaves, sizes)
        tables: dict[int, dict] = {}
        exts: dict[int, dict] = {}
        for m in sizes:
            s = leaves[m]
            t: dict = {"leaves": s, "mats": mats[m]}
            exts[m] = _ext_on(spec, mats[m], m, device)

            if m == 2:
                # base cases (fftree.rs:399-403,454-458)
                t["xnn_s"], t["xnn_s_inv"] = xnn[2][:2]
                t["z0_s1"] = fd.sub(spec, s[1:2], s[0:1])
                t["z1_s0"] = fd.sub(spec, s[0:1], s[1:2])
                t["z0_inv_s1"], t["z1_inv_s0"] = step.inv(
                    spec, torch.cat([t["z0_s1"], t["z1_s0"]])).split(1)
                sq = step.square(spec, s)
                t["z0z0_rem_xnn_s"] = sq[0:1].expand_as(sq)
                t["z1z1_rem_xnn_s"] = sq[1:2].expand_as(sq)
            else:
                vt_prev = {
                    k: {"ext": exts[k], "z0_s1": tables[k]["z0_s1"]}
                    for k in tables
                }
                st = {"ext": exts[m // 2]}
                st.update(
                    (kk, tables[m // 2][kk])
                    for kk in ("z0_s1", "z1_s0", "z0_inv_s1", "xnn_s",
                               "xnn_s_inv", "z0z0_rem_xnn_s",
                               "z1z1_rem_xnn_s")
                )
                t.update(
                    _z_step(spec, exts[m], s, xnn[m], st, vt_prev,
                            tables[2]["leaves"])
                )

            tables[m] = t

        def host(v):
            return v.to("cpu").contiguous()

        tree = cls(spec, n, {
            m: {k: ([tuple(host(a) for a in quad) for quad in v]
                    if k == "mats" else host(v)) for k, v in t.items()}
            for m, t in tables.items()}, device, f_layers, list(maps))
        tree._dev_cache.update((("ext", m), e) for m, e in exts.items())
        return tree

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
            self._pool = step.to_resident(self.spec, pool.to(self.device))

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
        not is written. With Montgomery residents the pool converted to
        them is kept as well, in ``<dir>/.pool_<field>_<n>_<fmt>_<digest>_
        <form>.npz`` (``step.kernel_form``), and read in place of the
        canonical one, so a later tree does not convert it again."""
        tag = f"{_POOL_FORMAT}_{self._cache_digest()}"
        if cache_dir is not None and self._pool is None:
            path = os.path.join(
                cache_dir, f".pool_{self.spec.name}_{self.n}_{tag}.npz")
            rpath = (os.path.join(cache_dir, f".pool_{self.spec.name}_"
                                  f"{self.n}_{tag}_"
                                  f"{step.kernel_form(self.spec)}.npz")
                     if fd.is_mont(self.spec) else None)
            if rpath is not None and os.path.exists(rpath):
                with np.load(rpath, allow_pickle=False) as z:
                    self._pool = torch.from_numpy(
                        z["pool"].astype(np.int32)).to(self.device)
                    self._pool_off = json.loads(str(z["offsets"]))
            elif os.path.exists(path):
                with np.load(path, allow_pickle=False) as z:
                    pool = torch.from_numpy(z["pool"].astype(np.int32))
                    offsets = json.loads(str(z["offsets"]))
            else:
                pool, offsets = build_pool(self.spec, self.tables)
                np.savez(path, pool=pool.numpy().astype(np.uint32),
                         offsets=json.dumps(offsets))
            if self._pool is None:
                self._ensure_pool(pool, offsets)
                if rpath is not None:
                    np.savez(rpath,
                             pool=self._pool.cpu().numpy().astype(np.uint32),
                             offsets=json.dumps(offsets))
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
        unrolled analysis, host numpy, stay on the CPU; the unscheduled
        algorithms' device cache and the step loops' graphs and step
        plans are dropped, and made there at first use); later batches go
        on that device."""
        device = torch.device(device)
        _check_field(self.spec, device)
        self.device = device
        if self._pool is not None:
            self._pool = self._pool.to(device)
        for entry in self._scheds.values():
            entry[1] = entry[1].to(device)
        self._dev_cache = {}
        self._graphs = GraphCache()
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
        axis. The call is a span (``ecfft.call``) and an entry of the call
        record (``utils.profiling``)."""
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
        with profiling.call(alg, m, flat):
            out = run_schedule(self.spec, self._pool, sched, bank,
                               (flat, *extras) if extras else flat,
                               one_pos=one_pos, m_out=m_out, meta=meta,
                               cache=self._graphs)
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

    # ------------------------------------------------ unscheduled forms
    # The direct level scans of ``ops/core.py``: a second route to every
    # algorithm, with no schedule, on the kernels of the tree's device.

    def _ext(self, m: int) -> dict:
        """Pre-scattered flat-scan EXTEND coefficient tables for tree
        size ``m`` (:func:`_tile_extend` of the compact Lemma-3.2
        matrices), on the tree's device in the residents' form, made at
        first use and cached."""
        key = ("ext", m)
        if key not in self._dev_cache:
            self._dev_cache[key] = _ext_on(self.spec, self.tables[m]["mats"],
                                           m, self.device)
        return self._dev_cache[key]

    def _table(self, m: int, name: str) -> torch.Tensor:
        """Table ``name`` of size ``m`` on the tree's device, cached."""
        key = (name, m)
        if key not in self._dev_cache:
            self._dev_cache[key] = self.tables[m][name].to(self.device)
        return self._dev_cache[key]

    def _subtables(self, key: str, up_to: int) -> dict:
        return {
            k: {kk: (self._ext(k) if kk == "ext" else self._table(k, kk))
                for kk in key.split()}
            for k in self.tables
            if k <= up_to
        }

    def _unscheduled(self, x, size: int) -> None:
        """Refuse a batch the unscheduled forms cannot take: a size that
        is not a power of two or exceeds the tree, or limbs of another
        shape, type or device."""
        self._size_check(size)
        self._check_limbs(x, "the batch")

    def _modulus(self, a, m: int):
        self._check_limbs(a, "a modulus table", "")
        if tuple(a.shape) != (m, self.spec.num_limbs):
            raise ValueError(f"a modulus table must be ({m}, "
                             f"{self.spec.num_limbs}), got {tuple(a.shape)}")
        return a[0::2].contiguous(), a[1::2].contiguous()

    def extend_unscheduled(self, evals, moiety: int = S1) -> torch.Tensor:
        m = evals.shape[-2]
        self._unscheduled(evals, m * 2)
        return core.extend(self.spec, self._ext(m * 2), evals, moiety)

    def mextend_unscheduled(self, evals, moiety: int = S1) -> torch.Tensor:
        m = evals.shape[-2]
        self._unscheduled(evals, m * 2)
        z = self._table(m * 2, "z0_s1" if moiety == S1 else "z1_s0")
        return core.mextend(self.spec, self._ext(m * 2), z, evals, moiety)

    def enter_unscheduled(self, coeffs) -> torch.Tensor:
        n = coeffs.shape[-2]
        self._unscheduled(coeffs, n)
        ext = {k: self._ext(k) for k in self.tables if k <= n}
        xnn = {k: self._table(k, "xnn_s") for k in self.tables if k <= n}
        return core.enter(self.spec, ext, xnn, coeffs)

    def exit_unscheduled(self, evals) -> torch.Tensor:
        n = evals.shape[-2]
        self._unscheduled(evals, n)
        t = self._subtables(
            "ext xnn_s xnn_s_inv z0_inv_s1 z0z0_rem_xnn_s", n
        )
        return core.exit_(self.spec, t, evals)

    def degree_unscheduled(self, evals) -> torch.Tensor:
        n = evals.shape[-2]
        self._unscheduled(evals, n)
        t = self._subtables("ext z0_inv_s1", n)
        return core.degree(self.spec, t, evals)

    def _redc_unscheduled(self, evals, a, moiety: int) -> torch.Tensor:
        """REDC by a modulus table ``a``, its even entries inverted on the
        device by Fermat (the JAX package's ``_redc_jit``)."""
        m = evals.shape[-2]
        self._unscheduled(evals, m)
        a0, a1 = self._modulus(a, m)
        z_inv = self._table(m, "z0_inv_s1" if moiety == S0 else "z1_inv_s0")
        return core.redc(self.spec, self._ext(m), z_inv, evals, a1,
                         step.inv(self.spec, a0), moiety)

    def modular_reduce_unscheduled(self, evals, a, c) -> torch.Tensor:
        """MOD by ``a`` given c = ⟨Z₀² mod a ≀ S⟩, a's even entries
        inverted on the device (the JAX package's ``_mod_jit``)."""
        m = evals.shape[-2]
        self._unscheduled(evals, m)
        a0, a1 = self._modulus(a, m)
        self._modulus(c, m)
        return core.modular_reduce(self.spec, self._ext(m),
                                   self._table(m, "z0_inv_s1"), evals, a1,
                                   step.inv(self.spec, a0), c)

    def vanish_unscheduled(self, points) -> torch.Tensor:
        v = points.shape[-2]
        self._unscheduled(points, v * 2)
        t = self._subtables("ext z0_s1", v * 2)
        return core.vanish(self.spec, t, self._table(2, "leaves"), points)


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


# the JAX package's ``build_fftree`` is its device bootstrap; the port's
# builds through the native engine instead, whose tables are the same bits
# (the bootstrap is held to them), in a fraction of the time on the CPU,
# where every test builds its trees. ``FFTree.build`` is the bootstrap.
build_fftree = build_fftree_native
