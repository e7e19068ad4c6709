"""Classical radix-2 NTT over 2-adic primes, on the schedule machine.

The port's counterpart of ``ecfft_tpu/ntt.py``: the reference's
comparison benchmark (benches/comparison.rs:16-55) pits ECFFT on
secp256k1's Fp against arkworks' radix-2 FFT on the 2-adic STARK prime
0x0800…0001, and this module is the port's side of it. Every butterfly
stage of the decimation-in-time NTT

    bit clear:  out[p] = x[p] + w·x[p ⊕ 2^b]
    bit set:    out[p] = x[p ⊕ 2^b] − w·x[p]

is one unhinted affine schedule step (OP_AFFINE: its gather and twiddle
columns go to the residual bank), so the executors that run ECFFT run it
too: the scan executor as one ``aff2g_ip`` launch per stage, the unrolled
one (``ECFFT_EXECUTOR=unrolled``) as one ``muladd2`` launch per stage (its
fusion analysis takes no OP_AFFINE step). The input bit reversal is
folded into the first stage's gather rows; the inverse appends one 1/n
scaling step. The schedules come from the port's ``emit._Builder`` and
equal the JAX plan's arrays (tested).

Over a prime without a fold (the STARK prime: the "cios16" form) the
state keeps Montgomery residents from the pack to the unpack
(``ops/schedule.py::run_chunks``), and the plan converts its twiddle pool
once, when it is built, as ``FFTree`` converts its pool; the JAX package
converts it once per call. A prime below 2^16 with a fold (97, 64513)
runs on the "fold1" form. Plans live on the card unless the caller passes
``device="cpu"``; there each transform's step loop is captured as a CUDA
graph at its first call and replayed after (``ops/graphs.py``), the plan
keeping the graphs.
"""

from __future__ import annotations

import numpy as np
import torch

from ecfft_tpu_torch.fields import device as fd
from ecfft_tpu_torch.fields.registry import FieldSpec, spec_for_prime
from ecfft_tpu_torch.ops import emit, step
from ecfft_tpu_torch.ops.graphs import GraphCache
from ecfft_tpu_torch.ops.schedule import (run_schedule, schedule_entry,
                                          with_analysis)

# the reference comparison's 2-adic prime (benches/comparison.rs:19-23)
STARK_P = int(
    "0800000000000011000000000000000000000000000000000000000000000001", 16
)
STARK_GENERATOR = 3


def _bitrev(i: int, bits: int) -> int:
    out = 0
    for _ in range(bits):
        out = (out << 1) | (i & 1)
        i >>= 1
    return out


class NTTPlan:
    """Twiddle pool + forward/inverse schedules for size n, on a device."""

    def __init__(self, n: int, p: int = STARK_P,
                 generator: int = STARK_GENERATOR,
                 spec: FieldSpec | None = None, device="cuda"):
        assert n & (n - 1) == 0
        two_adicity = (p - 1 & -(p - 1)).bit_length() - 1
        logn = n.bit_length() - 1
        assert logn <= two_adicity, "prime's 2-adicity too small for n"
        self.n = n
        self.spec = spec or spec_for_prime(p, f"ntt_{p % 99991}")
        self.p = p
        self.device = torch.device(device)
        fd.check_fold(self.spec)
        if self.device.type == "cuda":
            step.kernel_form(self.spec)
        w = pow(generator, (p - 1) >> logn, p)  # primitive n-th root
        w_inv = pow(w, -1, p)
        n_inv = pow(n, -1, p)
        # pool: [0]=0, [1]=1, powers of w (n/2), powers of w_inv (n/2), 1/n,
        # and negations of both power tables (the bit-set butterfly arm)
        pows, ipows = [], []
        acc = iacc = 1
        for _ in range(n // 2):
            pows.append(acc)
            ipows.append(iacc)
            acc = acc * w % p
            iacc = iacc * w_inv % p
        rows = ([0, 1] + pows + ipows + [n_inv]
                + [(-v) % p for v in pows] + [(-v) % p for v in ipows])
        self.pool = step.to_resident(
            self.spec, fd.encode(self.spec, rows, self.device))
        self._off_w = 2
        self._off_iw = 2 + n // 2
        self._off_ninv = 2 + n
        self._off_nw = 3 + n
        self._off_niw = 3 + n + n // 2
        # [schedule, residual bank on the device, unrolled analysis or None]
        self._scheds = {inv: schedule_entry(self._build(inv), self.device)
                        for inv in (False, True)}
        # the step loops' CUDA graphs of both schedules
        self._graphs = GraphCache()

    @property
    def _fwd(self) -> emit.Schedule:
        return self._scheds[False][0]

    @property
    def _inv(self) -> emit.Schedule:
        return self._scheds[True][0]

    def _build(self, inverse: bool) -> emit.Schedule:
        n = self.n
        logn = n.bit_length() - 1
        bld = emit._Builder(n)
        brev = np.array([_bitrev(i, logn) for i in range(n)], dtype=np.int64)
        off_w = self._off_iw if inverse else self._off_w
        off_nw = self._off_niw if inverse else self._off_nw
        pos = np.arange(n)
        for s in range(logn):  # stage: butterflies over bit s
            half = 1 << s
            bit = (pos & half) != 0
            partner = pos ^ half
            # twiddle index: w^( (p mod 2^(s+1) without the bit) * n/2^(s+1) )
            tw = (pos & (half - 1)) * (n >> (s + 1))
            ar, g1, br, g2 = bld.new_step()
            src = (lambda q: brev[q]) if s == 0 else (lambda q: q)
            # bit clear: out = u + w·v ; bit set: out = u − w·v
            # (u lives at the clear position, v at the set position)
            ar[pos] = emit.ONE
            g1[pos] = np.where(bit, src(partner), src(pos))
            br[pos] = np.where(bit, off_nw + tw, off_w + tw)
            g2[pos] = np.where(bit, src(pos), src(partner))
        if inverse:
            ar, g1, br, g2 = bld.new_step()
            ar[pos] = self._off_ninv
        return bld.arrays()

    def schedule(self, inverse: bool = False):
        """(schedule, residual bank, unrolled analysis or None) of the
        forward or inverse transform; the analysis is made at first use
        where ``ECFFT_EXECUTOR=unrolled`` selects that executor."""
        return tuple(with_analysis(self._scheds[inverse]))

    def _run(self, batch, inverse: bool):
        L = self.spec.num_limbs
        if (batch.dtype != torch.int32
                or not fd.on_device(batch, self.device)
                or tuple(batch.shape[-2:]) != (self.n, L)):
            raise ValueError(
                f"expected (..., {self.n}, {L}) int32 limbs on "
                f"{self.device}, got {tuple(batch.shape)} {batch.dtype} on "
                f"{batch.device}")
        sched, bank, meta = self.schedule(inverse)
        lead = batch.shape[:-2]
        flat = batch.reshape((-1,) + batch.shape[-2:])
        out = run_schedule(self.spec, self.pool, sched, bank, flat,
                           self.n - 1, self.n, meta, self._graphs)
        return out.reshape(lead + out.shape[-2:])

    def ntt(self, coeffs):
        """coeffs → evaluations at powers of the n-th root (natural order)."""
        return self._run(coeffs, False)

    def intt(self, evals):
        """evaluations → coefficients."""
        return self._run(evals, True)

    def encode(self, values):
        """Python ints → (..., L) int32 limbs on the plan's device."""
        return fd.encode(self.spec, values, self.device)

    def decode(self, arr):
        return fd.decode(self.spec, arr)
