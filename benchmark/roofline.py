"""The step kernels' least time, frozen: the yardstick of ``step_roofline``.

After ``chip_smoke.py::bound`` and ``word_products`` (the bytes and
word-product bounds, without the design's issue bound; the bytes counted
of the field's values, below), and a copy of the launch
geometry of ``csrc/step_kernels.cu`` (``blocks_for``) and
``csrc/m31_kernels.cu`` (``grid_for``), kept here so that a change to the
program cannot move the yardstick. The peaks are the published ones of
one H100 SXM at its full 700 W: 3.35 TB/s of HBM3 (the data sheet), and
64 IMAD.WIDE (32×32→64-bit word products) per SM and clock (the CUDA
C++ Programming Guide's throughput table, compute capability 9.0) on 132
SMs at 1980 MHz. The card's power limit is reported beside the number.

The bound of one call of a step over a window of A rows and B lanes is
the larger of

- its bytes over the memory rate: each input element read once and each
  output element written once (3 windows of A·B elements: x1 or the
  state's own window, x2, the output; the coefficient rows, A elements
  each, one or two of them; none for ``mulss``), each element at the
  bytes of a value below p, ceil(bits(p) / 8): 32 for secp256k1, 4 for
  M31. This is the field's least traffic, not that of the program's
  representation: a 16-limb element held in int32 words moves 64 bytes,
  twice the bound's 32, so a secp256k1 share reads half what the same
  time would read against ``chip_smoke.py``'s bound (which counts
  L·4 bytes), and a packed state can raise it;
- its word products over the multiply rate: NW² a field product for NW
  32-bit words an element, plus the reduction's (the fold's: F's nonzero
  words times the high part's words, then the words left after one
  round; Montgomery's: NW·(NW + 1)); one an M31 product, whose reduction
  is shifts and adds. The same work whatever kernel computes it.
"""

from __future__ import annotations

import re

HBM_BYTES_PER_S = 3.35e12
SMS, SM_CLOCK_HZ = 132, 1.98e9
WORD_PRODUCTS_PER_SM = 64
THREADS = 256  # a step kernel's block, both forms

# step_kernel<K> / m31_step_kernel<K>: the schedule's opcodes
KINDS = {0: "aff1s_ip", 1: "aff1g_ip", 2: "aff2g_ip", 3: "mulss"}
STEP_KERNEL = re.compile(
    r"(?<![A-Za-z0-9_])(m31_)?step_kernel<(?:\(int\))?(\d)>")
M31_P = (1 << 31) - 1


def form(p: int, limbs: int, limb_bits: int) -> str:
    """"m31" (one 32-bit word), "fold" (16-bit limbs whose 2^(16L) mod p
    has base-2^16 digits summing below 2^11) or "cios" (any other)."""
    if p == M31_P and limbs == 1 and limb_bits == 32:
        return "m31"
    rem, digits = (1 << (16 * limbs)) % p, 0
    while rem:
        digits += rem & 0xFFFF
        rem >>= 16
    return "fold" if digits < 1 << 11 else "cios"


def word_products(kind: str, p: int, limbs: int, limb_bits: int) -> int:
    """32×32→64-bit word products one element of a step needs."""
    two = kind == "aff2g_ip"
    fm = form(p, limbs, limb_bits)
    if fm == "m31":
        return 1 + two
    nw = (limbs + 1) // 2
    if fm == "cios":
        red = nw * (nw + 1)
    else:
        F = (1 << (16 * limbs)) % p
        nonzero = sum(1 for k in range(8) if (F >> (32 * k)) & 0xFFFFFFFF)
        red = nonzero * (nw + -(-(2 * F).bit_length() // 32))
    return nw * nw * (1 + two) + red


def value_bytes(p: int) -> int:
    """Bytes of a value below ``p``, the least an element can move."""
    return -(-p.bit_length() // 8)


def bound_s(kind: str, A: int, B: int, p: int, limbs: int,
            limb_bits: int) -> float:
    """The least seconds of one step call on an A × B window."""
    el = value_bytes(p)
    rows = 0 if kind == "mulss" else 1 + (kind == "aff2g_ip")
    nbytes = 3 * A * B * el + rows * A * el
    ops = word_products(kind, p, limbs, limb_bits) * A * B
    return max(nbytes / HBM_BYTES_PER_S,
               ops / (SMS * SM_CLOCK_HZ * WORD_PRODUCTS_PER_SM))


def grid(fm: str, A: int, B: int) -> tuple[int, int, int]:
    """The grid a step kernel of form ``fm`` launches on an A × B window:
    one thread an element in blocks of 256; an M31 block takes 2^lg
    lanes (the least power of two at or above B, at most 256) of
    256 >> lg rows."""
    if fm != "m31":
        return (-(-A * B // THREADS), 1, 1)
    lg = 0
    while (1 << lg) < B and (1 << lg) < THREADS:
        lg += 1
    per = THREADS >> lg
    return (-(-A // per), -(-B // (1 << lg)), 1)


def step_kind(name: str) -> str | None:
    """The step a device kernel's name is, or None."""
    m = STEP_KERNEL.search(name)
    return KINDS.get(int(m.group(2))) if m else None
