"""Instructions one thread of a kernel issues, per pipe, read from SASS.

``chip_smoke.py`` takes its operation bounds from these counts. The input
is the text ``cuobjdump -sass`` prints for a library. For each kernel the
counter walks the code one thread runs and counts, per instruction
executed:

- ``fma``: integer multiplies and multiply-adds (``IMAD*``, ``IMUL*``),
  which issue to the FMA pipe: 64 lanes per SM and clock on sm_90;
- ``alu``: integer adds, logic, shifts, compares and selects, which issue
  to the ALU pipe, another 64 lanes per SM and clock that run beside it;
- ``all``: every instruction, since each takes an issue slot (4 warps of
  32 lanes per SM and clock).

An instruction of a kind not listed (moves, conversions, loads, stores,
branches, barriers) counts only in ``all``. A walk is one thread's path
on the data the caller names, and where the SASS alone cannot tell which
way a branch goes the walker takes the shorter way, so the counts stay a
lower bound:

- a two-way branch (``@P BRA T`` with an unconditional ``BRA U`` just
  before T) runs one side: the side without a ``CALL`` (the 64-bit
  division's slow path, never taken for 32-bit operands), else the side
  ``kind`` picks in a cascade where the sides differ in FMA instructions
  (a 2-mul level runs the side with more), else the shorter side (the
  warp cascade's shuffle levels against its register-row levels, which
  do the same products);
- a loop whose body skips ``fold_blocks`` or more branch-free blocks is
  the reduction's fold loop (``reduce`` in word_arith.cuh: one block per
  word of the fold multiplier F, so ``fold_blocks`` is the form's word
  count, 8 at 16 limbs): it runs ``rounds`` times, and of its skipped
  blocks ``nz`` run each round, one per nonzero word of F. The CIOS form
  has no such loop: its rounds are unrolled;
- a loop with a barrier or a warp shuffle (``SHFL``) in it is a
  cascade's level loop (the barrier per level of cascade_kernel, the
  shuffles of warp_cascade.cuh's levels): it runs once per entry of
  ``kinds``, with that entry as ``kind``;
- any other loop runs once (the subtraction of p·2^j for a prime with
  no slack); a branch-free block that a branch can skip runs if it
  stores to shared or device memory (an element's own work behind the
  guard of its ragged edge: a pair level's loads and shared stores),
  and any other such block counts as skipped (a cascade's A rows for a
  next level of kind 1);
- a forward branch over code that holds branches (a guard around a loop
  or an element) falls through; an unconditional forward branch is
  followed; the walk ends at an unconditional ``EXIT`` or a backward
  unconditional branch.

Run it on a dump: ``python3 tools/sass_count.py dump.sass [rounds nz
[fold_blocks]]``.
"""

from __future__ import annotations

import collections
import re
import sys
from typing import NamedTuple

FMA_PIPE = ("IMAD", "IMUL")
ALU_PIPE = {"IADD3", "IADD", "LOP3", "LOP", "SHF", "SHL", "SHR", "LEA",
            "ISETP", "SEL", "IMNMX", "VIMNMX", "VIADD", "PRMT", "IABS",
            "BMSK", "SGXT"}
_LINE = re.compile(r"^\s+/\*([0-9a-f]{4,})\*/\s+(@!?U?P[T0-9]+\s+)?"
                   r"([A-Z][A-Z0-9_.]*)([^;]*);", re.M)
_TARGET = re.compile(r"0x([0-9a-f]+)")


class Inst(NamedTuple):
    addr: int
    pred: bool        # guarded by a predicate
    op: str           # the full opcode, e.g. IMAD.WIDE.U32
    target: int | None  # a branch's or call's target address

    @property
    def base(self) -> str:
        return self.op.split(".")[0]


def functions(sass: str) -> dict[str, list[Inst]]:
    """Each function of a ``cuobjdump -sass`` dump: name → instructions."""
    out = {}
    for func in re.split(r"\n\s*Function : ", sass)[1:]:
        name = func.split("\n", 1)[0].strip()
        insts = []
        for addr, pred, op, rest in _LINE.findall(func):
            target = None
            if op.startswith(("BRA", "CALL")):
                m = _TARGET.search(rest)
                target = int(m.group(1), 16) if m else None
            insts.append(Inst(int(addr, 16), bool(pred), op, target))
        out[name] = insts
    return out


def classify(inst: Inst) -> tuple[str, ...]:
    if inst.base in FMA_PIPE:
        return ("fma", "all")
    if inst.base in ALU_PIPE:
        return ("alu", "all")
    return ("all",)


class _Walk:
    def __init__(self, insts: list[Inst], rounds: int, nz: int,
                 fold_blocks: int = 8):
        self.insts = insts
        self.at = {ins.addr: i for i, ins in enumerate(insts)}
        self.rounds, self.nz, self.fold_blocks = rounds, nz, fold_blocks
        self.step = insts[1].addr - insts[0].addr if len(insts) > 1 else 16
        # loops: head address → the back edge's address (the outermost)
        self.loops = {}
        for ins in insts:
            if (ins.base == "BRA" and ins.pred and ins.target is not None
                    and ins.target < ins.addr):
                self.loops[ins.target] = max(ins.addr,
                                             self.loops.get(ins.target, 0))

    def span(self, lo: int, hi: int) -> list[Inst]:
        return [ins for ins in self.insts if lo <= ins.addr < hi]

    def skip_block(self, ins: Inst) -> bool:
        """A predicated forward branch over branch-free code that is not
        one side of a two-way branch."""
        if not (ins.base == "BRA" and ins.pred and ins.target is not None
                and ins.target > ins.addr):
            return False
        body = self.span(ins.addr + self.step, ins.target)
        return bool(body) and not any(
            b.base in ("BRA", "EXIT", "CALL", "BAR") for b in body)

    def stores(self, ins: Inst) -> bool:
        """The block that the forward branch ``ins`` skips holds a store."""
        return any(b.base in ("STS", "STG", "ST")
                   for b in self.span(ins.addr + self.step, ins.target))

    def diamond(self, ins: Inst):
        """(side 1, side 2, join) of a two-way branch at ``ins``, or None."""
        if not (ins.base == "BRA" and ins.pred and ins.target is not None
                and ins.target > ins.addr):
            return None
        last = self.insts[self.at[ins.target] - 1]
        if (last.base == "BRA" and not last.pred and last.target is not None
                and last.target > ins.target):
            return ((ins.addr + self.step, ins.target),
                    (ins.target, last.target), last.target)
        return None

    def count(self, lo: int, hi: int, kind: int, kinds, fold_n: int = 0):
        """Counts of the walk over [lo, hi); ``fold_n`` > 0 inside a fold
        loop with that many skippable blocks."""
        c = collections.Counter()
        i = self.at.get(lo)
        while i is not None and i < len(self.insts):
            ins = self.insts[i]
            if ins.addr >= hi:
                break
            back = self.loops.get(ins.addr)
            if back is not None and not (ins.addr == lo
                                         and back + self.step == hi):
                c += self.loop(ins.addr, back, kind, kinds)
                i = self.at[back] + 1
                continue
            for k in classify(ins):
                c[k] += 1
            if ins.base == "EXIT" and not ins.pred:
                break
            if ins.base == "BRA" and ins.target is not None:
                if not ins.pred:
                    if ins.target <= ins.addr:
                        break
                    i = self.at.get(ins.target)
                    continue
                d = self.diamond(ins)
                if d is not None:
                    c += self.side(d, kind, kinds)
                    i = self.at.get(d[2])
                    continue
                if self.skip_block(ins) and not self.stores(ins):
                    if fold_n:
                        body = self.count(ins.addr + self.step, ins.target,
                                          kind, kinds)
                        for k in body:
                            c[k] += body[k] * self.nz / fold_n
                    i = self.at.get(ins.target)
                    continue
            i += 1
        return c

    def side(self, d, kind, kinds):
        sides = [self.count(lo, hi, kind, kinds) for lo, hi in d[:2]]
        calls = [any(b.base == "CALL" for b in self.span(*s)) for s in d[:2]]
        if calls[0] != calls[1]:
            return sides[1] if calls[0] else sides[0]
        if kind is not None and sides[0]["fma"] != sides[1]["fma"]:
            by_fma = sorted(sides, key=lambda s: s["fma"])
            return by_fma[1] if kind else by_fma[0]
        return min(sides, key=lambda s: s["all"])

    def loop(self, head: int, back: int, kind, kinds):
        body = self.span(head, back + self.step)
        end = back + self.step
        if any(b.base in ("BAR", "SHFL") for b in body):
            c = collections.Counter()
            for k in kinds:
                c += self.count(head, end, k, kinds)
            return c
        n_skip = sum(self.skip_block(b) for b in body)
        if n_skip >= self.fold_blocks:
            one = self.count(head, end, kind, kinds, n_skip)
            return collections.Counter(
                {k: v * self.rounds for k, v in one.items()})
        return self.count(head, end, kind, kinds)


def thread_counts(insts: list[Inst], rounds: int, nz: int,
                  kinds=(), fold_blocks: int = 8) -> dict[str, float]:
    """{"fma", "alu", "all"}: the instructions one thread issues (see the
    module docstring). ``kinds``: a cascade's levels, 0 (1-mul) or 1
    (2-mul) each; ``fold_blocks``: the skipped blocks that mark a fold
    loop (the form's word count)."""
    w = _Walk(insts, rounds, nz, fold_blocks)
    c = w.count(insts[0].addr, insts[-1].addr + w.step, None, list(kinds))
    return {k: float(c[k]) for k in ("fma", "alu", "all")}


def loads_before_first_product(insts: list[Inst]) -> tuple[int, int]:
    """(device loads listed ahead of the first 32x32->64-bit product, all
    device loads): equal where a kernel issues every load before it starts
    to multiply, as long as its address arithmetic needs no such product."""
    ops = [ins.op for ins in insts]
    first = next((k for k, op in enumerate(ops)
                  if op.startswith("IMAD.WIDE.U32")), len(ops))
    return (sum(op.startswith("LDG") for op in ops[:first]),
            sum(op.startswith("LDG") for op in ops))


def main(argv) -> int:
    sass = open(argv[1]).read()
    rounds, nz = (int(argv[2]), int(argv[3])) if len(argv) > 3 else (2, 2)
    blocks = int(argv[4]) if len(argv) > 4 else 8
    for name, insts in functions(sass).items():
        if not insts:
            continue
        base = thread_counts(insts, rounds, nz, (), blocks)
        print(name)
        print(f"  no level: {base}")
        for k in (0, 1):
            one = thread_counts(insts, rounds, nz, [k], blocks)
            if one != base:
                print(f"  + a level of kind {k}: "
                      f"{ {x: one[x] - base[x] for x in one} }")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
