"""tools/sass_count.py on small hand-written SASS: the path one thread
takes through a two-way branch around a slow-path call, a fold loop with
skippable blocks, and a cascade's level loop with a two-way branch per
level kind. Counts are exact."""

import pytest

from tools import sass_count


def _sass(name, lines):
    """A ``cuobjdump -sass`` listing of one function, 16 bytes per
    instruction; ``@N`` in a line stands for the address of line N."""
    out = [f"\n\t\tFunction : {name}"]
    for i, line in enumerate(lines):
        for j in range(len(lines), -1, -1):
            line = line.replace(f"@{j}>", f"0x{16 * j:x}")
        out.append(f"        /*{16 * i:04x}*/                   {line} ;"
                   f"    /* 0x0000000000000000 */")
    return "\n".join(out) + "\n"


STEP = ["ISETP.GE.AND P0, PT, R0, c[0x0][0x0], PT",  # 0
        "@P0 EXIT",
        "ISETP.NE.U32.AND P0, PT, R1, RZ, PT",
        "@!P0 BRA @7>",                              # 3: two-way branch
        "MOV R0, 0x60",
        "CALL.REL.NOINC @41>",                       # 5: the slow side
        "BRA @9>",
        "IMAD.HI.U32 R2, R3, R4, RZ",                # 7: the fast side
        "IADD3 R2, -R2, RZ, RZ",
        "IMAD.WIDE.U32 R4, R5, R6, R4",              # 9
        "IMAD.WIDE.U32 R6, R5, R7, R6",
        "IMAD.WIDE.U32 R8, R5, R8, R8",
        "LOP3.LUT R9, R9, R10, RZ, 0xfc, !PT"]       # 12: the fold loop
for blk in range(8):  # 13 + 3·blk: its skippable blocks
    STEP += [f"@!P{blk % 7} BRA @{16 + 3 * blk}>",
             "IMAD R10, R11, R12, R10", "IMAD R13, R11, R14, R13"]
STEP += ["IADD3 R9, R9, 0x1, RZ",                    # 37
         "@P0 BRA @12>",                             # 38: its back edge
         "EXIT",
         "BRA @40>",
         "IMAD R0, R1, R2, RZ",                      # 41: the slow path
         "RET.REL.NODEC R20 0x0"]

CASCADE = ["S2R R0, SR_TID.X",          # 0
           "LDS R1, [R0]",              # 1: the level loop's head
           "ISETP.NE.AND P1, PT, R2, RZ, PT",
           "@P1 BRA @6>",               # 3: this level's kind
           "IADD3 R3, R3, R1, RZ",      # 4: the 1-mul side
           "BRA @9>",
           "IMAD.WIDE.U32 R4, R1, R5, R4",  # 6: the 2-mul side
           "IMAD.WIDE.U32 R6, R1, R7, R6",
           "IMAD.WIDE.U32 R8, R1, R9, R8",
           "BAR.SYNC.DEFER_BLOCKING 0x0",   # 9
           "@P2 BRA @1>",
           "EXIT",
           "BRA @12>"]


def test_step_path_takes_the_fast_division_and_nz_fold_blocks():
    (insts,) = sass_count.functions(_sass("step", STEP)).values()
    assert [i.addr for i in insts] == [16 * j for j in range(len(STEP))]
    assert insts[3].pred and insts[3].target == 16 * 7
    got = sass_count.thread_counts(insts, rounds=2, nz=2)
    # outside the loop: ISETP, EXIT, ISETP, BRA; IMAD.HI, IADD3; 3 IMADs;
    # EXIT. Each of 2 rounds: LOP3, 8 BRAs, 2 of 8 blocks of 2 IMADs,
    # IADD3, the back edge
    assert got == {"fma": 1 + 3 + 2 * 4, "alu": 2 + 1 + 2 * 2,
                   "all": 4 + 2 + 3 + 1 + 2 * 15}


@pytest.mark.parametrize("kinds,want", [
    ((), {"fma": 0, "alu": 0, "all": 2}),
    ((0,), {"fma": 0, "alu": 2, "all": 9}),
    ((1,), {"fma": 3, "alu": 1, "all": 10}),
    ((0, 1, 0), {"fma": 3, "alu": 5, "all": 24})])
def test_cascade_level_loop_runs_each_level_by_its_kind(kinds, want):
    (insts,) = sass_count.functions(_sass("cascade", CASCADE)).values()
    assert sass_count.thread_counts(insts, 2, 2, kinds) == want


def test_classify_puts_multiplies_and_alu_ops_on_their_pipes():
    insts = sass_count.functions(_sass("k", [
        "IMAD.MOV.U32 R0, RZ, RZ, R1", "IMUL.WIDE R0, R1, R2",
        "LOP3.LUT R0, R1, R2, RZ, 0xc0, !PT", "SHF.R.U32.HI R0, RZ, 0x10, R1",
        "LDG.E R0, desc[UR4][R2.64]", "MOV R0, R1", "EXIT"]))["k"]
    assert [sass_count.classify(i) for i in insts] == [
        ("fma", "all"), ("fma", "all"), ("alu", "all"), ("alu", "all"),
        ("all",), ("all",), ("all",)]
