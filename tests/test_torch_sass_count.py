"""tools/sass_count.py on small hand-written SASS: the path one thread
takes through a two-way branch around a slow-path call, a fold loop with
skippable blocks, and a cascade's level loop with a two-way branch per
level kind; and the shapes of the kernels on 32-bit words: a fold loop
behind a guard followed by the subtraction loop, and a ping-pong
cascade's level loop (one barrier, the element behind a guard, the fold
loop nested in it, the next level's A rows in a skippable block), the
warp cascade's level loop (shuffles and no barrier, a branch on the
level's xor whose sides do the same products), and a pair level's
kernel (its loads and shared stores behind the guard of the ragged edge,
one barrier, the partner's words from shared memory, one or two word
products, the fold and subtraction loops). Counts are exact."""

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


WORD_STEP = ["ISETP.GE.AND P0, PT, R0, c[0x0][0x0], PT",  # 0
             "@P0 EXIT",
             "LDG.E R2, desc[UR4][R8.64]",                 # 2: loads first
             "LDG.E R3, desc[UR4][R10.64]",
             "IMAD.WIDE.U32 R4, R2, R3, R4",               # 4: the product
             "IADD3 R5, P1, R5, R6, RZ",
             "@!P1 BRA @34>",                              # 6: fold guard
             "LOP3.LUT R9, R9, R10, RZ, 0xfc, !PT"]        # 7: fold loop
for blk in range(8):  # 8 + 3·blk: one block per word of F
    WORD_STEP += [f"@!P{blk % 7} BRA @{11 + 3 * blk}>",
                  "IMAD.WIDE.U32 R10, R11, R12, R10",
                  "IMAD.WIDE.U32 R12, R11, R13, R12"]
WORD_STEP += ["IADD3 R9, R9, 0x1, RZ",                      # 32
              "@P0 BRA @7>",                                # 33: back edge
              "IADD3 R14, P2, R14, -R15, RZ",               # 34: subtract
              "SEL R14, R14, R16, P2",
              "@P3 BRA @34>",                               # 36: slack loop
              "STG.E desc[UR4][R8.64], R14",
              "EXIT",
              "BRA @39>"]

WORD_CASCADE = ["S2R R0, SR_TID.X",                        # 0
                "BAR.SYNC.DEFER_BLOCKING 0x0",              # 1: tile in
                "ISETP.NE.AND P3, PT, R2, RZ, PT",          # 2: level loop
                "@!P0 BRA @37>",                            # 3: element guard
                "LDS R1, [R0]",
                "ISETP.NE.AND P1, PT, R2, RZ, PT",
                "@P1 BRA @9>",                              # 6: level kind
                "IMAD.WIDE.U32 R4, R1, R5, R4",             # 7: 1-mul side
                "BRA @11>",
                "IMAD.WIDE.U32 R4, R1, R5, R4",             # 9: 2-mul side
                "IMAD.WIDE.U32 R6, R1, R7, R6",
                "LOP3.LUT R9, R9, R10, RZ, 0xfc, !PT"]      # 11: fold loop
for blk in range(8):  # 12 + 3·blk
    WORD_CASCADE += [f"@!P{blk % 7} BRA @{15 + 3 * blk}>",
                     "IMAD.WIDE.U32 R10, R11, R12, R10",
                     "IMAD.WIDE.U32 R12, R11, R13, R12"]
WORD_CASCADE += ["@P4 BRA @11>",                            # 36: back edge
                 "STS [R0], R1",                            # 37
                 "@!P5 BRA @41>",                           # 38: next A rows
                 "LDG.E.CONSTANT R20, desc[UR4][R22.64]",
                 "LDG.E.CONSTANT R21, desc[UR4][R22.64+0x4]",
                 "BAR.SYNC.DEFER_BLOCKING 0x0",             # 41: one barrier
                 "@P2 BRA @2>",                             # 42: back edge
                 "LDS R1, [R0]",                            # 43: tile out
                 "STG.E desc[UR4][R8.64], R1",
                 "EXIT",
                 "BRA @46>"]


# the warp cascade's level loop (csrc/warp_cascade.cuh): no barrier in
# it, a two-way branch on the level's xor (register rows, h >= 32: picks
# and shuffles only where h % 32 != 0; or shuffles), each side a two-way
# branch on the level's kind; the staging barrier stands before the loop
WARP_CASCADE = ["S2R R0, SR_TID.X",                          # 0
                "STS [R0], R1",                              # 1: staged rows
                "BAR.SYNC.DEFER_BLOCKING 0x0",               # 2
                "ISETP.GE.U32.AND P0, PT, R44, 0x3f, PT",    # 3: level loop
                "@!P0 BRA @20>",                             # 4: h < 32
                "@P1 BRA @13>",                              # 5: rows, kind 1
                "SEL R53, R51, R54, !P5",                    # 6: picks
                "SEL R52, R54, R51, !P5",
                "SEL R51, R50, R55, !P4",
                "@!P2 BRA @11>",                             # 9: m = 0
                "SHFL.BFLY PT, R53, R53, R48, 0x1f",
                "IMAD.WIDE.U32 R56, R49, R53, R56",          # 11
                "BRA @29>",
                "SEL R53, R51, R54, !P5",                    # 13: kind 1
                "SEL R52, R54, R51, !P5",
                "@!P2 BRA @17>",                             # 15: m = 0
                "SHFL.BFLY PT, R53, R53, R48, 0x1f",
                "IMAD.WIDE.U32 R56, R49, R53, R56",          # 17
                "IMAD.WIDE.U32 R58, R50, R52, R56",
                "BRA @29>",
                "@P1 BRA @25>",                              # 20: shuffles
                "SHFL.BFLY PT, R53, R53, R48, 0x1f",         # kind 0
                "IMAD.WIDE.U32 R56, R49, R53, R56",
                "IADD3 R57, R57, R55, RZ",
                "BRA @29>",
                "SHFL.BFLY PT, R53, R53, R48, 0x1f",         # 25: kind 1
                "IMAD.WIDE.U32 R56, R49, R53, R56",
                "IMAD.WIDE.U32 R58, R50, R52, R56",
                "IADD3 R57, R57, R55, RZ",
                "IADD3 R2, R2, 0x1, RZ",                     # 29: the join
                "@P3 BRA @3>",                               # back edge
                "STG.E desc[UR4][R8.64], R1",
                "EXIT",
                "BRA @33>"]


def _pair(two):
    """A pair level's kernel, 1-mul or 2-mul: (lines, loads, products)."""
    n = 2 if two else 1
    head = ["S2R R0, SR_TID.X",                             # 0
            "ISETP.GE.AND P0, PT, R0, c[0x0][0x0], PT",
            None,                                           # 2: edge guard
            "LDG.E R2, desc[UR4][R8.64]"]                   # its element
    head += ["LDG.E.CONSTANT R3, desc[UR4][R10.64]"] * n    # coefficient rows
    head += ["LOP3.LUT R2, R2, R3, RZ, 0xfc, !PT"] * (1 + n)  # pack
    head += ["STS [R0], R2"]
    head[2] = f"@P0 BRA @{len(head)}>"
    body = ["BAR.SYNC.DEFER_BLOCKING 0x0",                  # the one barrier
            "@P0 EXIT",
            "LDS R4, [R0+0x200]"]                           # the partner
    body += ["IMAD.WIDE.U32 R4, R2, R3, R4"] * n            # the products
    body += ["IADD3 R5, P1, R5, R6, RZ", None]              # fold guard
    at = len(head) + len(body)                              # fold loop
    fold = ["LOP3.LUT R9, R9, R10, RZ, 0xfc, !PT"]
    for blk in range(8):  # one block per word of F
        fold += [f"@!P{blk % 7} BRA @{at + 4 + 3 * blk}>",
                 "IMAD.WIDE.U32 R10, R11, R12, R10",
                 "IMAD.WIDE.U32 R12, R11, R13, R12"]
    fold += ["IADD3 R9, R9, 0x1, RZ", f"@P0 BRA @{at}>"]    # back edge
    sub = at + len(fold)
    body[-1] = f"@!P1 BRA @{sub}>"
    tail = ["IADD3 R14, P2, R14, -R15, RZ",                 # subtract p·2^j
            "SEL R14, R14, R16, P2",
            f"@P3 BRA @{sub}>",                             # slack loop
            "STG.E desc[UR4][R8.64], R14",
            "EXIT",
            f"BRA @{sub + 5}>"]
    return head + body + fold + tail, 1 + n, n


@pytest.mark.parametrize("two", [False, True])
def test_pair_kernel_runs_its_guarded_loads_one_barrier_and_the_fold(two):
    """The block behind the edge guard holds a shared store, so it runs:
    LDGs, the packing LOP3s, STS. Then BAR, the idle threads' EXIT, LDS,
    one or two IMAD.WIDEs, IADD3, the fold guard; 2 fold rounds (LOP3, 8
    BRAs, 2 of 8 blocks of 2 IMAD.WIDEs, IADD3, the back edge); the
    subtraction loop once (IADD3, SEL, its back edge); STG, EXIT."""
    lines, loads, products = _pair(two)
    (insts,) = sass_count.functions(_sass("pair", lines)).values()
    got = sass_count.thread_counts(insts, rounds=2, nz=2)
    assert got == {"fma": products + 2 * 4,
                   "alu": 1 + loads + 1 + 2 * 2 + 2,
                   "all": 3 + 2 * loads + 1 + 3 + products + 2
                   + 2 * 15 + 3 + 2}
    assert sass_count.loads_before_first_product(insts) == (loads, loads)


def test_loads_before_first_product_stops_at_the_first_wide_multiply():
    insts = sass_count.functions(_sass("k", [
        "IMAD.WIDE R2, R0, 0x4, R2", "LDG.E R4, desc[UR4][R2.64]",
        "IMAD.WIDE.U32 R6, R4, R5, R6", "LDG.E R8, desc[UR4][R2.64+0x4]",
        "EXIT"]))["k"]
    assert sass_count.loads_before_first_product(insts) == (1, 2)


def test_word_step_runs_the_guarded_fold_then_the_subtraction_once():
    (insts,) = sass_count.functions(_sass("aff1s", WORD_STEP)).values()
    got = sass_count.thread_counts(insts, rounds=2, nz=2)
    # outside the loops: ISETP, EXIT, 2 LDGs, IMAD.WIDE, IADD3, the guard;
    # STG, EXIT. Each of 2 fold rounds: LOP3, 8 BRAs, 2 of 8 blocks of 2
    # IMAD.WIDEs, IADD3, the back edge. The subtraction loop once: IADD3,
    # SEL, its back edge
    assert got == {"fma": 1 + 2 * 4, "alu": 2 + 2 * 2 + 2,
                   "all": 7 + 2 * 15 + 3 + 2}


@pytest.mark.parametrize("kinds,want", [
    ((), {"fma": 0, "alu": 0, "all": 5}),
    ((0,), {"fma": 9, "alu": 4, "all": 44}),
    ((1,), {"fma": 10, "alu": 4, "all": 44}),
    ((0, 1, 0), {"fma": 28, "alu": 12, "all": 122})])
def test_word_cascade_level_runs_element_fold_and_one_barrier(kinds, want):
    """Per level: ISETP, the guard (falls through), LDS, ISETP, the kind's
    branch and side (1 or 2 IMAD.WIDEs, 2 instructions), 2 fold rounds
    (LOP3, 8 BRAs, 2 of 8 blocks of 2 IMAD.WIDEs, the back edge), STS,
    the skipped A-row block's branch, BAR, the back edge. Outside: S2R,
    BAR, LDS, STG, EXIT."""
    (insts,) = sass_count.functions(_sass("cascade",
                                          WORD_CASCADE)).values()
    assert sass_count.thread_counts(insts, 2, 2, kinds) == want


@pytest.mark.parametrize("kinds,want", [
    ((), {"fma": 0, "alu": 0, "all": 5}),
    ((0,), {"fma": 1, "alu": 3, "all": 14}),
    ((1,), {"fma": 2, "alu": 3, "all": 14}),
    ((0, 1, 0), {"fma": 4, "alu": 9, "all": 32})])
def test_warp_cascade_level_loop_runs_per_level_without_a_barrier(kinds,
                                                                  want):
    """The loop holds shuffles and no barrier: still the level loop, run
    once per level by its kind. Per level: ISETP, the xor's branch, then
    the shorter of its two sides, which do the same products (the
    shuffle side: the kind's branch, SHFL, 1 or 2 IMAD.WIDEs, IADD3, the
    jump to the join; the register-row side has three picks more), the
    join's IADD3 and the back edge. Outside: S2R, STS, BAR, STG, EXIT."""
    (insts,) = sass_count.functions(_sass("warp_cascade",
                                          WARP_CASCADE)).values()
    assert sass_count.thread_counts(insts, 2, 2, kinds) == want


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


FOLD2 = ["ISETP.GE.AND P0, PT, R0, c[0x0][0x0], PT",  # 0
         "@P0 EXIT",
         "LOP3.LUT R9, R9, R10, RZ, 0xfc, !PT",      # 2: the fold loop
         "@!P0 BRA @6>",                             # 3: F's word 0
         "IMAD.WIDE.U32 R4, R5, R6, R4",
         "IMAD.WIDE.U32 R6, R5, R7, R6",
         "@!P1 BRA @9>",                             # 6: F's word 1
         "IMAD.WIDE.U32 R8, R5, R8, R8",
         "IMAD.WIDE.U32 R10, R5, R9, R10",
         "IADD3 R9, R9, 0x1, RZ",                    # 9
         "@P0 BRA @2>",                              # 10: the back edge
         "EXIT"]


@pytest.mark.parametrize("blocks,want", [
    (2, {"fma": 2 * 2, "alu": 1 + 2 * 2, "all": 3 + 2 * 7}),
    (8, {"fma": 0, "alu": 1 + 2, "all": 3 + 5})])
def test_fold_loop_of_a_two_word_form(blocks, want):
    """A fold loop with one skippable block per word of a 2-word form
    (M61's fold4): read as the fold loop (2 rounds, nz = 1 of its 2
    blocks, each of 2 IMAD.WIDEs) when ``fold_blocks`` is the form's word
    count; at the default of 8 it is an ordinary loop that runs once with
    its blocks skipped."""
    (insts,) = sass_count.functions(_sass("fold4", FOLD2)).values()
    assert sass_count.thread_counts(insts, 2, 1, (), blocks) == want
