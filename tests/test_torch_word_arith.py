"""csrc/word_arith.cuh, the kernels' field arithmetic on 32-bit words,
compiled with g++ on the CPU (the very header nvcc compiles for the card)
into a small ctypes harness in ``ecfft_tpu_torch/_build/``, and held
against Python integers. The harness instantiates the header's templates
at 1, 2, 3, 4, 7, 8, 13, 14, 15 and 16 limbs (1, 2, 4, 7 and 8 words, odd
limb counts among them), in both forms: the fold (a pseudo-Mersenne prime,
canonical values; at one limb the only form, "fold1", for 97, 64513 and
65521) and CIOS (any other prime, Montgomery values with R =
2^(16L), an odd L's last round on a 16-bit digit). Checked: pack/unpack
and the strided load/store, the 1- and 2-product multiply-adds, both
reductions, the three functions the kernels call (fma1, fma2, mul) and the
modular add, on edge values, seeded random values and hypothesis cases;
for secp256k1 and 2^255 − 19 also 512-bit inputs fed straight to the fold
and the inputs that make it run three rounds; for every CIOS prime, among
them a 256-bit prime with slack 0, the reduction at the top of its range.
Also: ``ops/step.py::_Field`` mirrors ``struct Field`` field by field. The
M31 kernels' ``csrc/m31_arith.cuh`` goes into the same harness: its sum,
product, the two multiply-adds and the reduction of any 64-bit value, on
edge, seeded and hypothesis values. Needs g++ only; imports no JAX."""

import ctypes
import os
import random

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from ecfft_tpu_torch.fields.registry import FIELDS, spec_for_prime
from ecfft_tpu_torch.ops import _build, step

HEADER = os.path.join(os.path.dirname(_build.KERNEL_SOURCES[0]),
                      "word_arith.cuh")
M31_HEADER = os.path.join(os.path.dirname(HEADER), "m31_arith.cuh")
FORMS = (2, 3, 4, 7, 8, 13, 14, 15, 16)  # the limb counts the harness takes
HARNESS = r"""
#include <cstddef>
#include "word_arith.cuh"
#include "m31_arith.cuh"

template <int N> static void in(const uint32_t* p, uint32_t (&a)[N]) {
  for (int k = 0; k < N; ++k) a[k] = p[k];
}
template <int N> static void out(const uint32_t (&a)[N], uint32_t* p) {
  for (int k = 0; k < N; ++k) p[k] = a[k];
}

// one function of the header at NL limbs: a..d are NW words (v: 2 NW + 1)
template <int NL>
static void op(int which, const Field* fd, const uint32_t* a,
               const uint32_t* b, const uint32_t* c, const uint32_t* d,
               uint32_t* r) {
  constexpr int NW = wa::words(NL);
  uint32_t A[NW], B[NW], C[NW], D[NW], V[2 * NW + 1], R[NW], Lm[NL];
  switch (which) {
    case 0: in(a, A); in(b, B); in(c, C); wa::mul_add<NW>(A, B, C, V);
            out(V, r); break;
    case 1: in(a, A); in(b, B); in(c, C); in(d, D);
            wa::mul_add2<NW>(A, B, C, D, V); out(V, r); break;
    case 2: in(a, V); wa::reduce<NL>(*fd, V, R); out(R, r); break;
    case 3: in(a, V); wa::redc<NL>(*fd, V, R); out(R, r); break;
    case 4: in(a, A); in(b, B); in(c, C);
            wa::fma1<NL, false>(*fd, A, B, C, R); out(R, r); break;
    case 5: in(a, A); in(b, B); in(c, C);
            wa::fma1<NL, true>(*fd, A, B, C, C); out(C, r); break;
    case 6: in(a, A); in(b, B); in(c, C); in(d, D);
            wa::fma2<NL, false>(*fd, A, B, C, D, R); out(R, r); break;
    case 7: in(a, A); in(b, B); in(c, C); in(d, D);
            wa::fma2<NL, true>(*fd, A, B, C, D, B); out(B, r); break;
    case 8: in(a, A); in(b, B); wa::mul<NL, false>(*fd, A, B, R);
            out(R, r); break;
    case 9: in(a, A); in(b, B); wa::mul<NL, true>(*fd, A, B, A);
            out(A, r); break;
    case 10: in(a, Lm); wa::pack<NL>(Lm, R); out(R, r); break;
    case 11: in(a, A); wa::unpack<NL>(A, Lm); out(Lm, r); break;
    case 12: in(a, A); in(b, B); wa::add_mod<NW>(*fd, A, B, R); out(R, r);
             break;
  }
}

template <int NL>
static void load_store(const int32_t* src, int32_t* dst, long stride,
                       uint32_t* w) {
  uint32_t a[wa::words(NL)];
  wa::load_words<NL>(src, stride, a);
  out(a, w);
  wa::store_words<NL>(dst, stride, a);
}

extern "C" {
#define FORM(N) case N: op<N>(which, fd, a, b, c, d, r); return 0;
int h_op(int nl, int which, const Field* fd, const uint32_t* a,
         const uint32_t* b, const uint32_t* c, const uint32_t* d,
         uint32_t* r) {
  switch (nl) { FORM(1) FORM(2) FORM(3) FORM(4) FORM(7) FORM(8) FORM(13)
                FORM(14) FORM(15) FORM(16) }
  return 1;
}
#define LS(N) case N: load_store<N>(src, dst, stride, w); return 0;
int h_load_store(int nl, const int32_t* src, int32_t* dst, long stride,
                 uint32_t* w) {
  switch (nl) { LS(3) LS(4) LS(13) LS(16) }
  return 1;
}
void h_layout(size_t* o) {
  o[0] = offsetof(Field, pw); o[1] = offsetof(Field, fw);
  o[2] = offsetof(Field, np); o[3] = offsetof(Field, np16);
  o[4] = offsetof(Field, slack); o[5] = offsetof(Field, nw);
  o[6] = offsetof(Field, mont); o[7] = sizeof(Field);
}
uint32_t h_m31_reduce(uint64_t t) { return m31::reduce(t); }
uint32_t h_m31_add(uint32_t a, uint32_t b) { return m31::add(a, b); }
uint32_t h_m31_mul(uint32_t a, uint32_t b) { return m31::mul(a, b); }
uint32_t h_m31_mul_add(uint32_t c, uint32_t y, uint32_t x) {
  return m31::mul_add(c, y, x);
}
uint32_t h_m31_mul_add2(uint32_t a, uint32_t x, uint32_t b, uint32_t y) {
  return m31::mul_add2(a, x, b, y);
}
}
"""

SECP = FIELDS["secp256k1"]
ED = spec_for_prime(2**255 - 19)
SPECS = [SECP, ED]
M256 = (1 << 256) - 1
NV = 17


@pytest.fixture(scope="module")
def lib():
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    src = os.path.join(_build.BUILD_DIR, "word_arith_harness.cpp")
    out = os.path.join(_build.BUILD_DIR, "libword_arith_harness.so")
    if not os.path.exists(src) or open(src).read() != HARNESS:
        with open(src, "w") as f:
            f.write(HARNESS)
    if _build._stale(out, [src, HEADER, M31_HEADER]):
        _build._compile(lambda o: [
            "g++", "-O2", "-std=c++17", "-shared", "-fPIC", "-I",
            os.path.dirname(HEADER), "-o", o, src], out)
    so = ctypes.CDLL(out)
    ptr = ctypes.c_void_p
    so.h_op.argtypes = [ctypes.c_int, ctypes.c_int] + [ptr] * 6
    so.h_load_store.argtypes = [ctypes.c_int, ptr, ptr, ctypes.c_long, ptr]
    u32 = ctypes.c_uint32
    so.h_m31_reduce.argtypes = [ctypes.c_uint64]
    for name, n in (("h_m31_add", 2), ("h_m31_mul", 2),
                    ("h_m31_mul_add", 3), ("h_m31_mul_add2", 4)):
        getattr(so, name).argtypes = [u32] * n
    for name in ("h_m31_reduce", "h_m31_add", "h_m31_mul", "h_m31_mul_add",
                 "h_m31_mul_add2"):
        getattr(so, name).restype = u32
    return so


def _words(v: int, n: int) -> np.ndarray:
    return np.array([(v >> 32 * k) & 0xFFFFFFFF for k in range(n)],
                    dtype=np.uint32)


def _int(w) -> int:
    return sum(int(x) << 32 * k for k, x in enumerate(w))


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


# the harness's functions (h_op's `which`)
MUL_ADD, MUL_ADD2, REDUCE, REDC, FMA1, FMA1_M, FMA2, FMA2_M, MUL, MUL_M, \
    PACK, UNPACK, ADD_MOD = range(13)


def call(lib, nl: int, which: int, spec, *vals, n_in=None):
    """One header function at nl limbs on python ints; returns an int
    (PACK/UNPACK: the words or limbs as a list)."""
    nw = (nl + 1) // 2
    n_in = n_in or (2 * nw + 1 if which in (REDUCE, REDC) else
                    nl if which == PACK else nw)
    bufs = [_words(v, n_in) if which != PACK else
            np.array([(v >> 16 * j) & 0xFFFF for j in range(nl)], np.uint32)
            for v in vals] + [np.zeros(max(n_in, 2 * nw + 1), np.uint32)
                              for _ in range(4 - len(vals))]
    r = np.zeros(2 * nw + 1 + nl, np.uint32)
    fd = ctypes.byref(step._field(spec)) if spec is not None else None
    assert lib.h_op(nl, which, fd, *(_ptr(b) for b in bufs[:4]),
                    _ptr(r)) == 0
    if which in (MUL_ADD, MUL_ADD2):
        return _int(r[:2 * nw + 1])
    if which == UNPACK:
        return [int(x) for x in r[:nl]]
    return _int(r[:nw])


def mul_add(lib, a, b, x):
    return call(lib, 16, MUL_ADD, None, a, b, x)


def mul_add2(lib, a, b, c, d):
    return call(lib, 16, MUL_ADD2, None, a, b, c, d)


def reduce(lib, spec, v):
    return call(lib, spec.num_limbs, REDUCE, spec, v)


def _fold_rounds(spec, v):
    """Rounds of the header's fold loop on v (its high part nonzero)."""
    F, n = (1 << 256) % spec.p, 0
    while v >> 256:
        v, n = (v & M256) + (v >> 256) * F, n + 1
    return n


def _third_round_input(spec, rng):
    """x, c, y (each below p) whose x + c·y makes the fold run three
    rounds: its low half after the first lies within F of 2^256."""
    F = (1 << 256) % spec.p
    while True:
        c, y = rng.randrange(spec.p), rng.randrange(spec.p)
        prod = c * y
        target = (1 << 256) - 1 - rng.randrange(F)
        x = (target - (prod & M256) - (prod >> 256) * F) % (1 << 256)
        if x < spec.p and _fold_rounds(spec, x + prod) == 3:
            return x, c, y


def _low_half_input(spec, rng):
    """c, y (below p) whose product's low half lies within 2^70 of
    2^256."""
    while True:
        c = rng.randrange(1, spec.p) | 1
        y = ((1 << 256) - rng.randrange(1, 1 << 70)) * pow(c, -1, 1 << 256) \
            % (1 << 256)
        if y < spec.p:
            return c, y


def edge_values(spec):
    p, F = spec.p, (1 << 256) % spec.p
    return [0, 1, 2, p - 1, p - 2, p, p + 1, (p - 1) // 2, M256,
            M256 - 1, 1 << 255, (1 << 32) - 1, 1 << 32, F, F - 1]


def test_field_mirror_matches_the_struct(lib):
    got = (ctypes.c_size_t * 8)()
    lib.h_layout(got)
    F = step._Field
    assert list(got) == [F.pw.offset, F.fw.offset, F.np.offset,
                         F.np16.offset, F.slack.offset, F.nw.offset,
                         F.mont.offset, ctypes.sizeof(F)]
    assert [name for name, _ in F._fields_] == ["pw", "fw", "np", "np16",
                                                "slack", "nw", "mont"]
    assert F.pw.size == 4 * step.MAX_WORDS == F.fw.size


@pytest.mark.parametrize("spec", SPECS, ids=lambda s: s.name)
def test_field_words_are_p_and_the_fold_multiplier(spec):
    fd = step._field(spec)
    assert _int(fd.pw) == spec.p
    assert _int(fd.fw) == (1 << 256) % spec.p
    assert fd.slack == 256 - spec.p.bit_length()
    assert (fd.np, fd.np16, fd.nw, fd.mont) == (0, 0, 8, 0)


def test_pack_unpack_and_strided_load_store(lib):
    """At 16, 13, 4 and 3 limbs (an odd count's top limb alone in its
    word)."""
    rng = random.Random(1)
    for nl in (16, 13, 4, 3):
        top = (1 << 16 * nl) - 1
        for v in [0, 1, top, top - 1, 1 << (16 * nl - 1)] + [
                rng.getrandbits(16 * nl) for _ in range(20)]:
            limbs = np.array([(v >> 16 * j) & 0xFFFF for j in range(nl)],
                             np.uint32)
            assert call(lib, nl, PACK, None, v) == v
            assert call(lib, nl, UNPACK, None, v) == list(limbs)
            stride = 3  # limb j at j * stride, as a state's lane is
            src = np.full(nl * stride, -1, np.int32)
            src[::stride] = limbs.astype(np.int32)
            dst = np.full_like(src, -7)
            w = np.zeros((nl + 1) // 2, np.uint32)
            assert lib.h_load_store(nl, _ptr(src), _ptr(dst), stride,
                                    _ptr(w)) == 0
            assert _int(w) == v
            assert np.array_equal(dst[::stride], src[::stride])
            assert (np.delete(dst, np.arange(0, dst.size, stride))
                    == -7).all()


@pytest.mark.parametrize("spec", SPECS, ids=lambda s: s.name)
def test_edge_values(lib, spec):
    E = edge_values(spec)
    for a in E:
        for b in E:
            for x in (0, b, M256):
                v = mul_add(lib, a, b, x)
                assert v == a * b + x
                assert reduce(lib, spec, v) == v % spec.p
            v = mul_add2(lib, a, b, b, a)
            assert v == 2 * a * b
            assert reduce(lib, spec, v) == v % spec.p
    big = 2 * M256 * M256  # the largest 2-mul sum
    assert mul_add2(lib, M256, M256, M256, M256) == big
    for v in (big, (1 << 512) - 1, ((1 << 257) - 1) << 256 | M256,
              M256 << 256 | (M256 - 5), (1 << 256) - 1, spec.p,
              (1 << NV * 32) - 1, spec.p * ((1 << 256) - 1)):
        assert reduce(lib, spec, v) == v % spec.p


@pytest.mark.parametrize("spec", SPECS, ids=lambda s: s.name)
def test_fold_corner_cases(lib, spec):
    """The product's low half within 2^70 of 2^256, and x + c·y whose
    fold runs three rounds (all inputs below p)."""
    rng = random.Random(spec.p % 1000)
    for _ in range(20):
        c, y = _low_half_input(spec, rng)
        assert (c * y) % (1 << 256) >= (1 << 256) - (1 << 70)
        for x in (0, spec.p - 1):
            v = mul_add(lib, c, y, x)
            assert v == c * y + x and reduce(lib, spec, v) == v % spec.p
        v = mul_add2(lib, c, y, spec.p - 1, spec.p - 1)
        assert reduce(lib, spec, v) == v % spec.p
        x, c, y = _third_round_input(spec, rng)
        v = mul_add(lib, c, y, x)
        assert v == c * y + x and reduce(lib, spec, v) == v % spec.p


@pytest.mark.parametrize("spec", SPECS, ids=lambda s: s.name)
def test_seeded_random_values(lib, spec):
    rng = random.Random(7)
    for _ in range(300):
        a, b, c, d = (rng.randrange(spec.p) for _ in range(4))
        v = mul_add(lib, a, b, c)
        assert v == a * b + c and reduce(lib, spec, v) == (a * b + c) % spec.p
        v = mul_add2(lib, a, b, c, d)
        assert v == a * b + c * d
        assert reduce(lib, spec, v) == (a * b + c * d) % spec.p


u256 = st.integers(0, M256)


@settings(max_examples=300, deadline=None)
@given(a=u256, b=u256, c=u256, d=u256, which=st.sampled_from([0, 1]))
def test_hypothesis_products(lib, a, b, c, d, which):
    spec = SPECS[which]
    v = mul_add(lib, a, b, c)
    assert v == a * b + c and reduce(lib, spec, v) == v % spec.p
    v = mul_add2(lib, a, b, c, d)
    assert v == a * b + c * d and reduce(lib, spec, v) == v % spec.p


@settings(max_examples=300, deadline=None)
@given(hi=st.one_of(st.integers(0, (1 << 257) - 1),
                    st.just((1 << 256) - 1), st.just((1 << 257) - 1)),
       lo=st.one_of(u256, st.integers(0, 1 << 80).map(lambda e: M256 - e)),
       which=st.sampled_from([0, 1]))
def test_hypothesis_reduce_512_bit_inputs(lib, hi, lo, which):
    """Inputs fed straight to the reduction: high words all ones, the low
    half just under 2^256, up to the largest 2-mul sum's 513 bits."""
    spec = SPECS[which]
    v = hi << 256 | lo
    assert reduce(lib, spec, v) == v % spec.p


# ------------------------------------------- every form: fold and CIOS

# (name, prime) at 2 .. 16 limbs, 1 .. 8 words: fold-friendly primes (the
# largest below 2^(16L), Mersenne primes, M61, 2^256 − 1053 whose fold
# digit is past 2^10) and primes without a fold (the CIOS form: the STARK
# prime, the odd-L primes the card's phase 10 takes, and seeded random
# primes, among them CIOS256, a 256-bit prime with slack 0 drawn by
# nextprime(random.Random(256).getrandbits(256) | 2^255)).
CIOS256 = 0xf50b79840a35e888cea8684b60033cd65db233956ea88f4b4f72fd3f7d254dc9
FORM_PRIMES = [
    ("fold2", (1 << 31) - 19), ("fold3", 0xffffffffffc5),
    ("m61", (1 << 61) - 1), ("mersenne107", (1 << 107) - 1),
    ("mersenne127", (1 << 127) - 1),
    ("fold13", 0xfffffffffffffffffffffffffffffffffffffffffffffffffed5),
    ("fold14", (1 << 224) - 63),
    ("fold15", 0xfffffffffffffffffffffffffffffffffffffffffffffffffffffffffe2d),
    ("band", (1 << 256) - 1053),
    ("cios2", 0xf4bea985), ("cios3", 0xff8000000f),
    ("cios4", 0xae84496e7857ddc5),
    ("cios7", 0xb3404dc2a627940eee3cba6f8771),
    ("cios8", 0xc1d8fac168fb90d7b938451ee325fabd),
    ("cios13", 0xd9cd502d42af1ffe0de8d79f49af6d114c4a6f188a424e61cb),
    ("cios14", 0xd0055979a2da95a83ec33dd6887e840043e58844c2354e2bb7740aa9),
    ("cios15",
     0xf6979d9b532aba4e6c3686ff0de26a7698065aab0a377f90ade7bc38d7d3),
    ("stark",
     0x0800000000000011000000000000000000000000000000000000000000000001),
    ("cios256", CIOS256),
    # one 16-bit limb with a fold ("fold1"): F = 61, slack 9; F = 1023,
    # slack 0 (the fold loop's five rounds); F = 15, slack 0
    ("fold1_97", 97), ("fold1_64513", 64513), ("fold1_65521", 65521),
]
FORM_SPECS = [spec_for_prime(p, name) for name, p in FORM_PRIMES]


def test_form_primes_cover_each_form():
    forms = {(s.num_limbs, step.kernel_form(s)[:4]) for s in FORM_SPECS}
    for nl in FORMS:
        assert {(nl, "fold"), (nl, "cios")} <= forms, nl
    by = {s.name: s for s in FORM_SPECS}
    assert by["band"].fold_terms == ((0, 1053),)
    assert by["cios256"].p.bit_length() == 256
    assert all(s.fold_terms is None for s in FORM_SPECS
               if s.name.startswith("cios") or s.name == "stark")
    ones = [s for s in FORM_SPECS if s.num_limbs == 1]
    assert [step.kernel_form(s) for s in ones] == ["fold1"] * 3
    assert [s.fold_terms for s in ones] == [((0, 61),), ((0, 1023),),
                                           ((0, 15),)]


def test_one_limb_fold_takes_five_rounds(lib):
    """p = 64513 (F = 1023): the largest sum of two products, and every
    value below 2^33 whose fold runs the most rounds, reduce exactly."""
    spec = spec_for_prime(64513)
    p = spec.p
    top = 2 * (p - 1) ** 2
    vals = [top, top - 1, (1 << 33) - 1, (1 << 16) + 1022, 1 << 16,
            (1 << 16) - 1, p, p - 1, 0]
    for v in vals:
        assert call(lib, 1, REDUCE, spec, v) == v % p
    assert call(lib, 1, FMA2, spec, p - 1, p - 1, p - 1, p - 1) == top % p
    assert call(lib, 1, PACK, None, 0xBEEF) == 0xBEEF
    assert call(lib, 1, UNPACK, None, 0xBEEF) == [0xBEEF]


def _want(spec, mont: bool, value: int) -> int:
    """A product's reduction in the form: canonical, times R⁻¹ for CIOS."""
    if mont:
        value *= pow(spec.r, -1, spec.p)
    return value % spec.p


def _form_checks(lib, spec, a, b, c, d):
    """fma1, fma2 and mul of the form that takes ``spec``, and the bare
    reduction of their products, against python ints."""
    nl, p = spec.num_limbs, spec.p
    mont = step.kernel_form(spec).startswith("cios")
    ops = (FMA1_M, FMA2_M, MUL_M) if mont else (FMA1, FMA2, MUL)
    assert call(lib, nl, ops[0], spec, a, b, c) == (
        c + _want(spec, mont, a * b)) % p
    assert call(lib, nl, ops[1], spec, a, b, c, d) == _want(
        spec, mont, a * b + c * d)
    assert call(lib, nl, ops[2], spec, a, b) == _want(spec, mont, a * b)
    v = call(lib, nl, MUL_ADD2, None, a, b, c, d)
    assert v == a * b + c * d
    assert call(lib, nl, REDC if mont else REDUCE, spec, v) == _want(
        spec, mont, v)
    assert call(lib, nl, ADD_MOD, spec, a, c) == (a + c) % p


def form_edges(spec):
    """0, 1, 2, p − 1, p − 2, (p − 1)/2, R mod p and R² mod p (Montgomery
    1 and R), F − 1, and the values nearest 2^(16L − 1)."""
    p, R = spec.p, spec.r
    vals = {0, 1, 2, p - 1, p - 2, (p - 1) // 2, R % p, R * R % p,
            (R % p) - 1, (1 << (16 * spec.num_limbs - 1)) % p}
    return sorted(v for v in vals if 0 <= v < p)


@pytest.mark.parametrize("spec", FORM_SPECS, ids=lambda s: s.name)
def test_form_edge_values(lib, spec):
    E = form_edges(spec)
    for a in E:
        for b in E:
            _form_checks(lib, spec, a, b, E[-1 - E.index(a)], b)
            _form_checks(lib, spec, a, b, spec.p - 1, spec.p - 1)


@pytest.mark.parametrize("spec", FORM_SPECS, ids=lambda s: s.name)
def test_form_seeded_random_values(lib, spec):
    rng = random.Random(spec.p % 10007)
    for _ in range(150):
        _form_checks(lib, spec, *(rng.randrange(spec.p) for _ in range(4)))


@pytest.mark.parametrize("spec", [s for s in FORM_SPECS
                                  if s.fold_terms is None],
                         ids=lambda s: s.name)
def test_cios_bound_inputs(lib, spec):
    """The reduction at the top of its range: v = 2(p − 1)², the largest
    sum of two products, and sums whose Montgomery quotient lands within
    a few units of 2p and of p before the final subtractions."""
    p, R, nl = spec.p, spec.r, spec.num_limbs
    rinv = pow(R, -1, p)
    top = 2 * (p - 1) ** 2
    rng = random.Random(nl)
    vals = [top, top - 1, (p - 1) ** 2, p * p - 1, 2 * p * p - 1 - 2 * p]
    for target in (2 * p, 2 * p - 1, p, p - 1, 2 * p + 1):
        # v = target·R − M·p for an M < R with v ≡ 0 mod R's residues
        for _ in range(3):
            m = rng.randrange(R)
            v = target * R - m * p
            if 0 <= v <= top:
                vals.append(v)
    for v in vals:
        assert call(lib, nl, REDC, spec, v) == v * rinv % p


@settings(max_examples=200, deadline=None)
@given(which=st.integers(0, len(FORM_SPECS) - 1), data=st.data())
def test_form_hypothesis(lib, which, data):
    spec = FORM_SPECS[which]
    el = st.integers(0, spec.p - 1)
    _form_checks(lib, spec, *(data.draw(el) for _ in range(4)))


# ------------------------------------------------------------------ M31

M31 = (1 << 31) - 1
M31_EDGE = [0, 1, 2, M31 - 1, M31 - 2, 1 << 30, (M31 - 1) // 2, 1 << 16,
            (1 << 16) - 1, (1 << 30) - 1, (1 << 30) + 1]


def _m31_all(lib, a, b, c, d):
    """Each M31 function of the header on canonical a, b, c, d against
    Python integers."""
    assert lib.h_m31_add(a, b) == (a + b) % M31
    assert lib.h_m31_mul(a, b) == a * b % M31
    assert lib.h_m31_mul_add(a, b, c) == (a * b + c) % M31
    assert lib.h_m31_mul_add2(a, b, c, d) == (a * b + c * d) % M31


def test_m31_edge_values(lib):
    for a in M31_EDGE:
        for b in M31_EDGE:
            _m31_all(lib, a, b, b, a)
            _m31_all(lib, a, b, M31 - 1, M31 - 1)
    for t in (0, M31, M31 + 1, 2 * M31, M31 * M31, (M31 - 1) ** 2,
              2 * (M31 - 1) ** 2, (M31 - 1) ** 2 + M31 - 1, 1 << 62,
              (1 << 63) - 1, 1 << 63, (1 << 64) - 1, (1 << 64) - M31,
              (1 << 32) - 1, 1 << 31):
        assert lib.h_m31_reduce(t) == t % M31


def test_m31_seeded_random_values(lib):
    rng = random.Random(31)
    for _ in range(2000):
        _m31_all(lib, *(rng.randrange(M31) for _ in range(4)))
        t = rng.getrandbits(64)
        assert lib.h_m31_reduce(t) == t % M31


m31_el = st.integers(0, M31 - 1)


@settings(max_examples=300, deadline=None)
@given(a=m31_el, b=m31_el, c=m31_el, d=m31_el,
       t=st.one_of(st.integers(0, (1 << 64) - 1),
                   st.integers(0, 1 << 20).map(lambda e: (1 << 64) - 1 - e)))
def test_m31_hypothesis(lib, a, b, c, d, t):
    _m31_all(lib, a, b, c, d)
    assert lib.h_m31_reduce(t) == t % M31
