"""csrc/word_arith.cuh, the redesigned kernels' field arithmetic, compiled
with g++ on the CPU (the very header nvcc compiles for the card) into a
small ctypes harness in ``ecfft_tpu_torch/_build/``, and held against
Python integers: pack/unpack, the 1- and 2-product multiply-adds and the
reduction, for secp256k1 and 2^255 − 19, on edge values, seeded random
values and hypothesis cases (512-bit inputs fed straight to the
reduction). Also: ``ops/step.py::_Field`` mirrors ``struct Field`` field
by field. The M31 kernels' ``csrc/m31_arith.cuh`` goes into the same
harness: its sum, product, the two multiply-adds and the reduction of any
64-bit value, on edge, seeded and hypothesis values. Needs g++ only;
imports no JAX."""

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

extern "C" {
void h_pack(const uint32_t* l, uint32_t* w) {
  uint32_t a[NL], b[NW]; in(l, a); wa::pack(a, b); out(b, w);
}
void h_unpack(const uint32_t* w, uint32_t* l) {
  uint32_t a[NW], b[NL]; in(w, a); wa::unpack(a, b); out(b, l);
}
void h_load_store(const int32_t* src, int32_t* dst, long stride,
                  uint32_t* w) {
  uint32_t a[NW]; wa::load_words(src, stride, a); out(a, w);
  wa::store_words(dst, stride, a);
}
void h_mul_add(const uint32_t* a, const uint32_t* b, const uint32_t* x,
               uint32_t* v) {
  uint32_t A[NW], B[NW], X[NW], V[NV];
  in(a, A); in(b, B); in(x, X); wa::mul_add(A, B, X, V); out(V, v);
}
void h_mul_add2(const uint32_t* a, const uint32_t* b, const uint32_t* c,
                const uint32_t* d, uint32_t* v) {
  uint32_t A[NW], B[NW], C[NW], D[NW], V[NV];
  in(a, A); in(b, B); in(c, C); in(d, D); wa::mul_add2(A, B, C, D, V);
  out(V, v);
}
void h_reduce(const Field* fd, const uint32_t* v, uint32_t* r) {
  uint32_t V[NV], R[NW]; in(v, V); wa::reduce(*fd, V, R); out(R, r);
}
void h_layout(size_t* o) {
  o[0] = offsetof(Field, p); o[1] = offsetof(Field, f);
  o[2] = offsetof(Field, slack); o[3] = offsetof(Field, pw);
  o[4] = offsetof(Field, fw); o[5] = sizeof(Field);
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
    so.h_load_store.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                ctypes.c_long, ctypes.c_void_p]
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


def mul_add(lib, a, b, x):
    v = np.zeros(NV, np.uint32)
    lib.h_mul_add(*(_ptr(_words(u, 8)) for u in (a, b, x)), _ptr(v))
    return _int(v)


def mul_add2(lib, a, b, c, d):
    v = np.zeros(NV, np.uint32)
    lib.h_mul_add2(*(_ptr(_words(u, 8)) for u in (a, b, c, d)), _ptr(v))
    return _int(v)


def reduce(lib, spec, v):
    r = np.zeros(8, np.uint32)
    lib.h_reduce(ctypes.byref(step._field(spec)), _ptr(_words(v, NV)),
                 _ptr(r))
    return _int(r)


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
    got = (ctypes.c_size_t * 6)()
    lib.h_layout(got)
    F = step._Field
    assert list(got) == [F.p.offset, F.f.offset, F.slack.offset,
                         F.pw.offset, F.fw.offset, ctypes.sizeof(F)]
    assert [name for name, _ in F._fields_] == ["p", "f", "slack", "pw",
                                                "fw"]
    assert F.pw.size == 4 * step.KERNEL_WORDS == F.fw.size


@pytest.mark.parametrize("spec", SPECS, ids=lambda s: s.name)
def test_field_words_are_p_and_the_fold_multiplier(spec):
    fd = step._field(spec)
    assert _int(fd.pw) == spec.p
    assert _int(fd.fw) == (1 << 256) % spec.p == spec.from_limbs(fd.f)
    assert fd.slack == 256 - spec.p.bit_length()


def test_pack_unpack_and_strided_load_store(lib):
    rng = random.Random(1)
    for v in edge_values(SECP) + [rng.getrandbits(256) for _ in range(20)]:
        limbs = np.array([(v >> 16 * j) & 0xFFFF for j in range(16)],
                         np.uint32)
        w = np.zeros(8, np.uint32)
        lib.h_pack(_ptr(limbs), _ptr(w))
        assert _int(w) == v
        back = np.zeros(16, np.uint32)
        lib.h_unpack(_ptr(w), _ptr(back))
        assert np.array_equal(back, limbs)
        stride = 3  # limb j at j * stride, as a state's lane is
        src = np.full(16 * stride, -1, np.int32)
        src[::stride] = limbs.astype(np.int32)
        dst = np.full_like(src, -7)
        lib.h_load_store(_ptr(src), _ptr(dst), stride, _ptr(w))
        assert _int(w) == v
        assert np.array_equal(dst[::stride], src[::stride])
        assert (np.delete(dst, np.arange(0, dst.size, stride)) == -7).all()


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
