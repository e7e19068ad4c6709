// Field arithmetic on 32-bit words, for every kernel of step_kernels.cu and
// fused_kernels.cu: any prime of NL = 2 .. 16 limbs of 16 bits, and a prime
// of one 16-bit limb with a fold (NL = 1, the "fold1" form: 97, 64513, ...;
// M31 has its own header, m31_arith.cuh).
//
// The state keeps an element as NL limbs of 16 bits, one per int32 (the
// layout every kernel shares). These functions pack it into NW = (NL + 1)
// / 2 words of 32 bits (an odd NL's top limb alone in the last word), form
// a product (or a sum of two) with 32x32->64-bit multiply-adds, NW^2 per
// product, and reduce the result to the canonical residue mod p in one of
// two ways, with R = 2^(16 NL) as in the JAX package:
//
// - reduce (the fold form): a prime with a pseudo-Mersenne fold, the
//   16-bit digits of F = R mod p summing below 2^11 (FieldSpec.fold_terms).
//   V = lo + H*R == lo + H*F (mod p). Residents are canonical values.
// - redc (the CIOS form): any other odd prime. Residents are in Montgomery
//   form, a*R mod p, and the reduction of a product of two of them is
//   (a*R)(b*R)/R = ab*R: NW rounds of m = v0 * n' mod 2^32, v += m*p, a
//   one-word shift; for an odd NL the last round takes a 16-bit digit (m
//   mod 2^16, a 16-bit shift), so that the shifts sum to 16 NL bits.
//
// Both give the canonical residue, which is unique, so the outputs carry
// the same bits as the JAX package's 16-bit-limb kernels.
//
// Every function is plain C++ for host and device: no intrinsics, no
// inline PTX. nvcc compiles it for the card; g++ compiles the very same
// header on the CPU, where tests/test_torch_word_arith.py holds it against
// Python integers at several word counts. A kernel library is compiled for
// one form (ops/_build.py passes -DECFFT_NL and -DECFFT_MONT), which the
// end of this header turns into NL, NW, NV and MONT.

#pragma once

#include <cstdint>

#ifndef __CUDACC__
#define __host__
#define __device__
#define __forceinline__ inline
#endif

constexpr int MAX_WORDS = 8;  // 16 limbs: p < 2^256

// The field's constants, passed by value as a kernel parameter (the
// layout of ops/step.py's _Field).
struct Field {
  uint32_t pw[MAX_WORDS];  // p's 32-bit words
  uint32_t fw[MAX_WORDS];  // fold form: F = 2^(16 NL) mod p in words,
                           // summing below 2^27; 0 in the CIOS form
  uint32_t np;             // CIOS form: n' = -p^-1 mod 2^32; 0 in the fold
  uint32_t np16;           // n' mod 2^16, the odd NL's half-word round
  int slack;               // 16 NL - bit length of p
  int nw;                  // words per element: the compiled form's, checked
  int mont;                // 1: the CIOS form; 0: the fold form; checked
};

namespace wa {

constexpr int words(int nl) { return (nl + 1) / 2; }

// NL limbs of 16 bits -> NW words
template <int NL>
__host__ __device__ __forceinline__ void pack(const uint32_t (&l)[NL],
                                              uint32_t (&w)[words(NL)]) {
#pragma unroll
  for (int k = 0; k < words(NL); ++k)
    w[k] = l[2 * k] | (2 * k + 1 < NL ? l[2 * k + 1] << 16 : 0u);
}

// NW words -> NL limbs of 16 bits
template <int NL>
__host__ __device__ __forceinline__ void unpack(const uint32_t (&w)[words(NL)],
                                                uint32_t (&l)[NL]) {
#pragma unroll
  for (int k = 0; k < words(NL); ++k) {
    l[2 * k] = w[k] & 0xFFFFu;
    if (2 * k + 1 < NL) l[2 * k + 1] = w[k] >> 16;
  }
}

// The NL limbs at src, src + stride, ... (the state's layout) as words
template <int NL>
__host__ __device__ __forceinline__ void load_words(const int32_t* src,
                                                    int64_t stride,
                                                    uint32_t (&w)[words(NL)]) {
  uint32_t l[NL];
#pragma unroll
  for (int j = 0; j < NL; ++j) l[j] = static_cast<uint32_t>(src[j * stride]);
  pack<NL>(l, w);
}

template <int NL>
__host__ __device__ __forceinline__ void store_words(
    int32_t* dst, int64_t stride, const uint32_t (&w)[words(NL)]) {
  uint32_t l[NL];
  unpack<NL>(w, l);
#pragma unroll
  for (int j = 0; j < NL; ++j) dst[j * stride] = static_cast<int32_t>(l[j]);
}

// v = a*b + x, by operand scanning. Each step a[i]*b[j] + v + carry is at
// most (2^32-1)^2 + 2*(2^32-1) = 2^64 - 1: exact in 64 bits. The sum is
// below 2^(64 NW), so v[2 NW] = 0.
template <int NW>
__host__ __device__ __forceinline__ void mul_add(const uint32_t (&a)[NW],
                                                 const uint32_t (&b)[NW],
                                                 const uint32_t (&x)[NW],
                                                 uint32_t (&v)[2 * NW + 1]) {
#pragma unroll
  for (int k = 0; k < 2 * NW + 1; ++k) v[k] = k < NW ? x[k] : 0u;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    uint32_t carry = 0;
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      const uint64_t t = static_cast<uint64_t>(a[i]) * b[j] + v[i + j] + carry;
      v[i + j] = static_cast<uint32_t>(t);
      carry = static_cast<uint32_t>(t >> 32);
    }
    v[i + NW] = carry;  // row i - 1 ended one word lower: still 0
  }
}

// v = a*b + c*d, two carry chains in one scan of the rows. Each chain's
// step is exact in 64 bits as in mul_add; a row's two carries and the bit
// the row before left in v[i + NW] sum below 2^33, so that word takes the
// low half and v[i + NW + 1] the high bit. The sum is below 2^(64 NW + 1):
// the carry-out word v[2 NW] is 0 or 1.
template <int NW>
__host__ __device__ __forceinline__ void mul_add2(const uint32_t (&a)[NW],
                                                  const uint32_t (&b)[NW],
                                                  const uint32_t (&c)[NW],
                                                  const uint32_t (&d)[NW],
                                                  uint32_t (&v)[2 * NW + 1]) {
#pragma unroll
  for (int k = 0; k < 2 * NW + 1; ++k) v[k] = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    uint32_t c1 = 0, c2 = 0;
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      const uint64_t t = static_cast<uint64_t>(a[i]) * b[j] + v[i + j] + c1;
      c1 = static_cast<uint32_t>(t >> 32);
      const uint64_t u = static_cast<uint64_t>(c[i]) * d[j] +
                         static_cast<uint32_t>(t) + c2;
      v[i + j] = static_cast<uint32_t>(u);
      c2 = static_cast<uint32_t>(u >> 32);
    }
    const uint64_t s = static_cast<uint64_t>(c1) + c2 + v[i + NW];
    v[i + NW] = static_cast<uint32_t>(s);
    v[i + NW + 1] = static_cast<uint32_t>(s >> 32);
  }
}

// r (N words) -= p*2^j where r >= p*2^j (0 <= j < 32; p*2^j < 2^(32 N))
template <int N>
__host__ __device__ __forceinline__ void sub_shifted_p(const Field& fd,
                                                       uint32_t (&r)[N],
                                                       int j) {
  uint32_t d[N];
  uint32_t borrow = 0;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    uint32_t pk = k < MAX_WORDS ? fd.pw[k] << j : 0u;
    if (j > 0 && k > 0 && k - 1 < MAX_WORDS) pk |= fd.pw[k - 1] >> (32 - j);
    const uint64_t t = static_cast<uint64_t>(r[k]) - pk - borrow;
    d[k] = static_cast<uint32_t>(t);
    borrow = static_cast<uint32_t>(t >> 63);
  }
  if (!borrow) {
#pragma unroll
    for (int k = 0; k < N; ++k) r[k] = d[k];
  }
}

// The fold form: v (2 NW + 1 words, any value) -> the canonical residue mod
// p in out.
//
// 1. Fold: V = lo + H*R == lo + H*F (mod p), lo the low 16 NL bits, while
//    H is not 0. F < p < R, so V strictly drops each round and the loop
//    ends; it tests H for zero rather than run a fixed count. For
//    secp256k1 (F = 2^32 + 977) and V < 2^513 at most three rounds run:
//    after one V < 2^291, after two V < 2^256 + 2^68, and a third only when
//    the low half after the first lies within 2^68 of 2^256. For 2^255 - 19
//    (F = 38) the same holds with 2^264 and 2^256 + 2^14, for 2^256 - 1053
//    with 2^268 and 2^256 + 2^23, for M61 (NL = 4, F = 8) with 2^68 and
//    2^64 + 2^7. At one limb (NL = 1, F = 2^16 mod p < 2^11) the loop
//    runs up to five rounds: for p = 64513 (F = 1023) V < 2^33 drops below
//    2^27, 2^21, 2^17, then 2^16 + 2^11 and then 2^16. A round sums lo and
//    the products of H's words by F's nonzero words in 64-bit columns
//    (each below 2^32 + 2^59, as F's words sum below 2^27: its 16-bit
//    digits sum below 2^11), then carries. For
//    an odd NL, R splits a word: H's words are read 16 bits apart. lo +
//    H*F < R + H*R <= V's own bound, so no column past v's words is
//    needed.
// 2. V < R <= p*2^(slack+1): subtract p*2^j where it fits, j = slack .. 0,
//    leaving V < p.
template <int NL>
__host__ __device__ __forceinline__ void reduce(
    const Field& fd, uint32_t (&v)[2 * words(NL) + 1],
    uint32_t (&out)[words(NL)]) {
  constexpr int NW = words(NL), NV = 2 * NW + 1;
  constexpr bool ODD = NL & 1;
  constexpr int B0 = ODD ? NW - 1 : NW;  // the word holding R's bit
  constexpr int NH = NV - B0;            // words of H
  for (;;) {
    uint32_t h[NH];
    uint32_t any = 0;
#pragma unroll
    for (int t = 0; t < NH; ++t) {
      h[t] = ODD ? (v[B0 + t] >> 16) |
                       (B0 + t + 1 < NV ? v[B0 + t + 1] << 16 : 0u)
                 : v[B0 + t];
      any |= h[t];
    }
    if (any == 0) break;
    uint64_t acc[NV];
#pragma unroll
    for (int k = 0; k < NV; ++k) acc[k] = k < NW ? v[k] : 0u;
    if (ODD) acc[NW - 1] &= 0xFFFFu;
#pragma unroll
    for (int i = 0; i < NW; ++i) {
      const uint32_t fi = fd.fw[i];
      if (fi != 0) {
#pragma unroll
        for (int t = 0; t < NH; ++t)
          if (i + t < NV) acc[i + t] += static_cast<uint64_t>(fi) * h[t];
      }
    }
    uint64_t c = 0;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      c += acc[k];
      v[k] = static_cast<uint32_t>(c);
      c >>= 32;
    }
  }
  uint32_t r[NW];
#pragma unroll
  for (int k = 0; k < NW; ++k) r[k] = v[k];
#pragma unroll 1
  for (int j = fd.slack; j >= 0; --j) sub_shifted_p(fd, r, j);
#pragma unroll
  for (int k = 0; k < NW; ++k) out[k] = r[k];
}

// The CIOS form: v (2 NW + 1 words) -> the canonical v*R^-1 mod p in out.
//
// Round i adds m*p, m = v[i]*n' mod 2^32, which clears word i, and so
// shifts by one word; the carry out of word i + NW waits in `top` for the
// next round's word i + NW + 1 (at most one bit). An odd NL's last round
// takes m mod 2^16, clearing the low half of word NW - 1, and the result
// is read 16 bits apart. For V < 2p^2 (a sum of two products of values
// below p) the result (V + M*p)/R, M < R, is below 2p^2/R + p < 3p (p <
// R), at most two bits past 16 NL: NW + 1 words, then subtract 2p and p
// where they fit. The shifts sum to 16 NL bits, so R = 2^(16 NL) whether
// NL is even or odd, as in the JAX package.
template <int NL>
__host__ __device__ __forceinline__ void redc(
    const Field& fd, uint32_t (&v)[2 * words(NL) + 1],
    uint32_t (&out)[words(NL)]) {
  constexpr int NW = words(NL);
  constexpr bool ODD = NL & 1;
  uint32_t top = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    const uint32_t m = ODD && i == NW - 1 ? (v[i] * fd.np16) & 0xFFFFu
                                          : v[i] * fd.np;
    uint32_t c = 0;
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      const uint64_t t = static_cast<uint64_t>(m) * fd.pw[j] + v[i + j] + c;
      v[i + j] = static_cast<uint32_t>(t);
      c = static_cast<uint32_t>(t >> 32);
    }
    const uint64_t s = static_cast<uint64_t>(v[i + NW]) + c + top;
    v[i + NW] = static_cast<uint32_t>(s);
    top = static_cast<uint32_t>(s >> 32);
  }
  v[2 * NW] += top;
  uint32_t r[NW + 1];
#pragma unroll
  for (int k = 0; k <= NW; ++k)
    r[k] = ODD ? (v[NW - 1 + k] >> 16) | (v[NW + k] << 16) : v[NW + k];
  sub_shifted_p(fd, r, 1);
  sub_shifted_p(fd, r, 0);
#pragma unroll
  for (int k = 0; k < NW; ++k) out[k] = r[k];
}

// out = a + b mod p for canonical a, b (out may be a or b)
template <int NW>
__host__ __device__ __forceinline__ void add_mod(const Field& fd,
                                                 const uint32_t (&a)[NW],
                                                 const uint32_t (&b)[NW],
                                                 uint32_t (&out)[NW]) {
  uint32_t s[NW + 1];
  uint64_t c = 0;
#pragma unroll
  for (int k = 0; k < NW; ++k) {
    c += static_cast<uint64_t>(a[k]) + b[k];
    s[k] = static_cast<uint32_t>(c);
    c >>= 32;
  }
  s[NW] = static_cast<uint32_t>(c);
  sub_shifted_p(fd, s, 0);
#pragma unroll
  for (int k = 0; k < NW; ++k) out[k] = s[k];
}

// The three functions of the kernels, canonical in, canonical out (out may
// alias any input). In the CIOS form every value is in Montgomery form and
// each product is a Montgomery product; x joins after the reduction with
// one conditional subtract, as in the JAX package's aff1 tile. In the fold
// form x joins the product before the reduction.

// out = x + a*b mod p
template <int NL, bool MONT>
__host__ __device__ __forceinline__ void fma1(const Field& fd,
                                              const uint32_t (&a)[words(NL)],
                                              const uint32_t (&b)[words(NL)],
                                              const uint32_t (&x)[words(NL)],
                                              uint32_t (&out)[words(NL)]) {
  constexpr int NW = words(NL);
  uint32_t v[2 * NW + 1];
  if (MONT) {
    const uint32_t zero[NW] = {};
    uint32_t r[NW];
    mul_add<NW>(a, b, zero, v);
    redc<NL>(fd, v, r);
    add_mod<NW>(fd, r, x, out);
  } else {
    mul_add<NW>(a, b, x, v);
    reduce<NL>(fd, v, out);
  }
}

// out = a*b + c*d mod p
template <int NL, bool MONT>
__host__ __device__ __forceinline__ void fma2(const Field& fd,
                                              const uint32_t (&a)[words(NL)],
                                              const uint32_t (&b)[words(NL)],
                                              const uint32_t (&c)[words(NL)],
                                              const uint32_t (&d)[words(NL)],
                                              uint32_t (&out)[words(NL)]) {
  constexpr int NW = words(NL);
  uint32_t v[2 * NW + 1];
  mul_add2<NW>(a, b, c, d, v);
  if (MONT)
    redc<NL>(fd, v, out);
  else
    reduce<NL>(fd, v, out);
}

// out = a*b mod p
template <int NL, bool MONT>
__host__ __device__ __forceinline__ void mul(const Field& fd,
                                             const uint32_t (&a)[words(NL)],
                                             const uint32_t (&b)[words(NL)],
                                             uint32_t (&out)[words(NL)]) {
  constexpr int NW = words(NL);
  const uint32_t zero[NW] = {};
  uint32_t v[2 * NW + 1];
  mul_add<NW>(a, b, zero, v);
  if (MONT)
    redc<NL>(fd, v, out);
  else
    reduce<NL>(fd, v, out);
}

}  // namespace wa

#ifdef ECFFT_NL
// The form a kernel library is compiled for
constexpr int NL = ECFFT_NL;         // 16-bit limbs per element (the state's)
constexpr int NW = wa::words(NL);    // 32-bit words per element
constexpr bool MONT = ECFFT_MONT;    // the CIOS form (else the fold form)
static_assert(NL >= 1 && NL <= 16, "1 to 16 limbs");
static_assert(NL >= 2 || !MONT, "one limb takes the fold form only");
#endif
