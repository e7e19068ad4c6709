// Field arithmetic on 32-bit words, for the kernels redesigned for Hopper
// (aff1s_kernel in step_kernels.cu, pair_kernel and cascade_kernel in
// fused_kernels.cu).
//
// The state keeps an element as NL = 16 limbs of 16 bits, one per int32
// (the layout every kernel shares). These functions pack it into NW = 8
// words of 32 bits, form a product (or a sum of two) with 32x32->64-bit
// multiply-adds, 64 per product where the 16-bit limbs of field_arith.cuh
// take 256, and reduce the result to the canonical residue mod p, for the
// same fold-friendly primes field_arith.cuh takes (16 limbs, the 16-bit
// digits of F = 2^256 mod p summing below 2^10). The canonical residue is
// unique, so the outputs carry the same bits as field_arith.cuh's.
//
// Every function is plain C++ for host and device: no intrinsics, no
// inline PTX. nvcc compiles it for the card; g++ compiles the very same
// header on the CPU, where tests/test_torch_word_arith.py holds it against
// Python integers.

#pragma once

#include <cstdint>

#ifndef __CUDACC__
#define __host__
#define __device__
#define __forceinline__ inline
#endif

constexpr int NL = 16;          // 16-bit limbs per element (the state's)
constexpr int NW = 8;           // 32-bit words per element
constexpr int NV = 2 * NW + 1;  // words of an unreduced sum of two products

// The field's constants, passed by value as a kernel parameter (the
// layout of ops/step.py's _Field). field_arith.cuh reads p, f and slack;
// this header reads pw, fw and slack.
struct Field {
  uint32_t p[NL];   // p's 16-bit limbs
  uint32_t f[NL];   // F's 16-bit limbs; they sum below 2^10
  int slack;        // 256 - bit length of p
  uint32_t pw[NW];  // p's 32-bit words
  uint32_t fw[NW];  // F's 32-bit words; they sum below 2^26
};

namespace wa {

// 16 limbs of 16 bits -> 8 words
__host__ __device__ __forceinline__ void pack(const uint32_t (&l)[NL],
                                              uint32_t (&w)[NW]) {
#pragma unroll
  for (int k = 0; k < NW; ++k) w[k] = l[2 * k] | l[2 * k + 1] << 16;
}

// 8 words -> 16 limbs of 16 bits
__host__ __device__ __forceinline__ void unpack(const uint32_t (&w)[NW],
                                                uint32_t (&l)[NL]) {
#pragma unroll
  for (int k = 0; k < NW; ++k) {
    l[2 * k] = w[k] & 0xFFFFu;
    l[2 * k + 1] = w[k] >> 16;
  }
}

// The 16 limbs at src, src + stride, ... (the state's layout) as words
__host__ __device__ __forceinline__ void load_words(const int32_t* src,
                                                    int64_t stride,
                                                    uint32_t (&w)[NW]) {
  uint32_t l[NL];
#pragma unroll
  for (int j = 0; j < NL; ++j) l[j] = static_cast<uint32_t>(src[j * stride]);
  pack(l, w);
}

__host__ __device__ __forceinline__ void store_words(int32_t* dst,
                                                     int64_t stride,
                                                     const uint32_t (&w)[NW]) {
  uint32_t l[NL];
  unpack(w, l);
#pragma unroll
  for (int j = 0; j < NL; ++j) dst[j * stride] = static_cast<int32_t>(l[j]);
}

// v = a*b + x, by operand scanning. Each step a[i]*b[j] + v + carry is at
// most (2^32-1)^2 + 2*(2^32-1) = 2^64 - 1: exact in 64 bits. The sum is
// below (2^256-1)^2 + 2^256 < 2^512, so v[16] = 0.
__host__ __device__ __forceinline__ void mul_add(const uint32_t (&a)[NW],
                                                 const uint32_t (&b)[NW],
                                                 const uint32_t (&x)[NW],
                                                 uint32_t (&v)[NV]) {
#pragma unroll
  for (int k = 0; k < NV; ++k) v[k] = k < NW ? x[k] : 0u;
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
// low half and v[i + NW + 1] the high bit. The sum is below
// 2*(2^256-1)^2 < 2^513: the carry-out word v[16] is 0 or 1.
__host__ __device__ __forceinline__ void mul_add2(const uint32_t (&a)[NW],
                                                  const uint32_t (&b)[NW],
                                                  const uint32_t (&c)[NW],
                                                  const uint32_t (&d)[NW],
                                                  uint32_t (&v)[NV]) {
#pragma unroll
  for (int k = 0; k < NV; ++k) v[k] = 0;
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

// v (17 words, any value) -> the canonical residue mod p in out.
//
// 1. Fold: V = lo + H*2^256 == lo + H*F (mod p), while H (words 8..16) is
//    not 0. F < 2^256, so V strictly drops each round and the loop ends;
//    it tests H for zero rather than run a fixed count. For secp256k1
//    (F = 2^32 + 977) and V < 2^513 at most three rounds run: after one V
//    < 2^291, after two V < 2^256 + 2^68, and a third only when the low
//    half after the first lies within 2^68 of 2^256. For 2^255 - 19 (F =
//    38) the same holds with 2^264 and 2^256 + 2^14. A round sums lo and
//    the products of H's words by F's nonzero words in 64-bit columns
//    (each below 2^32 + 2^58, as F's words sum below 2^26), then carries.
// 2. V < 2^256 <= p*2^(slack+1): subtract p*2^j where it fits, j = slack
//    .. 0, leaving V < p.
__host__ __device__ __forceinline__ void reduce(const Field& fd,
                                                uint32_t (&v)[NV],
                                                uint32_t (&out)[NW]) {
  for (;;) {
    uint32_t hi = 0;
#pragma unroll
    for (int k = NW; k < NV; ++k) hi |= v[k];
    if (hi == 0) break;
    uint64_t acc[NV];
#pragma unroll
    for (int k = 0; k < NV; ++k) acc[k] = k < NW ? v[k] : 0u;
#pragma unroll
    for (int i = 0; i < NW; ++i) {
      const uint32_t fi = fd.fw[i];
      if (fi != 0) {
#pragma unroll
        for (int t = 0; t <= NW; ++t)
          acc[i + t] += static_cast<uint64_t>(fi) * v[NW + t];
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
#pragma unroll 1
  for (int j = fd.slack; j >= 0; --j) {
    uint32_t d[NW];
    uint32_t borrow = 0;
#pragma unroll
    for (int k = 0; k < NW; ++k) {
      uint32_t pk = fd.pw[k] << j;
      if (j > 0 && k > 0) pk |= fd.pw[k - 1] >> (32 - j);
      const uint64_t t = static_cast<uint64_t>(v[k]) - pk - borrow;
      d[k] = static_cast<uint32_t>(t);
      borrow = static_cast<uint32_t>(t >> 63);
    }
    if (!borrow) {
#pragma unroll
      for (int k = 0; k < NW; ++k) v[k] = d[k];
    }
  }
#pragma unroll
  for (int k = 0; k < NW; ++k) out[k] = v[k];
}

}  // namespace wa
