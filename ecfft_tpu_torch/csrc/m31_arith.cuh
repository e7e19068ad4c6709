// Field arithmetic mod M31 = 2^31 - 1, one 32-bit word an element, for
// the M31 kernels (m31_kernels.cu).
//
// An element is canonical, below 2^31, stored in an int32 and read as a
// uint32. A product of two is one 32x32->64-bit multiply (IMAD.WIDE.U32)
// below 2^62; the sum of two products, or of a product and an element,
// stays below 2^63 and is reduced once. The reduction folds with
// 2^31 == 1 (mod p) twice and subtracts p at most once, so every function
// returns the canonical residue: the same bits as the JAX package's
// _m31_mul / _m31_add (16-bit splits), whatever the order of operations.
//
// Plain C++ for host and device, as word_arith.cuh: nvcc compiles it for
// the card; g++ compiles the same header on the CPU, where
// tests/test_torch_word_arith.py holds it against Python integers.

#pragma once

#include <cstdint>

#ifndef __CUDACC__
#define __host__
#define __device__
#define __forceinline__ inline
#endif

namespace m31 {

constexpr uint32_t P = 0x7FFFFFFFu;

// t (below 2^64) -> t mod p. After the first fold t < 2^31 + 2^33, after
// the second t < 2^31 + 8 = p + 9, so one conditional subtract ends it.
__host__ __device__ __forceinline__ uint32_t reduce(uint64_t t) {
  t = (t & P) + (t >> 31);
  t = (t & P) + (t >> 31);
  const uint32_t r = static_cast<uint32_t>(t);
  return r >= P ? r - P : r;
}

// a + b mod p for canonical a, b (the sum is below 2^32)
__host__ __device__ __forceinline__ uint32_t add(uint32_t a, uint32_t b) {
  const uint32_t s = a + b;
  return s >= P ? s - P : s;
}

// a * b mod p
__host__ __device__ __forceinline__ uint32_t mul(uint32_t a, uint32_t b) {
  return reduce(static_cast<uint64_t>(a) * b);
}

// c * y + x mod p: one product, one reduction
__host__ __device__ __forceinline__ uint32_t mul_add(uint32_t c, uint32_t y,
                                                     uint32_t x) {
  return reduce(static_cast<uint64_t>(c) * y + x);
}

// a * x + b * y mod p: two products summed in 64 bits, one reduction
__host__ __device__ __forceinline__ uint32_t mul_add2(uint32_t a, uint32_t x,
                                                      uint32_t b,
                                                      uint32_t y) {
  return reduce(static_cast<uint64_t>(a) * x + static_cast<uint64_t>(b) * y);
}

}  // namespace m31
