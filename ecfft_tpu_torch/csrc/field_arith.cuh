// Field arithmetic on 16-bit limbs, for the port's CUDA kernels that
// word_arith.cuh does not serve yet (step_kernel<1>/<2> in
// step_kernels.cu): 16-limb elements of 16 bits for a fold-friendly prime.
//
// An element is NL = 16 limbs held in 32-bit words. A product of two
// elements is 32 columns of 64 bits (each below 2*16*2^32), filled by
// multiply-adds with no carries inside the loop; reduce() carries them,
// folds the high half back with F = 2^(16*NL) mod p and subtracts p*2^j
// where it fits, leaving the canonical residue. This computes what
// _conv_accum, _make_helpers and aff1_tile/aff2_tile compute
// (ecfft_tpu/ops/pallas_step.py:45-211); any exact reduction to the
// canonical residue gives the same bits.

#pragma once

#include <cstdint>

#include "word_arith.cuh"  // NL and struct Field, shared with the word kernels

constexpr int NC = 2 * NL + 1;  // limbs of an unreduced sum of products

namespace {

// Product columns (each below 2^37) -> the canonical residue mod p.
__device__ __forceinline__ void reduce(const Field& fd,
                                       const uint64_t (&col)[2 * NL],
                                       uint32_t (&out)[NL]) {
  // 1. carry the columns into 33 limbs of 16 bits (the value < 2^514)
  uint32_t x[NC];
  uint64_t c = 0;
#pragma unroll
  for (int k = 0; k < 2 * NL; ++k) {
    c += col[k];
    x[k] = static_cast<uint32_t>(c) & 0xFFFFu;
    c >>= 16;
  }
  x[2 * NL] = static_cast<uint32_t>(c);
  // 2. fold: V = lo + H*2^(16*NL) == lo + H*F (mod p). F < 2^(16*NL), so V
  // strictly drops while H != 0; for secp256k1 (F = 2^32 + 977) at most
  // three rounds run. Every acc stays below 2^16 + 2^16*2^10.
  for (;;) {
    uint32_t hi = 0;
#pragma unroll
    for (int k = NL; k < NC; ++k) hi |= x[k];
    if (hi == 0) break;
    uint32_t acc[NC];
#pragma unroll
    for (int k = 0; k < NC; ++k) acc[k] = k < NL ? x[k] : 0u;
#pragma unroll
    for (int i = 0; i < NL; ++i) {
      const uint32_t fi = fd.f[i];
      if (fi != 0) {
#pragma unroll
        for (int t = 0; t <= NL; ++t) acc[i + t] += x[NL + t] * fi;
      }
    }
    uint32_t cc = 0;
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      cc += acc[k];
      x[k] = cc & 0xFFFFu;
      cc >>= 16;
    }
  }
  // 3. V < 2^(16*NL) <= p*2^(slack+1): subtract p*2^j where it fits,
  // j = slack .. 0, leaving V < p
#pragma unroll 1
  for (int j = fd.slack; j >= 0; --j) {
    uint32_t d[NL];
    int32_t borrow = 0;
#pragma unroll
    for (int k = 0; k < NL; ++k) {
      uint32_t pk = (fd.p[k] << j) & 0xFFFFu;
      if (k > 0) pk |= fd.p[k - 1] >> (16 - j);
      const int32_t v = static_cast<int32_t>(x[k]) -
                        static_cast<int32_t>(pk) - borrow;
      d[k] = static_cast<uint32_t>(v) & 0xFFFFu;
      borrow = v < 0;
    }
    if (!borrow) {
#pragma unroll
      for (int k = 0; k < NL; ++k) x[k] = d[k];
    }
  }
#pragma unroll
  for (int k = 0; k < NL; ++k) out[k] = x[k];
}

// col += coeff row (NL limbs at cq) x window element (NL limbs, stride B)
__device__ __forceinline__ void mac(uint64_t (&col)[2 * NL],
                                    const int32_t* __restrict__ cq,
                                    const int32_t* __restrict__ xw,
                                    int B) {
  uint32_t c[NL];
#pragma unroll
  for (int i = 0; i < NL; ++i) c[i] = static_cast<uint32_t>(__ldg(cq + i));
#pragma unroll
  for (int j = 0; j < NL; ++j) {
    const uint32_t xj = static_cast<uint32_t>(__ldg(xw + j * B));
#pragma unroll
    for (int i = 0; i < NL; ++i)
      col[i + j] += static_cast<uint64_t>(c[i]) * xj;
  }
}

}  // namespace
