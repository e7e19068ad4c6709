// The schedule machine's three in-place affine steps, for Hopper (sm_90a).
//
// Each kernel updates the window [start, start + A) of a (W, L, B) int32
// state of 16-bit limbs in place, for a fold-friendly prime with L = 16:
//
//   ecfft_aff1s_ip  state[s+q] <- state[s+q] + C[q]*x2[q]   replaces
//                   pallas_aff1s_ip (ecfft_tpu/ops/pallas_step.py:298)
//   ecfft_aff1g_ip  state[s+q] <- x1[q] + C[q]*x2[q]         replaces
//                   pallas_aff1g_ip (pallas_step.py:311)
//   ecfft_aff2g_ip  state[s+q] <- A[q]*x1[q] + B[q]*x2[q]    replaces
//                   pallas_aff2g_ip (pallas_step.py:324)
//
// with C/A/B (A, L) coefficient rows and x1, x2 (A, L, B) gathered windows
// in buffers of their own. The shared field arithmetic (product columns,
// pseudo-Mersenne fold, canonical subtract) computes what _conv_accum,
// _make_helpers and aff1_tile/aff2_tile compute (pallas_step.py:45-211);
// any exact reduction to the canonical residue gives the same bits.
//
// What bounds it on the H100. Per output element an aff1 step moves 192
// bytes (16 limbs each of x2 and x1 in, 16 out) and issues 256 32x32->64-
// bit multiply-adds plus some 250 carry and fold ops; aff2 moves 256 bytes
// for twice the multiplies. That is 4-6 integer ops per byte, about the
// card's own balance (some 17 T 32-bit integer ops/s, 132 SMs x 64 lanes
// x ~2 GHz, against 3.35 TB/s): both the integer pipe and the memory
// bound matter, and the separate gathers add 128 bytes per element of
// pure movement.
//
// The simple design: one thread per output element (q, b). In the batch-
// minor layout neighbouring threads of a warp are neighbouring lanes b, so
// each limb load and store is one coalesced 128-byte line; the coefficient
// row of q is the same address for the whole warp (a broadcast). The 32
// product columns live in 64-bit registers (each is below 2*16*2^32), so
// the multiply-adds need no carries inside the loop. A later design would
// pack the limbs into 8 x 32-bit words (a quarter of the multiplies) and
// fuse the gathers; the gathered windows stay separate buffers here
// because the in-place write races with a fused gather's butterfly
// partner.
//
// The kernels allocate nothing and launch on the caller's stream; each
// launcher returns cudaGetLastError() so a refused launch is reported.

#include <cstdint>
#include <cuda_runtime.h>

constexpr int NL = 16;          // limbs per element, 16 bits each
constexpr int NC = 2 * NL + 1;  // limbs of an unreduced sum of products
constexpr int THREADS = 256;

// The field's constants, passed by value as a kernel parameter (the
// layout of step.py's _Field).
struct Field {
  uint32_t p[NL];  // p's 16-bit limbs
  uint32_t f[NL];  // limbs of F = 2^(16*NL) mod p; they sum below 2^10
  int slack;       // 16*NL - bit length of p
};

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

// KIND 0: x1 is the state element itself (aff1s); 1: gathered x1 (aff1g);
// 2: A*x1 + B*x2 (aff2g).
template <int KIND>
__global__ void __launch_bounds__(THREADS)
step_kernel(Field fd, const int32_t* __restrict__ ca,
            const int32_t* __restrict__ cb, int32_t* state,
            const int32_t* __restrict__ x1, const int32_t* __restrict__ x2,
            int start, int A, int B) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  if (e >= static_cast<int64_t>(A) * B) return;  // the ragged edge
  const int64_t q = e / B;
  const int64_t b = e - q * B;
  const int64_t LB = static_cast<int64_t>(NL) * B;
  int32_t* st = state + (start + q) * LB + b;
  uint64_t col[2 * NL];
#pragma unroll
  for (int k = 0; k < 2 * NL; ++k) col[k] = 0;
  mac(col, cb + q * NL, x2 + q * LB + b, B);
  if (KIND == 2) {
    mac(col, ca + q * NL, x1 + q * LB + b, B);
  } else {
    const int32_t* w1 = KIND == 0 ? st : x1 + q * LB + b;
#pragma unroll
    for (int j = 0; j < NL; ++j) col[j] += static_cast<uint32_t>(w1[j * B]);
  }
  uint32_t out[NL];
  reduce(fd, col, out);
#pragma unroll
  for (int j = 0; j < NL; ++j) st[j * B] = static_cast<int32_t>(out[j]);
}

template <int KIND>
int launch(const Field* fd, const int32_t* ca, const int32_t* cb,
           int32_t* state, const int32_t* x1, const int32_t* x2, int start,
           int A, int B, void* stream) {
  const int64_t n = static_cast<int64_t>(A) * B;
  const unsigned blocks = static_cast<unsigned>((n + THREADS - 1) / THREADS);
  step_kernel<KIND><<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      *fd, ca, cb, state, x1, x2, start, A, B);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int ecfft_aff1s_ip(const Field* fd, const int32_t* c, const int32_t* x2,
                   int32_t* state, int start, int A, int B, void* stream) {
  return launch<0>(fd, nullptr, c, state, nullptr, x2, start, A, B, stream);
}

int ecfft_aff1g_ip(const Field* fd, const int32_t* c, const int32_t* x1,
                   const int32_t* x2, int32_t* state, int start, int A,
                   int B, void* stream) {
  return launch<1>(fd, nullptr, c, state, x1, x2, start, A, B, stream);
}

int ecfft_aff2g_ip(const Field* fd, const int32_t* a, const int32_t* b,
                   const int32_t* x1, const int32_t* x2, int32_t* state,
                   int start, int A, int B, void* stream) {
  return launch<2>(fd, a, b, state, x1, x2, start, A, B, stream);
}

const char* ecfft_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
