// The unrolled executor's fused butterfly levels, for Hopper (sm_90a).
//
// Each kernel updates the window [start, start + A) of a (W, L, B) int32
// state of 16-bit limbs in place, pairing row t with row t ^ h:
//
//   ecfft_fused_bf1      x[t] <- x[t] + C[t]*x[t^h]          one level,
//                        h >= TW; replaces _fused_bf1
//                        (ecfft_tpu/ops/unrolled.py:272)
//   ecfft_fused_bf2      x[t] <- A[t]*x[t] + B[t]*x[t^h]     the same, 2-mul
//                        form; replaces _fused_bf2 (unrolled.py:345)
//   ecfft_fused_cascade  k consecutive levels of either form, each h < TW,
//                        on each TW-row tile; replaces _fused_cascade
//                        (unrolled.py:200)
//
// with (A, L) coefficient rows per level indexed by the window row t -
// start. The field arithmetic is field_arith.cuh's.
//
// What bounds it on the H100. A pair level reads each window row once and
// writes it once: 128 bytes per element, 2.15 GB at (A 65536, B 256), 0.64
// ms at 3.35 TB/s. It runs the multiply-adds and reductions of an aff1
// (aff2) step per element: a thread issues about 2250 (bf1) and 3040
// (bf2) instructions for its two elements, 0.56 and 0.76 ms at 132 SMs x
// 128 issue lanes x 1.98 GHz. So bf1 is bound by the bytes, bf2 by the
// issue rate. A cascade moves the same 128 bytes per element plus 64
// bytes of coefficients per row and level, for up to 14 levels of that
// arithmetic (about 950 instructions per element per 1-mul level): it is
// bound by the issue rate, ten times over the bytes.
//
// The designs. Pair levels: one thread per (pair, lane). It loads both
// elements of its pair (stride B, so a warp's loads are coalesced across
// lanes), computes the two new values one after the other (one set of 32
// product columns live at a time) and stores both. Each element is read and
// written by exactly one thread, so the in-place update is race-free: the
// pairs partition the window. The partner is the global xor t ^ h, which the
// wrapper checks lands at t + h (start % 2h == 0). Cascades: one block per
// (tile of TW <= 128 rows, group of CL = 4 lanes), the tile in shared
// memory for the whole run. Per level each thread computes its elements from
// its row and row r ^ h, all threads synchronise, write, and synchronise
// again. The tile goes in from device memory once and out once per run;
// each level's coefficient rows come from device memory (a broadcast to
// the lanes of a row). A tile row is padded by CL words so that a warp's
// eight rows fall on distinct banks.
//
// The kernels allocate nothing and launch on the caller's stream; each
// launcher returns cudaGetLastError() (or cudaErrorInvalidValue for
// parameters it cannot take) so a refused launch is reported.

#include <cuda_runtime.h>

#include "field_arith.cuh"

constexpr int BF_THREADS = 256;
constexpr int CT = 256;                    // cascade threads per block
constexpr int CL = 4;                      // lanes per cascade block
constexpr int MAX_TW = 128;                // largest cascade tile
constexpr int EPT = MAX_TW * CL / CT;      // cascade elements per thread
constexpr int RS = NL * CL + CL;           // shared words per tile row
constexpr int MAX_LEVELS = 16;             // cascade levels per launch

// A cascade's levels, passed by value (the layout of unrolled.py's
// _Levels): the xor distance of each level and its form (0: 1-mul, 1:
// 2-mul reading the next row of the A coefficients).
struct Levels {
  int k;
  int half[MAX_LEVELS];
  int kind[MAX_LEVELS];
};

namespace {

__device__ __forceinline__ void load_el(const int32_t* p, int B,
                                        uint32_t (&x)[NL]) {
#pragma unroll
  for (int j = 0; j < NL; ++j) x[j] = static_cast<uint32_t>(p[j * B]);
}

__device__ __forceinline__ void store_el(int32_t* p, int B,
                                         const uint32_t (&x)[NL]) {
#pragma unroll
  for (int j = 0; j < NL; ++j) p[j * B] = static_cast<int32_t>(x[j]);
}

// out = x + c*xp (1-mul), or a*x + c*xp (2-mul)
__device__ __forceinline__ void update(const Field& fd, bool two,
                                       const int32_t* __restrict__ a,
                                       const int32_t* __restrict__ c,
                                       const uint32_t (&x)[NL],
                                       const uint32_t (&xp)[NL],
                                       uint32_t (&out)[NL]) {
  uint64_t col[2 * NL];
  zero_cols(col);
  mac_r(col, c, xp);
  if (two) {
    mac_r(col, a, x);
  } else {
#pragma unroll
    for (int j = 0; j < NL; ++j) col[j] += x[j];
  }
  reduce(fd, col, out);
}

template <bool TWO>
__global__ void __launch_bounds__(BF_THREADS)
bf_kernel(Field fd, const int32_t* __restrict__ aw,
          const int32_t* __restrict__ cw, int32_t* state, int start,
          int half, int A, int B) {
  const int64_t e =
      static_cast<int64_t>(blockIdx.x) * BF_THREADS + threadIdx.x;
  if (e >= static_cast<int64_t>(A / 2) * B) return;  // the ragged edge
  const int64_t i = e / B;                 // the pair
  const int64_t b = e - i * B;             // the lane
  const int64_t rt = (i / half) * 2 * half + i % half;  // window row of t
  const int64_t t = start + rt;
  const int64_t rp = (t ^ half) - start;   // window row of the partner
  const int64_t LB = static_cast<int64_t>(NL) * B;
  int32_t* pt = state + t * LB + b;
  int32_t* pp = state + (start + rp) * LB + b;
  uint32_t xt[NL], xp[NL], res[NL];
  load_el(pt, B, xt);
  load_el(pp, B, xp);
  update(fd, TWO, aw + rt * NL, cw + rt * NL, xt, xp, res);
  store_el(pt, B, res);
  update(fd, TWO, aw + rp * NL, cw + rp * NL, xp, xt, res);
  store_el(pp, B, res);
}

__global__ void __launch_bounds__(CT)
cascade_kernel(Field fd, Levels lv, const int32_t* __restrict__ cw,
               const int32_t* __restrict__ aw, int32_t* state, int start,
               int tw, int A, int B) {
  __shared__ uint32_t tile[MAX_TW * RS];
  const int groups = (B + CL - 1) / CL;
  const int g = blockIdx.x / groups;       // the tile within the window
  const int b0 = (blockIdx.x - g * groups) * CL;
  const int64_t LB = static_cast<int64_t>(NL) * B;
  int32_t* base = state + (start + static_cast<int64_t>(g) * tw) * LB + b0;
  const int tid = threadIdx.x;
  const int words = tw * NL * CL;
  // in: consecutive threads take consecutive lanes, then limbs, then rows
  for (int w = tid; w < words; w += CT) {
    const int l = w % CL, j = (w / CL) % NL, r = w / (CL * NL);
    tile[r * RS + j * CL + l] =
        b0 + l < B ? static_cast<uint32_t>(base[r * LB + j * B + l]) : 0u;
  }
  __syncthreads();
  int ai = 0;
  for (int li = 0; li < lv.k; ++li) {
    const int h = lv.half[li];
    const bool two = lv.kind[li] != 0;
    uint32_t res[EPT][NL];
#pragma unroll
    for (int s = 0; s < EPT; ++s) {
      const int e = tid + s * CT;
      if (e < tw * CL) {
        const int r = e / CL, l = e % CL;
        uint32_t x[NL], xp[NL];
#pragma unroll
        for (int j = 0; j < NL; ++j) {
          x[j] = tile[r * RS + j * CL + l];
          xp[j] = tile[(r ^ h) * RS + j * CL + l];
        }
        const int64_t q = static_cast<int64_t>(g) * tw + r;  // window row
        const int32_t* c = cw + (static_cast<int64_t>(li) * A + q) * NL;
        const int32_t* a = aw + (static_cast<int64_t>(ai) * A + q) * NL;
        update(fd, two, a, c, x, xp, res[s]);
      }
    }
    __syncthreads();
#pragma unroll
    for (int s = 0; s < EPT; ++s) {
      const int e = tid + s * CT;
      if (e < tw * CL) {
        const int r = e / CL, l = e % CL;
#pragma unroll
        for (int j = 0; j < NL; ++j) tile[r * RS + j * CL + l] = res[s][j];
      }
    }
    __syncthreads();
    ai += two;
  }
  for (int w = tid; w < words; w += CT) {
    const int l = w % CL, j = (w / CL) % NL, r = w / (CL * NL);
    if (b0 + l < B)
      base[r * LB + j * B + l] =
          static_cast<int32_t>(tile[r * RS + j * CL + l]);
  }
}

template <bool TWO>
int launch_bf(const Field* fd, const int32_t* a, const int32_t* c,
              int32_t* state, int start, int half, int A, int B,
              void* stream) {
  if (half <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t n = static_cast<int64_t>(A / 2) * B;
  const unsigned blocks =
      static_cast<unsigned>((n + BF_THREADS - 1) / BF_THREADS);
  bf_kernel<TWO><<<blocks, BF_THREADS, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      *fd, a, c, state, start, half, A, B);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int ecfft_fused_bf1(const Field* fd, const int32_t* c, int32_t* state,
                    int start, int half, int A, int B, void* stream) {
  // the 1-mul form reads no A row; c stands in for it unread
  return launch_bf<false>(fd, c, c, state, start, half, A, B, stream);
}

int ecfft_fused_bf2(const Field* fd, const int32_t* a, const int32_t* b,
                    int32_t* state, int start, int half, int A, int B,
                    void* stream) {
  return launch_bf<true>(fd, a, b, state, start, half, A, B, stream);
}

int ecfft_fused_cascade(const Field* fd, const Levels* lv, const int32_t* c,
                        const int32_t* a, int32_t* state, int start, int tw,
                        int A, int B, void* stream) {
  if (lv->k < 1 || lv->k > MAX_LEVELS || tw < 2 || tw > MAX_TW ||
      A % tw != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks =
      static_cast<int64_t>(A / tw) * ((B + CL - 1) / CL);
  cascade_kernel<<<static_cast<unsigned>(blocks), CT, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      *fd, *lv, c, a, state, start, tw, A, B);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
