// The nine kernels' M31 forms (p = 2^31 - 1), for Hopper (sm_90a).
//
// The state is (W, 1, B) int32: one canonical 32-bit word an element, the
// lanes of a row contiguous. Each entry point takes the arguments of its
// sibling in the word forms (step_kernels.cu, fused_kernels.cu) without
// the field's constants, since p is a compile-time constant here
// (m31_arith.cuh):
//
//   ecfft_m31_aff1s_ip  state[s+q] <- state[s+q] + C[q]*x2[q]   replaces
//                       pallas_aff1s_ip (ecfft_tpu/ops/pallas_step.py:299)
//   ecfft_m31_aff1g_ip  state[s+q] <- x1[q] + C[q]*x2[q]         replaces
//                       pallas_aff1g_ip (pallas_step.py:312)
//   ecfft_m31_aff2g_ip  state[s+q] <- A[q]*x1[q] + B[q]*x2[q]    replaces
//                       pallas_aff2g_ip (pallas_step.py:325)
//   ecfft_m31_muladd1   out[s+q] <- x1[q] + C[q]*x2[q]           replaces
//                       pallas_muladd1 (pallas_step.py:339)
//   ecfft_m31_muladd2   out[s+q] <- A[q]*x1[q] + B[q]*x2[q]      replaces
//                       pallas_muladd2 (pallas_step.py:365)
//   ecfft_m31_mulss     out[s+q] <- x1[q]*x2[q]                  replaces
//                       _mulss (ecfft_tpu/ops/schedule.py:1357), which the
//                       TPU leaves to XLA
//   ecfft_m31_fused_bf1 x[t] <- x[t] + C[t]*x[t^h], h >= TW      replaces
//                       _fused_bf1 (ecfft_tpu/ops/unrolled.py:273) with
//                       _m31_aff1_tile (:170)
//   ecfft_m31_fused_bf2 x[t] <- A[t]*x[t] + B[t]*x[t^h]          replaces
//                       _fused_bf2 (unrolled.py:346) with _m31_aff2_tile
//                       (:174)
//   ecfft_m31_fused_cascade  k in-tile levels of either form     replaces
//                       _fused_cascade (unrolled.py:201) with the M31 tiles
//
// On the TPU the six steps of M31 ran in XLA (the Pallas steps need more
// than one limb); the fused levels ran in Pallas with the M31 tiles.
//
// What bounds it on the H100. An element is 4 bytes and its work one or two
// 32x32->64-bit products and a few adds, shifts and compares. A step moves
// 12 bytes per element (x2 and x1 or the state's own element in, one word
// out; a coefficient row is one word per row, read once): 1.61 GB at
// (A 65536, B 2048), 0.48 ms at 3.35 TB/s, against 0.008 ms of products at
// the IMAD.WIDE rate. A pair level moves 8 bytes per element, a cascade 8
// for all its levels. So every form is bound by its bytes, and its design
// is about coalesced access and enough warps in flight.
//
// The designs, three templates for the nine entry points:
// - m31_step_kernel<KIND>: one thread per element. A block of 256 threads
//   holds `lanes` neighbouring lanes (the smallest power of two >= B, at
//   most 256) of 256 / lanes rows, so a warp's loads and stores are
//   contiguous words of one row, and a one-lane batch (the D-engine's row
//   products, B = 1) still fills its blocks. Each thread reads the words it
//   needs, then writes its one element, so the in-place write is race-free
//   whenever x1 is either a buffer of its own or the very window written
//   (OP_AFF1S); x2 never overlaps it; mulss's two factors may be one buffer.
// - m31_pair_kernel<TWO>: one thread per pair (t, t ^ h), laid out as the
//   steps' threads over the pairs: it reads both elements (and both
//   coefficient words) before it writes either, so the update in place
//   needs no barrier.
// - m31_warp_cascade: the design of warp_cascade.cuh on one word and
//   m31::mul_add / mul_add2. A warp holds a chunk of 128 window rows x 8
//   lanes in registers for the whole run, lane t rows t + 32 j: levels of
//   xor 1 .. 16 are shuffles, 32 and 64 swaps of register rows, with no
//   barrier and no shared-memory round trip of the tile between levels;
//   the run's coefficient words are staged once a block (up to 8 warps on
//   one chunk) in shared memory before the first level. A row's 8 lanes
//   are one 32-byte sector, read and written as two 16-byte vectors.
//
// The kernels allocate nothing and launch on the caller's stream; each
// launcher returns cudaGetLastError() (or cudaErrorInvalidValue for
// parameters it cannot take) so a refused launch is reported.

#include <cuda_runtime.h>

#include "levels.cuh"
#include "m31_arith.cuh"
#include "warp_cascade.cuh"

constexpr int M31_THREADS = 256;          // step and pair blocks

namespace {

enum Kind { AFF1S = 0, AFF1 = 1, AFF2 = 2, MUL = 3 };

// A grid of 256-thread blocks over `rows` rows and B lanes: lanes a block
// 2^lg (the smallest power of two >= B, at most 256), 256 >> lg rows a block.
struct Grid {
  dim3 grid;
  int lg;
};

Grid grid_for(int rows, int B) {
  int lg = 0;
  while ((1 << lg) < B && (1 << lg) < M31_THREADS) ++lg;
  const int per = M31_THREADS >> lg;
  return {dim3((rows + per - 1) / per, (B + (1 << lg) - 1) >> lg), lg};
}

// This thread's row (of `rows`) and lane, or false on the ragged edge
__device__ __forceinline__ bool place(int rows, int B, int lg, int& row,
                                      int& b) {
  const int tid = threadIdx.x;
  b = (blockIdx.y << lg) + (tid & ((1 << lg) - 1));
  row = blockIdx.x * (M31_THREADS >> lg) + (tid >> lg);
  return row < rows && b < B;
}

__device__ __forceinline__ uint32_t ldg_word(const int32_t* p) {
  return static_cast<uint32_t>(__ldg(p));
}

// KIND AFF1S: out[s+q] + C*x2; AFF1: x1 + C*x2; AFF2: A*x1 + C*x2; MUL:
// x1*x2. `out` holds the window at rows [start, start + A); x1 may be that
// window (AFF1) or the same buffer as x2 (MUL), so neither is __restrict__.
template <int KIND>
__global__ void __launch_bounds__(M31_THREADS)
m31_step_kernel(const int32_t* __restrict__ ca,
                const int32_t* __restrict__ cc, const int32_t* x1,
                const int32_t* x2, int32_t* out, int start, int A, int B,
                int lg) {
  int q, b;
  if (!place(A, B, lg, q, b)) return;
  const int64_t e = static_cast<int64_t>(q) * B + b;
  int32_t* o = out + static_cast<int64_t>(start + q) * B + b;
  const uint32_t y = ldg_word(x2 + e);
  uint32_t r;
  if (KIND == MUL) {
    r = m31::mul(static_cast<uint32_t>(x1[e]), y);
  } else if (KIND == AFF2) {
    r = m31::mul_add2(ldg_word(ca + q), static_cast<uint32_t>(x1[e]),
                      ldg_word(cc + q), y);
  } else {
    const uint32_t x = static_cast<uint32_t>(KIND == AFF1S ? *o : x1[e]);
    r = m31::mul_add(ldg_word(cc + q), y, x);
  }
  *o = static_cast<int32_t>(r);
}

// One pair level on the window [start, start + A): the thread of pair i
// owns rows t = start + rt and t ^ h (rt's bit h is 0, start % 2h == 0).
// TWO: x[t] <- A[t]*x[t] + C[t]*x[t^h]; else x[t] <- x[t] + C[t]*x[t^h].
template <bool TWO>
__global__ void __launch_bounds__(M31_THREADS)
m31_pair_kernel(const int32_t* __restrict__ aw,
                const int32_t* __restrict__ cw, int32_t* state, int start,
                int half, int A, int B, int lg) {
  int i, b;
  if (!place(A / 2, B, lg, i, b)) return;
  const int rt = (i / half) * 2 * half + i % half;  // window row of t
  const int ru = ((start + rt) ^ half) - start;    // window row of t ^ h
  int32_t* xt = state + static_cast<int64_t>(start + rt) * B + b;
  int32_t* xu = state + static_cast<int64_t>(start + ru) * B + b;
  const uint32_t vt = static_cast<uint32_t>(*xt);
  const uint32_t vu = static_cast<uint32_t>(*xu);
  const uint32_t ct = ldg_word(cw + rt), cu = ldg_word(cw + ru);
  if (TWO) {
    const uint32_t at = ldg_word(aw + rt), au = ldg_word(aw + ru);
    *xt = static_cast<int32_t>(m31::mul_add2(at, vt, ct, vu));
    *xu = static_cast<int32_t>(m31::mul_add2(au, vu, cu, vt));
  } else {
    *xt = static_cast<int32_t>(m31::mul_add(ct, vu, vt));
    *xu = static_cast<int32_t>(m31::mul_add(cu, vt, vu));
  }
}

// The cascade (warp_cascade.cuh): V lanes a thread, rows t + 32 j of a
// 128-row chunk a warp. Four blocks (32 warps) an SM, so that one block's
// loads overlap another's levels: 64 registers and 16 bytes spilled, 10%
// faster than 71 registers and three blocks (PERF.md, findings)
template <int V>
__global__ void __launch_bounds__(wc::MAX_THREADS, 4)
m31_warp_cascade(Levels lv, const int32_t* __restrict__ cw,
                 const int32_t* __restrict__ aw, int32_t* state, int start,
                 int A, int B, int vec) {
  wc::cascade<wc::M31Arith, V>(wc::M31Arith::Consts{}, lv, cw, aw, state,
                               start, A, B, vec != 0);
}

template <int KIND>
int launch_step(const int32_t* ca, const int32_t* cc, const int32_t* x1,
                const int32_t* x2, int32_t* out, int start, int A, int B,
                void* stream) {
  if (A <= 0 || B <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const Grid g = grid_for(A, B);
  m31_step_kernel<KIND><<<g.grid, M31_THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      ca, cc, x1, x2, out, start, A, B, g.lg);
  return static_cast<int>(cudaGetLastError());
}

template <bool TWO>
int launch_pair(const int32_t* a, const int32_t* c, int32_t* state,
                int start, int half, int A, int B, void* stream) {
  if (half <= 0 || A < 2 || B <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Grid g = grid_for(A / 2, B);
  m31_pair_kernel<TWO><<<g.grid, M31_THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      a, c, state, start, half, A, B, g.lg);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int ecfft_m31_aff1s_ip(const int32_t* c, const int32_t* x2, int32_t* state,
                       int start, int A, int B, void* stream) {
  return launch_step<AFF1S>(nullptr, c, nullptr, x2, state, start, A, B,
                            stream);
}

int ecfft_m31_aff1g_ip(const int32_t* c, const int32_t* x1,
                       const int32_t* x2, int32_t* state, int start, int A,
                       int B, void* stream) {
  return launch_step<AFF1>(nullptr, c, x1, x2, state, start, A, B, stream);
}

int ecfft_m31_aff2g_ip(const int32_t* a, const int32_t* b,
                       const int32_t* x1, const int32_t* x2, int32_t* state,
                       int start, int A, int B, void* stream) {
  return launch_step<AFF2>(a, b, x1, x2, state, start, A, B, stream);
}

int ecfft_m31_muladd1(const int32_t* c, const int32_t* x1, const int32_t* x2,
                      int32_t* out, int start, int A, int B, void* stream) {
  return launch_step<AFF1>(nullptr, c, x1, x2, out, start, A, B, stream);
}

int ecfft_m31_muladd2(const int32_t* a, const int32_t* b, const int32_t* x1,
                      const int32_t* x2, int32_t* out, int start, int A,
                      int B, void* stream) {
  return launch_step<AFF2>(a, b, x1, x2, out, start, A, B, stream);
}

int ecfft_m31_mulss(const int32_t* x1, const int32_t* x2, int32_t* out,
                    int start, int A, int B, void* stream) {
  return launch_step<MUL>(nullptr, nullptr, x1, x2, out, start, A, B,
                          stream);
}

int ecfft_m31_fused_bf1(const int32_t* c, int32_t* state, int start,
                        int half, int A, int B, void* stream) {
  // the 1-mul form reads no A row; c stands in for it unread
  return launch_pair<false>(c, c, state, start, half, A, B, stream);
}

int ecfft_m31_fused_bf2(const int32_t* a, const int32_t* b, int32_t* state,
                        int start, int half, int A, int B, void* stream) {
  return launch_pair<true>(a, b, state, start, half, A, B, stream);
}

int ecfft_m31_fused_cascade(const Levels* lv, const int32_t* c,
                            const int32_t* a, int32_t* state, int start,
                            int tw, int A, int B, void* stream) {
  constexpr int V = wc::lanes(1);
  if (!wc::levels_ok(*lv, tw) || A <= 0 || A % tw != 0 || B <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const wc::Grid g = wc::grid(A, B, V);
  m31_warp_cascade<V><<<static_cast<unsigned>(g.chunks) * g.per_chunk,
                        g.warps * wc::WARP, wc::shared_bytes(*lv, 1),
                        static_cast<cudaStream_t>(stream)>>>(
      *lv, c, a, state, start, A, B, wc::vectors(B, state));
  return static_cast<int>(cudaGetLastError());
}

const char* ecfft_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
