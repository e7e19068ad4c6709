// The unrolled executor's fused butterfly levels, for Hopper (sm_90a).
//
// Each kernel updates the window [start, start + A) of a (W, L, B) int32
// state of L = NL 16-bit limbs in place, in the form this library is
// compiled for (word_arith.cuh: the fold or the CIOS form), pairing row t
// with row t ^ h:
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
// start. All three run on word_arith.cuh's field arithmetic (NW 32-bit
// words an element).
//
// What bounds it on the H100. A pair level reads each window row once and
// writes it once: 8 L bytes per element, 2.15 GB at (A 65536, B 256, L
// 16), 0.64 ms at 3.35 TB/s, against about 0.1 ms of word products: bound
// by the bytes. A cascade moves the same 8 L bytes per element once for the
// whole run, plus 4 L bytes of coefficients per row and level, and needs a
// 1-mul (2-mul) level's NW^2 (2 NW^2) word products and the reduction's
// per element and level: at L 16, 14 levels are about 1.2 ms of word
// products at the IMAD.WIDE rate against 0.66 ms of bytes, so its function
// is bound by the operations. A design issues several instructions per word
// product (the carries, the fold, shared memory), so in practice a
// cascade runs well above that bound, limited by the issue rate.
//
// The designs. Pair levels: one thread per element, so that a thread holds
// few enough registers (48 in the 1-mul form, 80 in the 2-mul form) for ten
// or six 128-thread blocks, 40 or 24 warps, to share an SM: the function
// is bound by its bytes, and the warps are what keeps loads in flight. A
// block holds both rows of BF_SIDE / lanes pairs for `lanes` neighbouring
// lanes (lanes the smallest power of two >= B, at most BF_SIDE = 64):
// threads [0, 64) the rows t, threads [64, 128) their partners t ^ h, so a
// warp lies on one side and its limb loads are coalesced across lanes. A
// thread issues all its loads (the L limbs of its element and of its one
// or two coefficient rows, the rows a broadcast to the lanes) before the
// first multiply, packs them into words, and writes its element's NW words
// to shared memory, word k of thread i at [k][i]: a warp's 32 threads fall
// on 32 banks, storing and reading the partner's (thread i ^ 64) alike.
// After the block's one barrier it reads its partner's words, computes its
// one new value and stores it. A thread with no element (a ragged edge in
// lanes or pairs) loads and stores nothing but reaches the barrier. Each
// element is read from device memory and written by exactly one thread,
// and the partner's value crosses in shared memory, so the in-place update
// is race-free. The partner is the global xor t ^ h, which the wrapper
// checks lands at t + h (start % 2h == 0).
//
// Cascades of three words or more (NW >= 3, cascade_kernel): one block
// of CT = 512 threads per (tile of TW <= 128 rows, group of CL = 4
// lanes), one thread per element of the tile. The tile lives in shared
// memory for the whole run, packed into 32-bit words on
// the way in and unpacked on the way out, in two copies (ping-pong): a
// level reads copy `cur` (its row and row r ^ h) and writes copy cur ^ 1,
// so one barrier per level keeps the next level from reading a row before
// it is written and from overwriting a row still being read. Each level's
// coefficient rows come from device memory (a broadcast to the lanes of a
// row), loaded and packed before the barrier that precedes the level, so
// the loads overlap the wait. A tile row is RS = CL x (NW | 1) words, 4
// times an odd number: a warp's 8 rows x 4 lanes fall on 32 distinct banks
// (8 rows at an odd multiple of 4 words apart cover the 8 groups of 4
// banks), for its own rows and for the rows r ^ h alike; NW = 8 pads to 36
// words, NW = 7 needs no pad. 2 x 128 x RS x 4 bytes of shared memory
// (36,864 at NW 8) and at most 64 registers a thread: two
// blocks (32 warps) per SM at NW 8, at the price of a few spilled words,
// which cost less than the warps a larger register budget would take away
// (PERF.md, findings). At one or two words an element a thread of that
// design carries too little work to pay for a barrier and a coefficient
// load per level, so those forms ("fold4", "cios3", a 2-limb prime) take
// word_warp_cascade instead, the design of warp_cascade.cuh: levels in
// registers and warp shuffles, no barrier between levels (the launcher
// picks it at compile time).
//
// The kernels allocate nothing and launch on the caller's stream; each
// launcher returns cudaGetLastError() (or cudaErrorInvalidValue for
// parameters it cannot take) so a refused launch is reported.

#include <cuda_runtime.h>

#include "levels.cuh"
#include "warp_cascade.cuh"
#include "word_arith.cuh"

constexpr int BF_THREADS = 128;           // pair-level threads: one an element
constexpr int BF_SIDE = BF_THREADS / 2;    // elements of each side of the pairs
constexpr int CL = 4;                      // lanes per cascade block
constexpr int MAX_TW = 128;                // largest cascade tile
constexpr int CT = MAX_TW * CL;            // cascade threads: one an element
constexpr int RS = CL * (NW | 1);          // shared words per tile row

namespace {

// One coefficient row's NL limbs, through the read-only path
__device__ __forceinline__ void ldg_row(const int32_t* __restrict__ row,
                                        uint32_t (&l)[NL]) {
#pragma unroll
  for (int j = 0; j < NL; ++j) l[j] = static_cast<uint32_t>(__ldg(row + j));
}

// One pair level. TWO: x[t] <- A[t]*x[t] + C[t]*x[t^h]; else x[t] <- x[t] +
// C[t]*x[t^h]. lg: log2 of the lanes a block holds; blockIdx.x counts the
// groups of pairs, blockIdx.y the groups of lanes. No register cap: a cap
// of 64 makes the 2-mul form spill and both forms slower (PERF.md,
// findings).
template <bool TWO>
__global__ void __launch_bounds__(BF_THREADS)
pair_kernel(Field fd, const int32_t* __restrict__ aw,
            const int32_t* __restrict__ cw, int32_t* state, int start,
            int half, int A, int B, int lg) {
  __shared__ uint32_t xs[NW * BF_THREADS];
  const int tid = threadIdx.x;
  const int b = (blockIdx.y << lg) + (tid & ((1 << lg) - 1));
  const int i = blockIdx.x * (BF_SIDE >> lg) + ((tid & (BF_SIDE - 1)) >> lg);
  const bool live = i < A / 2 && b < B;
  const int rt = (i / half) * 2 * half + i % half;  // window row of t
  const int row = tid < BF_SIDE ? start + rt : (start + rt) ^ half;
  const int64_t q = row - start;                    // this window row
  int32_t* el = state + (static_cast<int64_t>(row) * NL) * B + b;
  uint32_t x[NW], c[NW], a[NW];
  if (live) {
    uint32_t lx[NL], lc[NL], la[NL];
#pragma unroll
    for (int j = 0; j < NL; ++j)
      lx[j] = static_cast<uint32_t>(el[static_cast<int64_t>(j) * B]);
    ldg_row(cw + q * NL, lc);
    if (TWO) ldg_row(aw + q * NL, la);
    wa::pack<NL>(lx, x);
    wa::pack<NL>(lc, c);
    if (TWO) wa::pack<NL>(la, a);
#pragma unroll
    for (int k = 0; k < NW; ++k) xs[k * BF_THREADS + tid] = x[k];
  }
  __syncthreads();
  if (!live) return;
  uint32_t xp[NW];
#pragma unroll
  for (int k = 0; k < NW; ++k) xp[k] = xs[k * BF_THREADS + (tid ^ BF_SIDE)];
  if (TWO)
    wa::fma2<NL, MONT>(fd, a, x, c, xp, x);
  else
    wa::fma1<NL, MONT>(fd, c, xp, x, x);
  wa::store_words<NL>(el, B, x);
}

// The coefficient rows of level li for window row q: C (and A, for a
// kind-1 level, at its index ai among the kind-1 levels) as words.
__device__ __forceinline__ void level_rows(const Levels& lv, int li, int ai,
                                           const int32_t* __restrict__ cw,
                                           const int32_t* __restrict__ aw,
                                           int64_t q, int A,
                                           uint32_t (&c)[NW],
                                           uint32_t (&a)[NW]) {
  uint32_t l[NL];
  ldg_row(cw + (static_cast<int64_t>(li) * A + q) * NL, l);
  wa::pack<NL>(l, c);
  if (lv.kind[li]) {
    ldg_row(aw + (static_cast<int64_t>(ai) * A + q) * NL, l);
    wa::pack<NL>(l, a);
  }
}

__global__ void __launch_bounds__(CT, 2)
cascade_kernel(Field fd, Levels lv, const int32_t* __restrict__ cw,
               const int32_t* __restrict__ aw, int32_t* state, int start,
               int tw, int A, int B) {
  __shared__ uint32_t tile[2][MAX_TW * RS];
  const int groups = (B + CL - 1) / CL;
  const int g = blockIdx.x / groups;       // the tile within the window
  const int b0 = (blockIdx.x - g * groups) * CL;
  const int r = threadIdx.x / CL, l = threadIdx.x % CL;  // this element
  const bool live = r < tw && b0 + l < B;
  const int64_t q = static_cast<int64_t>(g) * tw + r;    // its window row
  const int64_t LB = static_cast<int64_t>(NL) * B;
  int32_t* el = state + (start + q) * LB + b0 + l;
  uint32_t c[NW], a[NW];
  if (live) {
    uint32_t x[NW];
    wa::load_words<NL>(el, B, x);
#pragma unroll
    for (int k = 0; k < NW; ++k) tile[0][r * RS + k * CL + l] = x[k];
    level_rows(lv, 0, 0, cw, aw, q, A, c, a);
  }
  __syncthreads();
  int cur = 0, ai = 0;
  for (int li = 0; li < lv.k; ++li) {
    const bool two = lv.kind[li] != 0;
    if (live) {
      const uint32_t* t = tile[cur];
      const int rp = r ^ lv.half[li];
      uint32_t x[NW], xp[NW];
#pragma unroll
      for (int k = 0; k < NW; ++k) {
        x[k] = t[r * RS + k * CL + l];
        xp[k] = t[rp * RS + k * CL + l];
      }
      if (two)
        wa::fma2<NL, MONT>(fd, a, x, c, xp, x);
      else
        wa::fma1<NL, MONT>(fd, c, xp, x, x);
#pragma unroll
      for (int k = 0; k < NW; ++k) tile[cur ^ 1][r * RS + k * CL + l] = x[k];
    }
    ai += two;
    if (live && li + 1 < lv.k) level_rows(lv, li + 1, ai, cw, aw, q, A, c, a);
    __syncthreads();
    cur ^= 1;
  }
  if (live) {  // from the tile: no value stays in registers across a level
    uint32_t x[NW];
#pragma unroll
    for (int k = 0; k < NW; ++k) x[k] = tile[cur][r * RS + k * CL + l];
    wa::store_words<NL>(el, B, x);
  }
}

// The cascade of one or two words an element (warp_cascade.cuh): V
// lanes a thread, rows t + 32 j of a 128-row chunk a warp
template <int V>
__global__ void __launch_bounds__(wc::MAX_THREADS)
word_warp_cascade(Field fd, Levels lv, const int32_t* __restrict__ cw,
                  const int32_t* __restrict__ aw, int32_t* state, int start,
                  int A, int B, int vec) {
  wc::cascade<wc::WordArith<NL, MONT>, V>(fd, lv, cw, aw, state, start, A,
                                          B, vec != 0);
}

template <bool TWO>
int launch_bf(const Field* fd, const int32_t* a, const int32_t* c,
              int32_t* state, int start, int half, int A, int B,
              void* stream) {
  if (half <= 0 || fd->nw != NW || fd->mont != MONT)
    return static_cast<int>(cudaErrorInvalidValue);
  int lg = 0;  // lanes a block: the smallest power of two >= B, <= BF_SIDE
  while ((1 << lg) < B && (1 << lg) < BF_SIDE) ++lg;
  const int pairs = BF_SIDE >> lg;                  // pairs a block
  const dim3 grid((A / 2 + pairs - 1) / pairs, (B + (1 << lg) - 1) >> lg);
  pair_kernel<TWO><<<grid, BF_THREADS, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      *fd, a, c, state, start, half, A, B, lg);
  return static_cast<int>(cudaGetLastError());
}

// A cascade in the design of the form's word count W (= NW): the warp
// design of warp_cascade.cuh at one or two words, else cascade_kernel
template <int W>
int launch_cascade(const Field* fd, const Levels* lv, const int32_t* c,
                   const int32_t* a, int32_t* state, int start, int tw,
                   int A, int B, cudaStream_t stream) {
  if constexpr (W <= 2) {
    constexpr int V = wc::lanes(W);
    if (!wc::levels_ok(*lv, tw) || A <= 0 || B <= 0)
      return static_cast<int>(cudaErrorInvalidValue);
    const wc::Grid g = wc::grid(A, B, V);
    word_warp_cascade<V><<<static_cast<unsigned>(g.chunks) * g.per_chunk,
                           g.warps * wc::WARP, wc::shared_bytes(*lv, W),
                           stream>>>(*fd, *lv, c, a, state, start, A, B,
                                     wc::vectors(B, state));
  } else {
    const int64_t blocks =
        static_cast<int64_t>(A / tw) * ((B + CL - 1) / CL);
    cascade_kernel<<<static_cast<unsigned>(blocks), CT, 0, stream>>>(
        *fd, *lv, c, a, state, start, tw, A, B);
  }
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
      A % tw != 0 || fd->nw != NW || fd->mont != MONT)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_cascade<NW>(fd, lv, c, a, state, start, tw, A, B,
                            static_cast<cudaStream_t>(stream));
}

}  // extern "C"
