// The cascade of few words, for Hopper (sm_90a): the in-tile levels of
// _fused_cascade (ecfft_tpu/ops/unrolled.py:200) held in registers and
// warp shuffles. fused_kernels.cu launches it for the word forms of one
// and two words an element (NL = 2 .. 4 limbs: "fold4" for M61, "cios3",
// a 2-limb prime), m31_kernels.cu for M31; the 8-word cascade keeps its
// own design (fused_kernels.cu, cascade_kernel).
//
// What it computes: for each level li of a run, on the window [start,
// start + A) of a (W, L, B) int32 state,
//   x[q] <- x[q] + C_li[q] x[q ^ h_li]                (kind 0)
//   x[q] <- A_ai[q] x[q] + C_li[q] x[q ^ h_li]        (kind 1)
// with q the window row, ai counting the kind-1 levels. Each h_li < tw
// and tw % (2 h_li) == 0, so q ^ h stays in q's tile of tw rows, and in
// q's chunk of 128 rows whatever tw is.
//
// What bounds it on the H100. It moves each element once in and once out
// (8 bytes for M31, 16 for M61) and a coefficient row per level; its work
// is one or two products and a reduction per element and level. At M31's
// main shape (A 65536, B 2048, 14 levels) the bytes take 0.32 ms and the
// products far less, so the bound is the bytes; what a design can reach
// is set by the instructions it issues per element and level, since the
// reduction and the data movement cost several instructions a product.
//
// The design. A warp owns a chunk of 128 window rows and V neighbouring
// lanes (lanes(NW): 8 at one word, 4 at two); lane t of the warp holds rows
// t + 32 j (j = 0 .. 3) of those V lanes in registers, NW words an element,
// for the whole run. A level's xor h then splits into lane bits h % 32,
// which a __shfl_xor_sync crosses, and register bits h / 32, a select within
// the thread: h = 1 .. 16 are shuffles, h = 32 and 64 swaps of register
// rows. No level touches shared memory for the state and none waits at a
// barrier. A kind-0 pair reads both old values before it writes either: the
// partner arrives by shuffle (all lanes read at once) or is picked into a
// temporary before the rows are updated. The coefficient rows of all k
// levels (C, then A for each kind-1 level) are staged once per block into
// shared memory, packed into words: the loads are in flight together and
// each row is read once a block, not once a lane; one barrier follows,
// before the first level. A block holds up to 8 warps on one chunk and
// neighbouring lane groups, so they share the staged rows (and, at 4 lanes,
// each 32-byte sector of a row). The state's loads of a row are V
// consecutive int32 a limb: 16-byte loads where every row starts on a
// 16-byte boundary (B % 4 == 0, the state aligned), else scalar loads; a
// ragged last lane group or a chunk past the window's end (A % 128 != 0) is
// guarded, and its registers hold 0.
//
// Plain C++ for host and device, as word_arith.cuh: nvcc compiles it for
// the card; g++ compiles the same header on the CPU, where
// tests/test_torch_cascade_layout.py runs one warp's levels with its
// shuffles emulated and holds the result against the plain version.

#pragma once

#include <cstdint>

#include "levels.cuh"
#include "m31_arith.cuh"
#include "word_arith.cuh"

namespace wc {

constexpr int WARP = 32;
constexpr int ROWS = 4;               // register rows a thread holds
constexpr int CHUNK = WARP * ROWS;    // window rows a warp holds
constexpr int MAX_WARPS = 8;          // warps a block
constexpr int MAX_THREADS = MAX_WARPS * WARP;
static_assert(ROWS == 4, "pick() selects among four register rows");

// Lanes a thread holds, for an element of nw words: 8 at one word (a
// row's lanes one 32-byte sector), 4 at two (at 8, "fold4" needs 128
// registers and spills, and runs 23% slower: PERF.md, findings)
__host__ __device__ constexpr int lanes(int nw) { return nw == 1 ? 8 : 4; }

// The window row (of its chunk) that register row j of lane t holds, and
// the two parts of a level's xor h: lane bits and register-row bits
__host__ __device__ constexpr int row(int t, int j) { return t + WARP * j; }
__host__ __device__ constexpr int lane_xor(int h) { return h % WARP; }
__host__ __device__ constexpr int reg_xor(int h) { return h / WARP; }

// The launch: a block of `warps` warps per (chunk, `warps` neighbouring
// lane groups of V lanes); `per_chunk` blocks cover a chunk's lanes
struct Grid {
  int chunks, groups, warps, per_chunk;
};

__host__ __device__ inline Grid grid(int A, int B, int V) {
  Grid g;
  g.chunks = (A + CHUNK - 1) / CHUNK;
  g.groups = (B + V - 1) / V;
  g.warps = g.groups < MAX_WARPS ? g.groups : MAX_WARPS;
  g.per_chunk = (g.groups + g.warps - 1) / g.warps;
  return g;
}

// The first window row of block blk's chunk, and warp w's first lane
// (at or past B: a warp with no lanes, which stages rows and stops)
__host__ __device__ inline void place(const Grid& g, int blk, int w, int V,
                                      int& q0, int& b0) {
  const int c = blk / g.per_chunk;
  q0 = c * CHUNK;
  b0 = ((blk - c * g.per_chunk) * g.warps + w) * V;
}

// 16-byte loads and stores of 4 lanes: every row's lanes start on a
// 16-byte boundary
inline bool vectors(int B, const void* state) {
  return B % 4 == 0 && reinterpret_cast<uintptr_t>(state) % 16 == 0;
}

// The levels a launch takes: 1 .. MAX_LEVELS levels, each h in [1, tw)
// with tw % (2 h) == 0, tw <= CHUNK
inline bool levels_ok(const Levels& lv, int tw) {
  if (lv.k < 1 || lv.k > MAX_LEVELS || tw < 2 || tw > CHUNK) return false;
  for (int li = 0; li < lv.k; ++li)
    if (lv.half[li] < 1 || lv.half[li] >= tw || tw % (2 * lv.half[li]))
      return false;
  return true;
}

// Staged rows: the k C rows, then an A row per kind-1 level
__host__ __device__ inline int slots(const Levels& lv) {
  int n = lv.k;
  for (int li = 0; li < lv.k; ++li) n += lv.kind[li] != 0;
  return n;
}

__host__ __device__ inline int shared_bytes(const Levels& lv, int nw) {
  return slots(lv) * nw * CHUNK * 4;
}

// ------------------------------------------------ the fields' arithmetic

// M31: one word, canonical (m31_arith.cuh)
struct M31Arith {
  static constexpr int NL = 1, NW = 1;
  struct Consts {};
  __host__ __device__ static void pack(const uint32_t (&l)[1],
                                       uint32_t (&w)[1]) {
    w[0] = l[0];
  }
  __host__ __device__ static void unpack(const uint32_t (&w)[1],
                                         uint32_t (&l)[1]) {
    l[0] = w[0];
  }
  // x <- x + c y
  __host__ __device__ static void fma1(const Consts&, const uint32_t (&c)[1],
                                       const uint32_t (&y)[1],
                                       uint32_t (&x)[1]) {
    x[0] = m31::mul_add(c[0], y[0], x[0]);
  }
  // x <- a x + c y
  __host__ __device__ static void fma2(const Consts&, const uint32_t (&a)[1],
                                       const uint32_t (&c)[1],
                                       const uint32_t (&y)[1],
                                       uint32_t (&x)[1]) {
    x[0] = m31::mul_add2(a[0], x[0], c[0], y[0]);
  }
};

// A word form: L limbs of 16 bits in words(L) words, the fold or the CIOS
// reduction (word_arith.cuh, unchanged)
template <int L, bool M>
struct WordArith {
  static constexpr int NL = L, NW = wa::words(L);
  using Consts = Field;
  __host__ __device__ static void pack(const uint32_t (&l)[NL],
                                       uint32_t (&w)[NW]) {
    wa::pack<NL>(l, w);
  }
  __host__ __device__ static void unpack(const uint32_t (&w)[NW],
                                         uint32_t (&l)[NL]) {
    wa::unpack<NL>(w, l);
  }
  __host__ __device__ static void fma1(const Field& fd,
                                       const uint32_t (&c)[NW],
                                       const uint32_t (&y)[NW],
                                       uint32_t (&x)[NW]) {
    wa::fma1<NL, M>(fd, c, y, x, x);
  }
  __host__ __device__ static void fma2(const Field& fd,
                                       const uint32_t (&a)[NW],
                                       const uint32_t (&c)[NW],
                                       const uint32_t (&y)[NW],
                                       uint32_t (&x)[NW]) {
    wa::fma2<NL, M>(fd, a, x, c, y, x);
  }
};

// ------------------------------------------------------- memory access

__host__ __device__ __forceinline__ void ld4(const int32_t* p,
                                             uint32_t (&q)[4]) {
#ifdef __CUDA_ARCH__
  const int4 v = *reinterpret_cast<const int4*>(p);
  q[0] = v.x, q[1] = v.y, q[2] = v.z, q[3] = v.w;
#else
  for (int i = 0; i < 4; ++i) q[i] = static_cast<uint32_t>(p[i]);
#endif
}

__host__ __device__ __forceinline__ void st4(int32_t* p,
                                             const uint32_t (&q)[4]) {
#ifdef __CUDA_ARCH__
  *reinterpret_cast<int4*>(p) = make_int4(q[0], q[1], q[2], q[3]);
#else
  for (int i = 0; i < 4; ++i) p[i] = static_cast<int32_t>(q[i]);
#endif
}

__host__ __device__ __forceinline__ int32_t ldg(const int32_t* p) {
#ifdef __CUDA_ARCH__
  return __ldg(p);
#else
  return *p;
#endif
}

// Item i of a block's staging: slot s = i / CHUNK, row r = i % CHUNK of
// the chunk at window row q0, its NL limbs packed into words at
// sh[(s NW + w) CHUNK + r]; a row past the window is 0
template <class AR>
__host__ __device__ __forceinline__ void stage(int i, int k,
                                               const int32_t* cw,
                                               const int32_t* aw, int q0,
                                               int A, uint32_t* sh) {
  const int s = i / CHUNK, r = i - s * CHUNK, q = q0 + r;
  uint32_t l[AR::NL] = {}, w[AR::NW];
  if (q < A) {
    const int32_t* src =
        s < k ? cw + (static_cast<int64_t>(s) * A + q) * AR::NL
              : aw + (static_cast<int64_t>(s - k) * A + q) * AR::NL;
#pragma unroll
    for (int j = 0; j < AR::NL; ++j) l[j] = static_cast<uint32_t>(ldg(src + j));
  }
  AR::pack(l, w);
#pragma unroll
  for (int k2 = 0; k2 < AR::NW; ++k2) sh[(s * AR::NW + k2) * CHUNK + r] = w[k2];
}

// -------------------------------------------------- one thread's tile

// The ROWS x V elements one thread holds, NW words each
template <class AR, int V>
struct Tile {
  static constexpr int NL = AR::NL, NW = AR::NW;
  static_assert(V % 4 == 0, "lanes come in 16-byte groups of 4");
  uint32_t x[ROWS][V][NW];

  // Rows row0 + row(t, j) below row0 + rows, lanes b0 .. b0 + V - 1 below
  // B, of the (W, NL, B) state; the rest 0
  __host__ __device__ __forceinline__ void load(const int32_t* state,
                                                int64_t row0, int t,
                                                int rows, int b0, int B,
                                                bool vec) {
    const int n = B - b0;  // lanes of this group that exist
#pragma unroll
    for (int j = 0; j < ROWS; ++j) {
      uint32_t l[V][NL] = {};
      if (row(t, j) < rows) {
        const int32_t* p =
            state + ((row0 + row(t, j)) * NL) * static_cast<int64_t>(B) + b0;
#pragma unroll
        for (int k = 0; k < NL; ++k) {
          const int32_t* pk = p + static_cast<int64_t>(k) * B;
          if (vec) {
#pragma unroll
            for (int c = 0; c < V / 4; ++c) {
              uint32_t q[4] = {0, 0, 0, 0};
              if (4 * c < n) ld4(pk + 4 * c, q);
#pragma unroll
              for (int i = 0; i < 4; ++i) l[4 * c + i][k] = q[i];
            }
          } else {
#pragma unroll
            for (int v = 0; v < V; ++v)
              l[v][k] = v < n ? static_cast<uint32_t>(pk[v]) : 0u;
          }
        }
      }
#pragma unroll
      for (int v = 0; v < V; ++v) AR::pack(l[v], x[j][v]);
    }
  }

  __host__ __device__ __forceinline__ void store(int32_t* state,
                                                 int64_t row0, int t,
                                                 int rows, int b0, int B,
                                                 bool vec) const {
    const int n = B - b0;
#pragma unroll
    for (int j = 0; j < ROWS; ++j) {
      if (row(t, j) >= rows) continue;
      uint32_t l[V][NL];
#pragma unroll
      for (int v = 0; v < V; ++v) AR::unpack(x[j][v], l[v]);
      int32_t* p =
          state + ((row0 + row(t, j)) * NL) * static_cast<int64_t>(B) + b0;
#pragma unroll
      for (int k = 0; k < NL; ++k) {
        int32_t* pk = p + static_cast<int64_t>(k) * B;
        if (vec) {
#pragma unroll
          for (int c = 0; c < V / 4; ++c) {
            if (4 * c >= n) continue;
            const uint32_t q[4] = {l[4 * c][k], l[4 * c + 1][k],
                                   l[4 * c + 2][k], l[4 * c + 3][k]};
            st4(pk + 4 * c, q);
          }
        } else {
#pragma unroll
          for (int v = 0; v < V; ++v)
            if (v < n) pk[v] = static_cast<int32_t>(l[v][k]);
        }
      }
    }
  }

  // One level of xor h on this thread's rows: cs, as the level's staged C
  // and A rows (as read only by a kind-1 level, two). fetch(value, j, v,
  // w, m) returns word w of element (j, v) of lane t ^ m, `value` being
  // this lane's own: __shfl_xor_sync on the card, all lanes at once.
  template <class Fetch>
  __host__ __device__ __forceinline__ void level(
      const typename AR::Consts& fd, const uint32_t* cs, const uint32_t* as,
      int t, int h, bool two, const Fetch& fetch) {
    const int s = reg_xor(h), m = lane_xor(h);
    if (s == 0) {
      if (two)
        in_lanes<true>(fd, cs, as, t, m, fetch);
      else
        in_lanes<false>(fd, cs, as, t, m, fetch);
    } else {
      if (two)
        across<true>(fd, cs, as, t, s, m, fetch);
      else
        across<false>(fd, cs, as, t, s, m, fetch);
    }
  }

 private:
  __host__ __device__ __forceinline__ static void coeff(const uint32_t* rs,
                                                        int t, int j,
                                                        uint32_t (&c)[NW]) {
#pragma unroll
    for (int w = 0; w < NW; ++w) c[w] = rs[w * CHUNK + row(t, j)];
  }

  // word w of element (k, v), k = 0 .. 3 known only at run time
  __host__ __device__ __forceinline__ uint32_t pick(int k, int v,
                                                    int w) const {
    const uint32_t lo = k & 1 ? x[1][v][w] : x[0][v][w];
    const uint32_t hi = k & 1 ? x[3][v][w] : x[2][v][w];
    return k & 2 ? hi : lo;
  }

  // h < 32: the partner is the same register of lane t ^ h
  template <bool TWO, class Fetch>
  __host__ __device__ __forceinline__ void in_lanes(
      const typename AR::Consts& fd, const uint32_t* cs, const uint32_t* as,
      int t, int m, const Fetch& fetch) {
#pragma unroll
    for (int j = 0; j < ROWS; ++j) {
      uint32_t c[NW], a[NW];
      coeff(cs, t, j, c);
      if (TWO) coeff(as, t, j, a);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        uint32_t y[NW];
#pragma unroll
        for (int w = 0; w < NW; ++w) y[w] = fetch(x[j][v][w], j, v, w, m);
        if (TWO)
          AR::fma2(fd, a, c, y, x[j][v]);
        else
          AR::fma1(fd, c, y, x[j][v]);
      }
    }
  }

  // h >= 32: the partner of row j is register row j ^ s (s = h / 32) of
  // lane t ^ m (m = h % 32, no shuffle where m = 0), picked for all four
  // rows of a lane before any of them is written
  template <bool TWO, class Fetch>
  __host__ __device__ __forceinline__ void across(
      const typename AR::Consts& fd, const uint32_t* cs, const uint32_t* as,
      int t, int s, int m, const Fetch& fetch) {
    uint32_t c[ROWS][NW], a[ROWS][NW];
#pragma unroll
    for (int j = 0; j < ROWS; ++j) {
      coeff(cs, t, j, c[j]);
      if (TWO) coeff(as, t, j, a[j]);
    }
#pragma unroll
    for (int v = 0; v < V; ++v) {
      uint32_t y[ROWS][NW];
#pragma unroll
      for (int j = 0; j < ROWS; ++j)
#pragma unroll
        for (int w = 0; w < NW; ++w) y[j][w] = pick(j ^ s, v, w);
      if (m) {
#pragma unroll
        for (int j = 0; j < ROWS; ++j)
#pragma unroll
          for (int w = 0; w < NW; ++w)
            y[j][w] = fetch(y[j][w], j ^ s, v, w, m);
      }
#pragma unroll
      for (int j = 0; j < ROWS; ++j) {
        if (TWO)
          AR::fma2(fd, a[j], c[j], y[j], x[j][v]);
        else
          AR::fma1(fd, c[j], y[j], x[j][v]);
      }
    }
  }
};

#ifdef __CUDACC__

struct Shuffle {
  __device__ __forceinline__ uint32_t operator()(uint32_t value, int, int,
                                                 int, int m) const {
    return __shfl_xor_sync(0xFFFFFFFFu, value, m);
  }
};

// One block of the cascade (launched with grid(A, B, V): chunks x
// per_chunk blocks of `warps` warps, shared_bytes(lv, NW) of dynamic
// shared memory): every thread loads its tile and stages its share of the
// coefficient rows, one barrier, then each warp with lanes runs the levels
// and stores its tile.
template <class AR, int V>
__device__ __forceinline__ void cascade(const typename AR::Consts& fd,
                                        const Levels& lv,
                                        const int32_t* __restrict__ cw,
                                        const int32_t* __restrict__ aw,
                                        int32_t* state, int start, int A,
                                        int B, bool vec) {
  extern __shared__ uint32_t staged[];
  const Grid g = grid(A, B, V);
  int q0, b0;
  place(g, blockIdx.x, threadIdx.x / WARP, V, q0, b0);
  const int t = threadIdx.x % WARP;
  const int rows = A - q0 < CHUNK ? A - q0 : CHUNK;
  const int64_t row0 = static_cast<int64_t>(start) + q0;
  const bool live = b0 < B;  // the same for the whole warp
  Tile<AR, V> tile;
  if (live) tile.load(state, row0, t, rows, b0, B, vec);
  const int items = slots(lv) * CHUNK;
  for (int i = threadIdx.x; i < items; i += blockDim.x)
    stage<AR>(i, lv.k, cw, aw, q0, A, staged);
  __syncthreads();
  if (!live) return;
  int ai = 0;
#pragma unroll 1  // one level an iteration, as tools/sass_count.py walks it
  for (int li = 0; li < lv.k; ++li) {
    const bool two = lv.kind[li] != 0;
    tile.level(fd, staged + li * AR::NW * CHUNK,
               staged + (lv.k + ai) * AR::NW * CHUNK, t, lv.half[li], two,
               Shuffle{});
    ai += two;
  }
  tile.store(state, row0, t, rows, b0, B, vec);
}

#endif  // __CUDACC__

}  // namespace wc
