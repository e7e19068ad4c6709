// The schedule machine's affine steps, for Hopper (sm_90a).
//
// Six kernels, and the pair form of two of them (below), write the window
// [start, start + A) of a (W, L, B) int32 state of 16-bit limbs, for a
// prime of L = NL limbs in the form this library is compiled for
// (word_arith.cuh: the fold or the CIOS form):
//
//   ecfft_aff1s_ip  state[s+q] <- state[s+q] + C[q]*x2[q]   replaces
//                   pallas_aff1s_ip (ecfft_tpu/ops/pallas_step.py:298)
//   ecfft_aff1g_ip  state[s+q] <- x1[q] + C[q]*x2[q]         replaces
//                   pallas_aff1g_ip (pallas_step.py:311)
//   ecfft_aff2g_ip  state[s+q] <- A[q]*x1[q] + B[q]*x2[q]    replaces
//                   pallas_aff2g_ip (pallas_step.py:324)
//   ecfft_muladd1   out[s+q] <- x1[q] + C[q]*x2[q]           replaces
//                   pallas_muladd1 (pallas_step.py:338)
//   ecfft_muladd2   out[s+q] <- A[q]*x1[q] + B[q]*x2[q]      replaces
//                   pallas_muladd2 (pallas_step.py:364)
//   ecfft_mulss     out[s+q] <- x1[q]*x2[q]                  replaces
//                   _mulss (ecfft_tpu/ops/schedule.py:1357), the OP_MUL
//                   step, which the TPU leaves to XLA (no Pallas kernel)
//
// with C/A/B (A, L) coefficient rows and x1, x2 (A, L, B) windows. The
// in-place kernels take gathered windows in buffers of their own. The
// muladd pair writes rows [s, s + A) of `out`: a buffer of its own, or the
// state itself, where x1 may be the very window it writes (each thread
// reads the one element it then overwrites, as aff1s does). In the CIOS
// form every value is in Montgomery form and each product a Montgomery
// product.
//
// What bounds it on the H100. Per output element a step moves 12 L bytes
// (L limbs each of x2 and x1 in, L out; the coefficient rows are read once
// per row, a broadcast to the lanes): 0.96 ms at A 65536, B 256, L 16 at
// 3.35 TB/s. The function's work is one (aff1, mulss) or two (aff2)
// products of NW-word values, NW^2 32x32->64-bit word products each, plus
// the reduction's (the fold's products by F's nonzero words, or CIOS's NW^2
// + NW): about 0.1 ms at that shape at the IMAD.WIDE rate. So every step is
// bound by its bytes; the separate gathers add 8 L bytes per element of
// pure movement.
//
// The design, one template for the six: one thread per element (q, b). It
// issues all of its loads (the L limbs of each input and of its one or two
// coefficient rows) before the first multiply, so that a warp keeps them in
// flight together, packs them into words, runs the product (or two) and
// the reduction (word_arith.cuh: fma1, fma2, mul), and stores. In the
// batch-minor layout neighbouring threads of a warp are neighbouring lanes
// b, so each limb load and store is one coalesced 128-byte line; the
// coefficient row of q is the same address for the whole warp (a
// broadcast). The 1-mul forms are held to 64 registers (four 256-thread
// blocks per SM), the 2-mul form to 80 (three). The muladd pair is aff1g's
// and aff2g's kernel with an output of the caller's choosing as its
// "state". x2 and the rows go through the read-only path; x1 not, since it
// may be the window written (mulss's factors never are, and may be one
// buffer: a square).
//
// The pair form (xor_pair::step_kernel<0> and <2>). Most of the scan
// executor's aff1s steps, and many of its aff2g steps, read x2 inside the
// window they write, at row q ^ h or at row q itself (h a power of two, A
// a multiple of 2h: ENTER's steps read q ^ h on every row, EXIT's on the
// rows a level updates and q on the others), and, for aff2g, x1 at row q:
// each pair of rows {q, q ^ h} is read and written by that step alone.
// Gathered, such a step moves 5 windows (the gather reads the window and
// writes x2, the kernel reads the window and x2 and writes the window; 7
// for aff2g); in place it moves 2:
//
//   ecfft_aff1s_pair_ip  state[s+q] <- state[s+q] + C[q]*state[r[q]]
//   ecfft_aff2g_pair_ip  state[s+q] <- A[q]*state[s+q] + B[q]*state[r[q]]
//
// with r[q] the row that the step's x2 index row names, s + (q ^ h) or s +
// q: a thread reads its row's index, a 4-byte broadcast to the lanes, and
// takes its partner's value or its own.
//
// Its bound is those 2 windows' bytes (8 L bytes an element: 0.64 ms at A
// 65536, B 256, L 16), against the gathered step's 0.96 ms and its
// gather's 0.64 ms. The design is that of fused_kernels.cu's pair_kernel
// in this file's geometry: one thread per element, 256 threads a block,
// the grid one block per 256 elements of the window as the gathered
// form's. Block k takes pair elements [128 k, 128 k + 128) of the A/2 x B
// pairs, the pair i = e / B of element e in lane b = e % B; threads [0,
// 128) take the pairs' rows q = 2 (i & ~(h - 1)) + (i & (h - 1)), threads
// [128, 256) their partners q ^ h = q + h, each in the same lane. So a
// block holds both rows of each of its pairs, min(B, 128) neighbouring
// lanes of each, and its warps' limb loads are coalesced across lanes as
// the gathered form's. A thread issues all its loads (its element's L
// limbs and its one or two coefficient rows) before the first multiply,
// packs them into words and writes its element's NW words to shared
// memory, word k of thread t at [k][t], so that a warp's 32 threads fall
// on 32 banks when storing and when reading the partner's (t ^ 128).
// After the block's one barrier it reads its partner's words, computes
// its new value (from its own words where r[q] is its own row) and stores
// it. A thread past the last pair loads and
// stores nothing but reaches the barrier. Each element is read from
// device memory and written by one thread, and the partner's value
// crosses in shared memory, so the in-place update is race-free. The
// products and sums are the gathered form's, in the same order, so the
// bits are the same. The kernels' own namespace keeps their machine code
// apart from the gathered forms' under one demangled name, step_kernel<K>.
//
// The kernels allocate nothing and launch on the caller's stream; each
// launcher returns cudaGetLastError() (or cudaErrorInvalidValue for field
// constants of another form) so a refused launch is reported.

#include <cuda_runtime.h>

#include "word_arith.cuh"

constexpr int THREADS = 256;

namespace {

enum Kind { AFF1S = 0, AFF1 = 1, AFF2 = 2, MUL = 3 };

// blocks of THREADS threads for one thread per element of an A x B window
unsigned blocks_for(int A, int B) {
  return static_cast<unsigned>(
      (static_cast<int64_t>(A) * B + THREADS - 1) / THREADS);
}

// AFF1S: state + C*x2; AFF1: x1 + C*x2; AFF2: A*x1 + C*x2; MUL: x1*x2.
// The window is rows [start, start + A) of `state`: the schedule's state
// in place, or (start 0) a buffer of its own.
template <int KIND>
__global__ void __launch_bounds__(THREADS, KIND == AFF2 ? 3 : 4)
step_kernel(Field fd, const int32_t* __restrict__ ca,
            const int32_t* __restrict__ cc, const int32_t* x1,
            const int32_t* __restrict__ x2, int32_t* state, int start,
            int A, int B) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  if (e >= static_cast<int64_t>(A) * B) return;  // the ragged edge
  const int64_t q = e / B;
  const int64_t b = e - q * B;
  const int64_t LB = static_cast<int64_t>(NL) * B;
  int32_t* st = state + (start + q) * LB + b;
  const int32_t* p1 = KIND == AFF1S ? st : x1 + q * LB + b;
  const int32_t* p2 = x2 + q * LB + b;
  uint32_t l1[NL], l2[NL], lc[NL], la[NL];
#pragma unroll
  for (int j = 0; j < NL; ++j) {
    l1[j] = static_cast<uint32_t>(KIND == MUL ? __ldg(p1 + j * B)
                                              : p1[j * B]);
    l2[j] = static_cast<uint32_t>(__ldg(p2 + j * B));
    if (KIND != MUL) lc[j] = static_cast<uint32_t>(__ldg(cc + q * NL + j));
    if (KIND == AFF2) la[j] = static_cast<uint32_t>(__ldg(ca + q * NL + j));
  }
  uint32_t w1[NW], w2[NW], wc[NW], wa_[NW];
  wa::pack<NL>(l1, w1);
  wa::pack<NL>(l2, w2);
  if (KIND == MUL) {
    wa::mul<NL, MONT>(fd, w1, w2, w1);
  } else {
    wa::pack<NL>(lc, wc);
    if (KIND == AFF2) {
      wa::pack<NL>(la, wa_);
      wa::fma2<NL, MONT>(fd, wa_, w1, wc, w2, w1);
    } else {
      wa::fma1<NL, MONT>(fd, wc, w2, w1, w1);
    }
  }
  wa::store_words<NL>(st, B, w1);
}

namespace xor_pair {

constexpr int PAIRS = THREADS / 2;  // pair elements a block

// AFF1S: state + C*state[r]; AFF2: A*state + C*state[r], r the row of the
// pair that the index row x2 names. The window is rows [start, start + A)
// of `state`, h a power of two, A % 2h == 0.
template <int KIND>
__global__ void __launch_bounds__(THREADS, KIND == AFF2 ? 3 : 4)
step_kernel(Field fd, const int32_t* __restrict__ ca,
            const int32_t* __restrict__ cc, const int32_t* __restrict__ x2,
            int32_t* state, int start, int h, int A, int B) {
  __shared__ uint32_t xs[NW * THREADS];
  const int tid = threadIdx.x;
  const int64_t e =
      static_cast<int64_t>(blockIdx.x) * PAIRS + (tid & (PAIRS - 1));
  const bool live = e < static_cast<int64_t>(A / 2) * B;
  const int64_t i = e / B;  // the pair
  const int64_t b = e - i * B;
  const int64_t q = 2 * (i & ~static_cast<int64_t>(h - 1)) + (i & (h - 1)) +
                    (tid < PAIRS ? 0 : h);
  const int64_t LB = static_cast<int64_t>(NL) * B;
  int32_t* st = state + (start + q) * LB + b;
  uint32_t w1[NW], wc[NW], wa_[NW];
  bool own = false;  // x2 is this row itself
  if (live) {
    own = __ldg(x2 + q) == start + q;
    uint32_t l1[NL], lc[NL], la[NL];
#pragma unroll
    for (int j = 0; j < NL; ++j) {
      l1[j] = static_cast<uint32_t>(st[j * B]);
      lc[j] = static_cast<uint32_t>(__ldg(cc + q * NL + j));
      if (KIND == AFF2) la[j] = static_cast<uint32_t>(__ldg(ca + q * NL + j));
    }
    wa::pack<NL>(l1, w1);
    wa::pack<NL>(lc, wc);
    if (KIND == AFF2) wa::pack<NL>(la, wa_);
#pragma unroll
    for (int k = 0; k < NW; ++k) xs[k * THREADS + tid] = w1[k];
  }
  __syncthreads();
  if (!live) return;
  uint32_t w2[NW];
#pragma unroll
  for (int k = 0; k < NW; ++k)
    w2[k] = own ? w1[k] : xs[k * THREADS + (tid ^ PAIRS)];
  if (KIND == AFF2)
    wa::fma2<NL, MONT>(fd, wa_, w1, wc, w2, w1);
  else
    wa::fma1<NL, MONT>(fd, wc, w2, w1, w1);
  wa::store_words<NL>(st, B, w1);
}

template <int KIND>
int launch(const Field* fd, const int32_t* ca, const int32_t* cc,
           const int32_t* x2, int32_t* state, int start, int h, int A, int B,
           void* stream) {
  if (h <= 0 || (h & (h - 1)) != 0 || A % (2 * h) != 0 || fd->nw != NW ||
      fd->mont != MONT)
    return static_cast<int>(cudaErrorInvalidValue);
  step_kernel<KIND><<<blocks_for(A, B), THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      *fd, ca, cc, x2, state, start, h, A, B);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace xor_pair

template <int KIND>
int launch(const Field* fd, const int32_t* ca, const int32_t* cc,
           const int32_t* x1, const int32_t* x2, int32_t* state, int start,
           int A, int B, void* stream) {
  if (fd->nw != NW || fd->mont != MONT)
    return static_cast<int>(cudaErrorInvalidValue);
  step_kernel<KIND><<<blocks_for(A, B), THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      *fd, ca, cc, x1, x2, state, start, A, B);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int ecfft_aff1s_ip(const Field* fd, const int32_t* c, const int32_t* x2,
                   int32_t* state, int start, int A, int B, void* stream) {
  return launch<AFF1S>(fd, nullptr, c, nullptr, x2, state, start, A, B,
                       stream);
}

int ecfft_aff1g_ip(const Field* fd, const int32_t* c, const int32_t* x1,
                   const int32_t* x2, int32_t* state, int start, int A,
                   int B, void* stream) {
  return launch<AFF1>(fd, nullptr, c, x1, x2, state, start, A, B, stream);
}

int ecfft_aff2g_ip(const Field* fd, const int32_t* a, const int32_t* b,
                   const int32_t* x1, const int32_t* x2, int32_t* state,
                   int start, int A, int B, void* stream) {
  return launch<AFF2>(fd, a, b, x1, x2, state, start, A, B, stream);
}

int ecfft_muladd1(const Field* fd, const int32_t* c, const int32_t* x1,
                  const int32_t* x2, int32_t* out, int start, int A, int B,
                  void* stream) {
  return launch<AFF1>(fd, nullptr, c, x1, x2, out, start, A, B, stream);
}

int ecfft_muladd2(const Field* fd, const int32_t* a, const int32_t* b,
                  const int32_t* x1, const int32_t* x2, int32_t* out,
                  int start, int A, int B, void* stream) {
  return launch<AFF2>(fd, a, b, x1, x2, out, start, A, B, stream);
}

int ecfft_mulss(const Field* fd, const int32_t* x1, const int32_t* x2,
                int32_t* out, int start, int A, int B, void* stream) {
  return launch<MUL>(fd, nullptr, nullptr, x1, x2, out, start, A, B,
                     stream);
}

int ecfft_aff1s_pair_ip(const Field* fd, const int32_t* c,
                        const int32_t* x2, int32_t* state, int start, int h,
                        int A, int B, void* stream) {
  return xor_pair::launch<AFF1S>(fd, nullptr, c, x2, state, start, h, A, B,
                                 stream);
}

int ecfft_aff2g_pair_ip(const Field* fd, const int32_t* a, const int32_t* b,
                        const int32_t* x2, int32_t* state, int start, int h,
                        int A, int B, void* stream) {
  return xor_pair::launch<AFF2>(fd, a, b, x2, state, start, h, A, B,
                                stream);
}

const char* ecfft_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
