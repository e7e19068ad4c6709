// The schedule machine's affine steps, for Hopper (sm_90a).
//
// Six kernels write the window [start, start + A) of a (W, L, B) int32
// state of 16-bit limbs, for a fold-friendly prime with L = 16:
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
// reads the one element it then overwrites, as aff1s does).
//
// What bounds it on the H100. Per output element a step moves 192 bytes
// (16 limbs each of x2 and x1 in, 16 out; the coefficient rows are read
// once per row, a broadcast to the lanes): 0.96 ms at A 65536, B 256 at
// 3.35 TB/s. The function's work is one (aff1) or two (aff2) products of
// 8-word values, 64 32x32->64-bit word products each, plus the fold's
// products by F's nonzero words: about 0.1 ms at that shape at the
// IMAD.WIDE rate. So every step is bound by its bytes; the separate
// gathers add 128 bytes per element of pure movement.
//
// Two designs. aff1s_kernel (the self-read step, on 32-bit words,
// word_arith.cuh): one thread per element (q, b); it issues all 48 of its
// loads (16 limbs each of x2, its own state element and the coefficient
// row) before the first multiply, so that a warp keeps them in flight
// together, packs them into words, runs one 8x8-word product and the word
// fold, and stores. step_kernel<1>/<2> (aff1g, aff2g and the muladd pair,
// on 16-bit limbs, field_arith.cuh): one thread per element, 32 product
// columns in 64-bit registers (each below 2*16*2^32), so the multiply-adds
// need no carries inside the loop. In the batch-minor layout neighbouring
// threads of a warp are neighbouring lanes b, so each limb load and store
// is one coalesced 128-byte line; the coefficient row of q is the same
// address for the whole warp (a broadcast). The gathered windows stay
// separate buffers because the in-place write races with a fused gather's
// butterfly partner.
//
// The muladd pair is aff1g's and aff2g's kernel with an output of the
// caller's choosing as its "state": the same bytes, the same design.
//
// mulss_kernel (the state x state product, on 32-bit words) has the shape
// of aff1s_kernel's thread: one thread per element, its 32 loads (16 limbs
// of each factor) ahead of the first multiply, one 8x8-word product with a
// zero addend, the word fold, 16 stores. It moves the same 192 bytes per
// element (two factors in, the product out; no coefficient row) and does
// the same word products, so it too is bound by its bytes. Both factors
// are per element, and they may be one buffer (a square): they are only
// read. Neither may overlap the rows that are written.
//
// The kernels allocate nothing and launch on the caller's stream; each
// launcher returns cudaGetLastError() so a refused launch is reported.

#include <cuda_runtime.h>

#include "field_arith.cuh"
#include "word_arith.cuh"

constexpr int THREADS = 256;

namespace {

// blocks of THREADS threads for one thread per element of an A x B window
unsigned blocks_for(int A, int B) {
  return static_cast<unsigned>(
      (static_cast<int64_t>(A) * B + THREADS - 1) / THREADS);
}

// state[s+q] <- state[s+q] + C[q]*x2[q] on 32-bit words. At most 64
// registers a thread (four 256-thread blocks per SM).
__global__ void __launch_bounds__(THREADS, 4)
aff1s_kernel(Field fd, const int32_t* __restrict__ c,
             const int32_t* __restrict__ x2, int32_t* state, int start, int A,
             int B) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  if (e >= static_cast<int64_t>(A) * B) return;  // the ragged edge
  const int64_t q = e / B;
  const int64_t b = e - q * B;
  const int64_t LB = static_cast<int64_t>(NL) * B;
  int32_t* st = state + (start + q) * LB + b;
  const int32_t* xq = x2 + q * LB + b;
  const int32_t* cq = c + q * NL;
  uint32_t ls[NL], lx[NL], lc[NL];
#pragma unroll
  for (int j = 0; j < NL; ++j) {
    ls[j] = static_cast<uint32_t>(st[j * B]);
    lx[j] = static_cast<uint32_t>(__ldg(xq + j * B));
    lc[j] = static_cast<uint32_t>(__ldg(cq + j));
  }
  uint32_t ws[NW], wx[NW], wc[NW], v[NV];
  wa::pack(ls, ws);
  wa::pack(lx, wx);
  wa::pack(lc, wc);
  wa::mul_add(wc, wx, ws, v);
  wa::reduce(fd, v, ws);
  wa::store_words(st, B, ws);
}

// out[s+q] <- x1[q]*x2[q] on 32-bit words; x1 and x2 may be one buffer.
__global__ void __launch_bounds__(THREADS, 4)
mulss_kernel(Field fd, const int32_t* x1, const int32_t* x2, int32_t* out,
             int start, int A, int B) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  if (e >= static_cast<int64_t>(A) * B) return;  // the ragged edge
  const int64_t q = e / B;
  const int64_t b = e - q * B;
  const int64_t LB = static_cast<int64_t>(NL) * B;
  const int32_t* p1 = x1 + q * LB + b;
  const int32_t* p2 = x2 + q * LB + b;
  uint32_t l1[NL], l2[NL];
#pragma unroll
  for (int j = 0; j < NL; ++j) {
    l1[j] = static_cast<uint32_t>(__ldg(p1 + j * B));
    l2[j] = static_cast<uint32_t>(__ldg(p2 + j * B));
  }
  uint32_t w1[NW], w2[NW], v[NV];
  const uint32_t zero[NW] = {0, 0, 0, 0, 0, 0, 0, 0};
  wa::pack(l1, w1);
  wa::pack(l2, w2);
  wa::mul_add(w1, w2, zero, v);
  wa::reduce(fd, v, w1);
  wa::store_words(out + (start + q) * LB + b, B, w1);
}

// KIND 1: x1 + C*x2 (aff1g, muladd1); 2: A*x1 + B*x2 (aff2g, muladd2).
// The window is rows [start, start + A) of `state`: the schedule's state
// in place, or (start 0) a buffer of its own.
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
    const int32_t* w1 = x1 + q * LB + b;
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
  step_kernel<KIND><<<blocks_for(A, B), THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      *fd, ca, cb, state, x1, x2, start, A, B);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int ecfft_aff1s_ip(const Field* fd, const int32_t* c, const int32_t* x2,
                   int32_t* state, int start, int A, int B, void* stream) {
  aff1s_kernel<<<blocks_for(A, B), THREADS, 0,
                 static_cast<cudaStream_t>(stream)>>>(*fd, c, x2, state,
                                                      start, A, B);
  return static_cast<int>(cudaGetLastError());
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

int ecfft_muladd1(const Field* fd, const int32_t* c, const int32_t* x1,
                  const int32_t* x2, int32_t* out, int start, int A, int B,
                  void* stream) {
  return launch<1>(fd, nullptr, c, out, x1, x2, start, A, B, stream);
}

int ecfft_muladd2(const Field* fd, const int32_t* a, const int32_t* b,
                  const int32_t* x1, const int32_t* x2, int32_t* out,
                  int start, int A, int B, void* stream) {
  return launch<2>(fd, a, b, out, x1, x2, start, A, B, stream);
}

int ecfft_mulss(const Field* fd, const int32_t* x1, const int32_t* x2,
                int32_t* out, int start, int A, int B, void* stream) {
  mulss_kernel<<<blocks_for(A, B), THREADS, 0,
                 static_cast<cudaStream_t>(stream)>>>(*fd, x1, x2, out, start,
                                                      A, B);
  return static_cast<int>(cudaGetLastError());
}

const char* ecfft_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
