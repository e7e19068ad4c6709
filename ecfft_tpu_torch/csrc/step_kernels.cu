// The schedule machine's affine steps, for Hopper (sm_90a).
//
// Five kernels write the window [start, start + A) of a (W, L, B) int32
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
//
// with C/A/B (A, L) coefficient rows and x1, x2 (A, L, B) windows. The
// in-place kernels take gathered windows in buffers of their own. The
// muladd pair writes rows [s, s + A) of `out`: a buffer of its own, or the
// state itself, where x1 may be the very window it writes (each thread
// reads the one element it then overwrites, as aff1s does). The field
// arithmetic is field_arith.cuh's.
//
// What bounds it on the H100. Per output element a step moves 192 bytes
// (16 limbs each of x2 and x1 in, 16 out; the coefficient rows are read
// once per row, a broadcast to the lanes) and runs 256 (aff1) or 512
// (aff2) 32x32->64-bit multiply-adds plus the carries and the fold: a
// thread issues about 1040 (aff1) and 1300 (aff2) instructions, a third
// (aff1) or a half (aff2) of them on the FMA pipe. At 132 SMs x 128 issue
// lanes x 1.98 GHz that is 0.52 and 0.65 ms at A 65536, B 256, against
// 0.96 ms of bytes at 3.35 TB/s: the memory bound binds, and the separate
// gathers add 128 bytes per element of pure movement.
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
// The muladd pair is aff1g's and aff2g's kernel with an output of the
// caller's choosing as its "state": the same bytes, the same design.
//
// The kernels allocate nothing and launch on the caller's stream; each
// launcher returns cudaGetLastError() so a refused launch is reported.

#include <cuda_runtime.h>

#include "field_arith.cuh"

constexpr int THREADS = 256;

namespace {

// KIND 0: x1 is the state element itself (aff1s); 1: x1 + C*x2 (aff1g,
// muladd1); 2: A*x1 + B*x2 (aff2g, muladd2). The window is rows [start,
// start + A) of `state`: the schedule's state in place, or (start 0) a
// buffer of its own.
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

const char* ecfft_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
