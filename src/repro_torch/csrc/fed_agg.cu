/*
 * fed_agg — weighted federated aggregation for Hopper (sm_90a).
 *
 *     out[d] = sum_c w[c] * u[c, d]      u: (C, D) fp32 row-major
 *                                        w: (C,) fp32     out: (D,) fp32
 *
 * Replaces the TPU kernel repro/kernels/fed_agg/kernel.py:37 fed_agg_pallas
 * (body _agg_kernel).  On the TPU the client axis is a sequential grid axis
 * that carries a VMEM accumulator; here blocks run in parallel in no order,
 * so the client axis is split into chunks reduced by separate blocks and a
 * second pass sums the per-chunk partials in fixed chunk order.
 *
 * What bounds it: device memory.  The work is 2*C*D flops over 4*C*D bytes
 * (0.5 flop per byte), far below the card's ~20 flops per byte of fp32
 * balance.  At the main-path shape (C = 4096 clients, D = 22,026 packed
 * classifier parameters) it reads 360,873,984 + 16,384 bytes and writes
 * 88,104, about 361.0 MB: at 3.35 TB/s a bound of about 108 us.
 *
 * What the design does about that bound:
 *   - neighbouring threads own neighbouring columns, so each warp load is
 *     one coalesced 128-byte transaction and every byte of u is read once;
 *   - each thread owns kCols columns spaced kThreads apart and unrolls the
 *     client loop, which keeps several independent loads in flight per
 *     thread to cover memory latency;
 *   - the client axis is split into chunks (grid.y) so the grid has enough
 *     blocks for all 132 SMs even though D alone gives ~11-87 column blocks;
 *     the partials add 2 * n_chunks * D * 4 bytes of traffic (~4% at the
 *     main-path shape);
 *   - no padding: the ragged edges of C and D are masked, offsets are
 *     64-bit.
 *
 * Determinism: no atomics.  Each thread sums its rows in ascending order and
 * the combine pass sums the partials in ascending chunk order, so two
 * launches on the same inputs give bit-identical output.
 *
 * Not yet done (see ROADMAP): vectorised or TMA loads, a persistent grid,
 * and skipping rows whose weight is 0 (on the full-scan path only the
 * received clients, at most clients_per_round of C, carry weight).
 */
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <int kCols>
__global__ void __launch_bounds__(kThreads)
fed_agg_partial(const float* __restrict__ u, const float* __restrict__ w,
                float* __restrict__ dst, int64_t C, int64_t D,
                int64_t rows_per_chunk) {
  const int64_t col0 =
      (int64_t)blockIdx.x * (kThreads * kCols) + threadIdx.x;
  const int64_t chunk = blockIdx.y;
  const int64_t c_begin = chunk * rows_per_chunk;
  const int64_t c_end =
      c_begin + rows_per_chunk < C ? c_begin + rows_per_chunk : C;

  float acc[kCols];
  bool live[kCols];
#pragma unroll
  for (int k = 0; k < kCols; ++k) {
    acc[k] = 0.f;
    live[k] = col0 + (int64_t)k * kThreads < D;
  }

#pragma unroll 4
  for (int64_t c = c_begin; c < c_end; ++c) {
    const float wc = __ldg(w + c);
    const float* row = u + c * D + col0;
#pragma unroll
    for (int k = 0; k < kCols; ++k) {
      if (live[k]) acc[k] = fmaf(wc, __ldg(row + k * kThreads), acc[k]);
    }
  }

  float* out = dst + chunk * D + col0;
#pragma unroll
  for (int k = 0; k < kCols; ++k) {
    if (live[k]) out[k * kThreads] = acc[k];
  }
}

__global__ void __launch_bounds__(kThreads)
fed_agg_combine(const float* __restrict__ partial, float* __restrict__ out,
                int64_t D, int n_chunks) {
  const int64_t d = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (d >= D) return;
  float acc = 0.f;
  for (int s = 0; s < n_chunks; ++s) acc += partial[(int64_t)s * D + d];
  out[d] = acc;
}

}  // namespace

// Returns cudaGetLastError() after the launches (0 = cudaSuccess).  With
// n_chunks == 1 the partial pass writes `out` directly and `partial` is
// unused; otherwise `partial` holds n_chunks * D floats.
extern "C" int fed_agg_f32(const void* u, const void* w, void* out,
                           void* partial, int64_t C, int64_t D,
                           int64_t rows_per_chunk, int n_chunks,
                           int cols_per_thread, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (D <= 0 || n_chunks < 1 || rows_per_chunk < 1)
    return (int)cudaErrorInvalidValue;
  const float* uf = (const float*)u;
  const float* wf = (const float*)w;
  float* dst = n_chunks > 1 ? (float*)partial : (float*)out;
  const int64_t cols_per_block = (int64_t)kThreads * cols_per_thread;
  const dim3 grid((unsigned)((D + cols_per_block - 1) / cols_per_block),
                  (unsigned)n_chunks);
  switch (cols_per_thread) {
    case 1:
      fed_agg_partial<1><<<grid, kThreads, 0, s>>>(uf, wf, dst, C, D,
                                                   rows_per_chunk);
      break;
    case 2:
      fed_agg_partial<2><<<grid, kThreads, 0, s>>>(uf, wf, dst, C, D,
                                                   rows_per_chunk);
      break;
    case 4:
      fed_agg_partial<4><<<grid, kThreads, 0, s>>>(uf, wf, dst, C, D,
                                                   rows_per_chunk);
      break;
    case 8:
      fed_agg_partial<8><<<grid, kThreads, 0, s>>>(uf, wf, dst, C, D,
                                                   rows_per_chunk);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_chunks == 1) return (int)err;
  fed_agg_combine<<<(unsigned)((D + kThreads - 1) / kThreads), kThreads, 0,
                    s>>>(dst, (float*)out, D, n_chunks);
  return (int)cudaGetLastError();
}
