/*
 * residual_norms — per-client residual norms for Hopper (sm_90a).
 *
 *     out[c] = sqrt( sum_d (u[c, d] - z[d])^2 )   u: (C, D) fp32 row-major
 *                                                 z: (D,) fp32  out: (C,) fp32
 *
 * Replaces the TPU kernel repro/kernels/robust_agg/kernel.py:42
 * residual_norms_pallas (body _dist_kernel).  On the TPU the D axis is the
 * sequential inner grid axis and a (BC,) VMEM scratch carries each client
 * block's sum of squares across it.  Here one CUDA block owns one client
 * row whole, so the sum never leaves the block: a stride loop in each
 * thread, then a reduction inside the block, then one sqrt.
 *
 * What bounds it: device memory.  The work is 3*C*D flops over 4*C*D
 * bytes (0.75 flop per byte), far below the card's ~20 flops per byte of
 * fp32 balance.  At the main-path shape (C = 4096 clients, D = 22,026
 * packed classifier parameters) it reads 360,873,984 + 88,104 bytes and
 * writes 16,384: at 3.35 TB/s a bound of about 108 us.
 *
 * What the design does about that bound:
 *   - neighbouring threads read neighbouring elements of the row, so each
 *     warp load is one coalesced 128-byte transaction and every byte of u
 *     is read once;
 *   - each thread keeps four independent loads in flight (the stride loop
 *     is unrolled by four into four accumulators) to cover memory latency;
 *   - z (88 KB at the main shape) is read by every block and stays in L2;
 *   - loads are scalar: a row starts at c*D floats, and D (22,026 on the
 *     main path) need not be a multiple of 4, so a vector load of u would
 *     be misaligned on some rows and z's alignment differs from the row's;
 *   - no padding: the ragged end of the row is masked, offsets are 64-bit.
 *
 * Determinism: no atomics.  Each thread's four accumulators, the warp
 * shuffle tree and the sum of the warps' partials in shared memory run in
 * an order fixed by D and the block size alone, so two launches on the
 * same inputs give bit-identical output (trust scores and the Weiszfeld
 * iterates feed the next round).
 *
 * Not yet done (see ROADMAP): fusing the Weiszfeld step's norm and its
 * weighted sum into one pass over u, and skipping rows whose weight is 0.
 */
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
residual_norms_rows(const float* __restrict__ u, const float* __restrict__ z,
                    float* __restrict__ out, int64_t D) {
  const int64_t c = blockIdx.x;
  const float* __restrict__ row = u + c * D;
  float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
  int64_t d = threadIdx.x;
  for (; d + 3 * kThreads < D; d += 4 * kThreads) {
    const float r0 = __ldg(row + d) - __ldg(z + d);
    const float r1 = __ldg(row + d + kThreads) - __ldg(z + d + kThreads);
    const float r2 =
        __ldg(row + d + 2 * kThreads) - __ldg(z + d + 2 * kThreads);
    const float r3 =
        __ldg(row + d + 3 * kThreads) - __ldg(z + d + 3 * kThreads);
    a0 = fmaf(r0, r0, a0);
    a1 = fmaf(r1, r1, a1);
    a2 = fmaf(r2, r2, a2);
    a3 = fmaf(r3, r3, a3);
  }
  for (; d < D; d += kThreads) {
    const float r = __ldg(row + d) - __ldg(z + d);
    a0 = fmaf(r, r, a0);
  }
  float acc = (a0 + a1) + (a2 + a3);

#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_down_sync(0xffffffffu, acc, off);

  __shared__ float warp_sum[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sum[warp] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total += warp_sum[w];
    out[c] = sqrtf(total);
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = cudaSuccess).  The
// caller handles C == 0 and D == 0 without a launch.
extern "C" int residual_norms_f32(const void* u, const void* z, void* out,
                                  int64_t C, int64_t D, void* stream) {
  if (C <= 0 || D <= 0 || C > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  residual_norms_rows<<<(unsigned)C, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)u, (const float*)z, (float*)out, D);
  return (int)cudaGetLastError();
}
