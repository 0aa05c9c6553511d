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
 *     one coalesced transaction and every byte of u is read once;
 *   - loads are 8-byte float2s where D is even and u starts 8-byte
 *     aligned: then every row starts 8-byte aligned, whatever c * D mod 4
 *     (the main path's D = 22,026 is 2 mod 4, so 16-byte loads would need
 *     a peeled head on every other row); odd D and misaligned bases take
 *     scalar loads.  Each thread owns kGroups vectors spaced a block's
 *     width apart and loads kRows rows of them before it adds any, 128
 *     bytes in flight per thread per iteration of the row loop;
 *   - the grid is one whole wave of one block an SM: the wrapper splits
 *     the client axis into as many chunks as fill 132 SMs with the column
 *     blocks (12 chunks x 11 column blocks at the main path), each chunk a
 *     whole number of block_c rows, the chunks' sizes within block_c of
 *     each other.  256 threads x 128 bytes keep 32 KB in flight on each
 *     SM, and the partials add only 2 * n_chunks * D * 4 bytes of traffic
 *     (0.6% at the main-path shape).  On the H100 this measured faster
 *     than 2, 3 or 4 blocks an SM (more chunks, more partials) and than
 *     64 or 256 bytes in flight a thread.  At the cohort shape C = 512
 *     two or four times the chunks, or narrower column blocks, measured
 *     within 10% of it (tools/fed_agg_probe.py), and summing the
 *     partials in the last block of each column block, instead of in a
 *     second launch, measured slower;
 *   - no padding: the ragged edges of C and D are masked, offsets are
 *     64-bit.
 *
 * Determinism: no atomics.  Each thread sums its rows in ascending order and
 * the combine pass sums the partials in ascending chunk order, so two
 * launches on the same inputs give bit-identical output.  Rows whose weight
 * is 0 are read like any other, so a NaN in one reaches the output as it
 * does in fed_agg_ref (0 * NaN).
 *
 * Rows whose weight is 0 are not skipped.  The compact-cohort path
 * (FLConfig.cohort_size = X) hands the kernel only the (X, D) rows it
 * gathered for the round's selected clients, at most X of which carry
 * weight: at the main path's X = 512 that is 45.1 MB, not the full scan's
 * 361 MB, and the wrapper's split still gives whole block_c chunks (12 of
 * 40-48 rows at D = 22,026).  On the full scan only the received clients,
 * at most clients_per_round of C, carry weight (see ROADMAP).
 */
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMinBlocks = 1;    // blocks of the wave on each SM

template <int kVec> struct Vec;
template <> struct Vec<1> {
  using T = float;
  static __device__ __forceinline__ T load(const float* p) {
    return __ldcs(p);
  }
  static __device__ __forceinline__ float at(const T& x, int) { return x; }
  static __device__ __forceinline__ T zero() { return 0.f; }
};
template <> struct Vec<2> {
  using T = float2;
  static __device__ __forceinline__ T load(const float* p) {
    return __ldcs(reinterpret_cast<const float2*>(p));
  }
  static __device__ __forceinline__ float at(const T& x, int i) {
    return i == 0 ? x.x : x.y;
  }
  static __device__ __forceinline__ T zero() { return make_float2(0.f, 0.f); }
};

template <int kVec, int kGroups>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
fed_agg_partial(const float* __restrict__ u, const float* __restrict__ w,
                float* __restrict__ dst, int64_t C, int64_t D,
                int64_t block_c, int64_t row_blocks) {
  using V = Vec<kVec>;
  // rows loaded before any is added: kRows * kVec * kGroups * 4 = 128 B
  constexpr int kRows = 32 / (kVec * kGroups);
  constexpr int kStride = kThreads * kVec;      // columns between groups
  const int64_t col0 = (int64_t)blockIdx.x * (kStride * kGroups) +
                       (int64_t)threadIdx.x * kVec;
  const int64_t chunk = blockIdx.y;
  const int64_t n_chunks = gridDim.y;
  const int64_t c_begin = block_c * (chunk * row_blocks / n_chunks);
  const int64_t c_stop = block_c * ((chunk + 1) * row_blocks / n_chunks);
  const int64_t c_end = c_stop < C ? c_stop : C;

  float acc[kGroups][kVec];
  bool live[kGroups];
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
    // D is even whenever kVec == 2, so a pair is wholly in or out
    live[g] = col0 + (int64_t)g * kStride < D;
#pragma unroll
    for (int i = 0; i < kVec; ++i) acc[g][i] = 0.f;
  }

  int64_t c = c_begin;
  for (; c + kRows <= c_end; c += kRows) {
    typename V::T x[kRows][kGroups];
    float wc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      wc[r] = __ldg(w + c + r);
      const float* row = u + (c + r) * D + col0;
#pragma unroll
      for (int g = 0; g < kGroups; ++g)
        x[r][g] = live[g] ? V::load(row + g * kStride) : V::zero();
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int g = 0; g < kGroups; ++g)
#pragma unroll
        for (int i = 0; i < kVec; ++i)
          acc[g][i] = fmaf(wc[r], V::at(x[r][g], i), acc[g][i]);
  }
  for (; c < c_end; ++c) {
    const float wc = __ldg(w + c);
    const float* row = u + c * D + col0;
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      if (live[g]) {
        const typename V::T x = V::load(row + g * kStride);
#pragma unroll
        for (int i = 0; i < kVec; ++i)
          acc[g][i] = fmaf(wc, V::at(x, i), acc[g][i]);
      }
    }
  }

  float* out = dst + chunk * D + col0;
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
    if (live[g]) {
#pragma unroll
      for (int i = 0; i < kVec; ++i) out[g * kStride + i] = acc[g][i];
    }
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

template <int kVec, int kGroups>
void launch_partial(dim3 grid, cudaStream_t s, const float* u,
                    const float* w, float* dst, int64_t C, int64_t D,
                    int64_t block_c, int64_t row_blocks) {
  fed_agg_partial<kVec, kGroups><<<grid, kThreads, 0, s>>>(
      u, w, dst, C, D, block_c, row_blocks);
}

}  // namespace

// Returns cudaGetLastError() after the launches (0 = cudaSuccess).  The
// client axis is row_blocks blocks of block_c rows; chunk i of n_chunks
// covers row blocks [i * row_blocks / n_chunks, (i + 1) * row_blocks /
// n_chunks).  vec 2 (float2 loads) needs an even D and an 8-byte-aligned
// u.  With n_chunks == 1 the partial pass writes `out` directly and
// `partial` is unused; otherwise `partial` holds n_chunks * D floats.
extern "C" int fed_agg_f32(const void* u, const void* w, void* out,
                           void* partial, int64_t C, int64_t D,
                           int64_t block_c, int64_t row_blocks, int n_chunks,
                           int cols_per_thread, int vec, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (D <= 0 || n_chunks < 1 || n_chunks > 65535 || block_c < 1 ||
      row_blocks < 1 || (vec == 2 && (D % 2 || (uintptr_t)u % 8)))
    return (int)cudaErrorInvalidValue;
  const float* uf = (const float*)u;
  const float* wf = (const float*)w;
  float* dst = n_chunks > 1 ? (float*)partial : (float*)out;
  const int64_t cols_per_block = (int64_t)kThreads * cols_per_thread;
  const dim3 grid((unsigned)((D + cols_per_block - 1) / cols_per_block),
                  (unsigned)n_chunks);
  const int variant = vec * 100 + cols_per_thread;
  switch (variant) {
    case 101: launch_partial<1, 1>(grid, s, uf, wf, dst, C, D, block_c,
                                   row_blocks); break;
    case 102: launch_partial<1, 2>(grid, s, uf, wf, dst, C, D, block_c,
                                   row_blocks); break;
    case 104: launch_partial<1, 4>(grid, s, uf, wf, dst, C, D, block_c,
                                   row_blocks); break;
    case 108: launch_partial<1, 8>(grid, s, uf, wf, dst, C, D, block_c,
                                   row_blocks); break;
    case 202: launch_partial<2, 1>(grid, s, uf, wf, dst, C, D, block_c,
                                   row_blocks); break;
    case 204: launch_partial<2, 2>(grid, s, uf, wf, dst, C, D, block_c,
                                   row_blocks); break;
    case 208: launch_partial<2, 4>(grid, s, uf, wf, dst, C, D, block_c,
                                   row_blocks); break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_chunks == 1) return (int)err;
  fed_agg_combine<<<(unsigned)((D + kThreads - 1) / kThreads), kThreads, 0,
                    s>>>(dst, (float*)out, D, n_chunks);
  return (int)cudaGetLastError();
}
