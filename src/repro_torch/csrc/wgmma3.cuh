/*
 * fp32 products on the bf16 tensor cores, shared by the fp32 flash
 * kernels (flash_attention.cu's flash_fwd_f32, flash_attention_bwd.cu's
 * flash_bwd_f32_dq / _dkdv): every fp32 factor in three bf16 terms, t0 =
 * bf16(x), t1 = bf16(x - t0), t2 = bf16(x - t0 - t1) (each remainder
 * exact in fp32, so t0 + t1 + t2 holds x to 2^-24 of it), and a product
 * as its six term products with i + j <= 2 summed in fp32 accumulators.
 *
 * flash_split3 writes fp32 tensors as three bf16 term planes for TMA;
 * pack3 splits an accumulator (P, dS) in registers into the A fragments
 * of the next product; wgmma_ss3 / wgmma_rs3 issue the six term products
 * of one tile.
 *
 * The tensor cores' fp32 sum is not fp32's: a wgmma adds its products to
 * the accumulator and truncates, so a sum that runs through hundreds of
 * wgmma drifts toward zero (a float64 model of truncation after each
 * k-step puts the backward's dq, dk and dv 4-19x as far from float64 as
 * plain fp32; an H100 read 2.3-5.9x, growing with S, before the next two
 * rules).  So (1) the small term products (i + j >= 1, 2^-8 of the main
 * one and below) go first, while the accumulator is small, and the main
 * one t0 t0 last; (2) no accumulator runs through more than one tile:
 * each tile's product lands in a zeroed partial that the kernel adds to
 * its fp32 sum in registers (round to nearest).  The float64 mirrors of
 * these rounding points are kernels/flash_attention/ref.py's _tc_product,
 * attention_fwd_f32_mirror and attention_bwd_f32_mirror.
 */
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace hopper {

constexpr int kTerms = 3;
constexpr int kSplitThreads = 256;

template <int N>
__device__ __forceinline__ void zero(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) r[i] = 0.f;
}

// (a, b) as three bf16 pairs t0, t1, t2
__device__ __forceinline__ void split3_bf16(float a, float b, uint32_t& t0,
                                            uint32_t& t1, uint32_t& t2) {
  __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  a -= hf.x;
  b -= hf.y;
  __nv_bfloat162 m = __floats2bfloat162_rn(a, b);
  const float2 mf = __bfloat1622float2(m);
  __nv_bfloat162 l = __floats2bfloat162_rn(a - mf.x, b - mf.y);
  t0 = *reinterpret_cast<uint32_t*>(&h);
  t1 = *reinterpret_cast<uint32_t*>(&m);
  t2 = *reinterpret_cast<uint32_t*>(&l);
}

// Up to four fp32 (B, H, S, D) tensors as three bf16 planes each, into
// (3, B, H, S, D) contiguous buffers that TMA reads as (3 B, H, S, D).
// Memory-bound (4 bytes an element in, 6 out): a lane takes four columns
// of a row at a time (a float4 in, three 8-byte stores out), the warps
// walk the tensors' rows
struct SplitParams {
  const float* src[4];           // strided, last axis contiguous
  __nv_bfloat16* dst[4];
  int64_t st[4][3];              // element strides (batch, head, seq)
  int64_t H[4], S[4], rows[4];   // rows = B H S
  int count;                     // tensors, at most 4
  int D;
};

static __global__ void __launch_bounds__(kSplitThreads)
flash_split3(const SplitParams p) {
  // a warp takes 32 / (D / 4) rows at once where that divides (D 32, 64,
  // 128), else one row at a time, a lane a float4 of a row
  const int q4 = p.D / 4;
  const int lane = threadIdx.x & 31;
  const int per = 32 % q4 == 0 ? 32 / q4 : 1;
  const int c0 = per > 1 ? lane % q4 : lane;
  const int64_t warps = (int64_t)gridDim.x * (kSplitThreads / 32) * per;
  const int64_t first = ((int64_t)blockIdx.x * (kSplitThreads / 32) +
                         threadIdx.x / 32) * per + (per > 1 ? lane / q4 : 0);
  for (int x = 0; x < p.count; ++x) {
    const int64_t S = p.S[x], H = p.H[x];
    const int64_t plane = p.rows[x] * q4;       // uint2 (4 bf16) a plane
    uint2* dst = reinterpret_cast<uint2*>(p.dst[x]);
    for (int64_t row = first; row < p.rows[x]; row += warps) {
      const float4* src = reinterpret_cast<const float4*>(
          p.src[x] + (row / (S * H)) * p.st[x][0] +
          ((row / S) % H) * p.st[x][1] + (row % S) * p.st[x][2]);
      for (int c = c0; c < q4; c += 32) {
        const float4 v = src[c];
        uint2 t0, t1, t2;
        split3_bf16(v.x, v.y, t0.x, t1.x, t2.x);
        split3_bf16(v.z, v.w, t0.y, t1.y, t2.y);
        const int64_t o = row * q4 + c;
        dst[o] = t0;
        dst[plane + o] = t1;
        dst[2 * plane + o] = t2;
      }
    }
  }
}

// the split's launch: 8 blocks of 256 an SM of the H100's 132, each
// thread 16 bytes at a time
inline int launch_split3(const SplitParams& p, cudaStream_t stream) {
  flash_split3<<<132 * 8, kSplitThreads, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

// acc = A B^T over D from the terms of both factors (A_i B_j, i + j <= 2,
// the main pair last), into the accumulator, which the first wgmma
// overwrites; A and B K-major, their boxes a_box / b_box and their term
// planes a_plane / b_plane bytes apart; launched, not committed
template <int N, int KS>
__device__ __forceinline__ void wgmma_ss3(float (&acc)[N / 2], uint32_t a_addr,
                                          int a_box, int a_plane,
                                          uint32_t b_addr, int b_box,
                                          int b_plane) {
#pragma unroll
  for (int main = 0; main < 2; ++main)
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const uint32_t off = (kk & 3) * 32;
#pragma unroll
      for (int i = 0; i < kTerms; ++i)
#pragma unroll
        for (int j = 0; i + j < kTerms; ++j)
          if ((i + j == 0) == (main == 1))
            mma_ss<N>(acc,
                      desc_sw128(a_addr + i * a_plane + (kk >> 2) * a_box + off,
                                 16, 1024),
                      desc_sw128(b_addr + j * b_plane + (kk >> 2) * b_box + off,
                                 16, 1024),
                      main || kk > 0 || i + j > 1 || i > 0);
    }
}

// acc += A B, A from registers in its three terms (K columns), B (K rows
// x N) MN-major in its three term planes b_plane bytes apart, the pairs
// as in wgmma_ss3; acc is a tile's zeroed partial; launched, not
// committed
template <int K, int N>
__device__ __forceinline__ void wgmma_rs3(float (&acc)[N / 2],
                                          const uint32_t (&a)[kTerms][K / 16][4],
                                          uint32_t b_addr, int b_box,
                                          int b_plane) {
#pragma unroll
  for (int main = 0; main < 2; ++main)
#pragma unroll
    for (int kk = 0; kk < K / 16; ++kk)
#pragma unroll
      for (int i = 0; i < kTerms; ++i)
#pragma unroll
        for (int j = 0; i + j < kTerms; ++j)
          if ((i + j == 0) == (main == 1))
            mma_rs<N>(acc, a[i][kk],
                      desc_sw128(b_addr + j * b_plane + kk * 16 * 128, b_box,
                                 1024));
}

// the accumulator of BK columns as the A fragments of BK / 16 k-steps, in
// three bf16 terms (pack_p's layout)
template <int BK>
__device__ __forceinline__ void pack3(const float (&x)[BK / 2],
                                      uint32_t (&a)[kTerms][BK / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      split3_bf16(x[8 * kk + 2 * i], x[8 * kk + 2 * i + 1], a[0][kk][i],
                  a[1][kk][i], a[2][kk][i]);
}

}  // namespace hopper
