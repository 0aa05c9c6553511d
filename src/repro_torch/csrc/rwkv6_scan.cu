/*
 * rwkv6_scan — the WKV6 recurrence for Hopper (sm_90a).
 *
 *     y_t = r_t . (S_{t-1} + diag(u) k_t v_t^T),
 *     S_t = diag(exp(logw_t)) S_{t-1} + k_t v_t^T
 *
 *     r, k, v, logw: (B, H, S, D), u: (H, D) fp32, s0: (B, H, D, D) fp32 or
 *     null (zeros) -> y (B, H, S, D) fp32, s_final (B, H, D, D) fp32.
 *     r, k, v, logw and y are strided views whose last axis is contiguous;
 *     r, k and v are fp32 or bf16 (one dtype), logw fp32 or bf16, all
 *     computed in fp32.  D in {32, 64}: rwkv6-7b's heads (64) and its
 *     reduced() variant's (32).
 *
 * Replaces the TPU kernel repro/kernels/rwkv6_scan/kernel.py:55
 * rwkv6_scan_pallas (body _wkv_kernel), which runs the exact per-step
 * recurrence over VMEM-resident chunks with the (D, D) state in VMEM
 * scratch across a sequential chunk axis.  This kernel runs the same
 * per-step recurrence, in the shape of the public RWKV6 CUDA kernel
 * (wkv6_cuda.cu of BlinkDL's RWKV-LM):
 *   - one block of D threads owns one (batch, head) and walks all of S;
 *     thread j owns column j of the state, S[i][j] for every i, in D
 *     registers, so the state never leaves the SM until the end;
 *   - r, k, w = exp(logw) and v of 32 timesteps are staged in shared
 *     memory with coalesced loads (thread j loads element j of each row),
 *     then each step reads r_i, k_i, w_i, u_i as float4 broadcasts;
 *   - per step thread j computes y_j = sum_i r_i (S_ij + u_i k_i v_j) with
 *     no cross-thread reduction, then S_ij <- w_i S_ij + k_i v_j; the sum
 *     runs in four interleaved partial sums (i mod 4), added in a fixed
 *     order, to shorten the dependent FMA chain;
 *   - the ragged end of S is masked (a partial last tile), never padded;
 *     every tensor is read and written through its strides, so the
 *     model's (B, S, H, D) layout needs no transpose;
 *   - no atomics: two launches give bit-identical output.
 *
 * What bounds it.  At the rwkv6-7b prefill shape (B 4, S 2048, H 64, D 64,
 * bf16 r/k/v, fp32 logw, no s0) the function reads and writes 473,972,736
 * bytes, 141.5 us at 3.35 TB/s.  Its chunked form (wkv_chunked in
 * repro/models/rwkv.py, chunk 64) needs 1.295e10 flops of matrix products,
 * 13.1 us on bf16 tensor cores, so the function is bound by its bytes.
 * This kernel runs the per-step form instead, which has no matrix product:
 * 5 D^2 flops a step and head at the least (r.S, w.S + k v^T), 160.3 us
 * at fp32's 67 TFLOP/s, and 7 D^2 as written here.  The grid is
 * B * H = 256 blocks of 64 threads on 132 SMs: about
 * four warps an SM, too few to hide the latency of the dependent FMAs and
 * of the shared-memory broadcasts, so the kernel is latency-bound.  Left
 * to a redesign (ROADMAP Queue B #5): a chunked form on tensor cores that
 * keeps every exponent <= 0 (as wkv_chunked in repro/models/rwkv.py does,
 * since the product form e^{cums_t} e^{-cums_j} overflows), more blocks
 * than B * H (split the state's columns over blocks), and a decode
 * kernel for the S = 1 step.
 */
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kT = 32;           // timesteps staged at once

struct Params {
  const void* r;
  const void* k;
  const void* v;
  const void* lw;
  const float* u;                // (H, D) contiguous
  const float* s0;               // (B, H, D, D) contiguous, or null
  float* y;
  float* sf;                     // (B, H, D, D) contiguous
  int64_t srb, srh, srs;         // strides in elements: batch, head, seq
  int64_t skb, skh, sks;
  int64_t svb, svh, svs;
  int64_t swb, swh, sws;
  int64_t syb, syh, sys;
  int64_t S;
  int H;
};

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <typename T, typename TW, int D>
__global__ void __launch_bounds__(D)
wkv_fwd(const Params p) {
  static_assert(D % 4 == 0 && D <= 64, "D a multiple of 4, at most 64");
  __shared__ __align__(16) float rs[kT][D];
  __shared__ __align__(16) float ks[kT][D];
  __shared__ __align__(16) float ws[kT][D];
  __shared__ float vs[kT][D];
  __shared__ __align__(16) float us[D];

  const int j = threadIdx.x;
  const int h = blockIdx.x;
  const int64_t b = blockIdx.y;
  const T* rg = static_cast<const T*>(p.r) + b * p.srb + h * p.srh;
  const T* kg = static_cast<const T*>(p.k) + b * p.skb + h * p.skh;
  const T* vg = static_cast<const T*>(p.v) + b * p.svb + h * p.svh;
  const TW* wg = static_cast<const TW*>(p.lw) + b * p.swb + h * p.swh;
  float* yg = p.y + b * p.syb + h * p.syh;
  const int64_t so = (b * p.H + h) * (int64_t)(D * D);

  float st[D];                   // st[i] = S[i][j]
#pragma unroll
  for (int i = 0; i < D; ++i) st[i] = p.s0 ? p.s0[so + i * D + j] : 0.f;
  us[j] = p.u[h * D + j];

  for (int64_t t0 = 0; t0 < p.S; t0 += kT) {
    const int Tc = (int)(p.S - t0 < kT ? p.S - t0 : kT);
    __syncthreads();             // the last tile's readers are done
    for (int t = 0; t < Tc; ++t) {
      const int64_t s = t0 + t;
      rs[t][j] = ld(rg + s * p.srs + j);
      ks[t][j] = ld(kg + s * p.sks + j);
      vs[t][j] = ld(vg + s * p.svs + j);
      ws[t][j] = expf(ld(wg + s * p.sws + j));
    }
    __syncthreads();
    for (int t = 0; t < Tc; ++t) {
      const float vj = vs[t][j];
      float y[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int i = 0; i < D; i += 4) {
        const float4 r4 = *reinterpret_cast<const float4*>(&rs[t][i]);
        const float4 k4 = *reinterpret_cast<const float4*>(&ks[t][i]);
        const float4 w4 = *reinterpret_cast<const float4*>(&ws[t][i]);
        const float4 u4 = *reinterpret_cast<const float4*>(&us[i]);
        const float rr[4] = {r4.x, r4.y, r4.z, r4.w};
        const float kk[4] = {k4.x, k4.y, k4.z, k4.w};
        const float ww[4] = {w4.x, w4.y, w4.z, w4.w};
        const float uu[4] = {u4.x, u4.y, u4.z, u4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float a = kk[e] * vj;
          y[e] = fmaf(rr[e], fmaf(uu[e], a, st[i + e]), y[e]);
          st[i + e] = fmaf(ww[e], st[i + e], a);
        }
      }
      yg[(t0 + t) * p.sys + j] = (y[0] + y[1]) + (y[2] + y[3]);
    }
  }
#pragma unroll
  for (int i = 0; i < D; ++i) p.sf[so + i * D + j] = st[i];
}

template <typename T, typename TW, int D>
int launch(const Params& p, int64_t B, int64_t H, cudaStream_t stream) {
  const dim3 grid((unsigned)H, (unsigned)B);
  wkv_fwd<T, TW, D><<<grid, D, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T, typename TW>
int dispatch_d(int D, const Params& p, int64_t B, int64_t H,
               cudaStream_t s) {
  if (D == 64) return launch<T, TW, 64>(p, B, H, s);
  if (D == 32) return launch<T, TW, 32>(p, B, H, s);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int dispatch_w(int w_dtype, int D, const Params& p, int64_t B, int64_t H,
               cudaStream_t s) {
  if (w_dtype == 0) return dispatch_d<T, float>(D, p, B, H, s);
  if (w_dtype == 1) return dispatch_d<T, __nv_bfloat16>(D, p, B, H, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype (r, k, v) and w_dtype (logw): 0 = float32, 1 = bfloat16.  strides:
// 15 element strides, (batch, head, seq) of r, k, v, logw and y in that
// order.  s0 may be null (zeros); u is (H, D) and sf (B, H, D, D), both
// contiguous.  Returns cudaGetLastError() after the launch (0 =
// cudaSuccess).  The caller handles S == 0 without a launch.
extern "C" int rwkv6_scan_fwd(int dtype, int w_dtype, int D, const void* r,
                              const void* k, const void* v, const void* lw,
                              const float* u, const float* s0, float* y,
                              float* sf, const int64_t* strides, int64_t B,
                              int64_t H, int64_t S, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0 || B > 65535 || H > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.r = r;
  p.k = k;
  p.v = v;
  p.lw = lw;
  p.u = u;
  p.s0 = s0;
  p.y = y;
  p.sf = sf;
  p.srb = strides[0]; p.srh = strides[1]; p.srs = strides[2];
  p.skb = strides[3]; p.skh = strides[4]; p.sks = strides[5];
  p.svb = strides[6]; p.svh = strides[7]; p.svs = strides[8];
  p.swb = strides[9]; p.swh = strides[10]; p.sws = strides[11];
  p.syb = strides[12]; p.syh = strides[13]; p.sys = strides[14];
  p.S = S;
  p.H = (int)H;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return dispatch_w<float>(w_dtype, D, p, B, H, s);
  if (dtype == 1) return dispatch_w<__nv_bfloat16>(w_dtype, D, p, B, H, s);
  return (int)cudaErrorInvalidValue;
}
