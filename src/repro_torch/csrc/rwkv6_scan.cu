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
 * Both variants replace the TPU kernel repro/kernels/rwkv6_scan/kernel.py:55
 * rwkv6_scan_pallas (body _wkv_kernel), which runs the exact per-step
 * recurrence over VMEM-resident chunks with the (D, D) state in VMEM
 * scratch across a sequential chunk axis.  On Hopper a block walks all of
 * S in a loop with the state on the SM.  The variant follows the dtype of
 * r, k and v, with no fallback between them.
 *
 * What bounds the function.  At the rwkv6-7b prefill shape (B 4, S 2048,
 * H 64, D 64, bf16 r/k/v, fp32 logw, no s0) it reads and writes
 * 473,972,736 bytes, 141.5 us at 3.35 TB/s.  Its chunked form
 * (wkv_chunked in repro/models/rwkv.py, chunk 64) needs 1.295e10 flops of
 * matrix products, 13.1 us on bf16 tensor cores, so the function is bound
 * by its bytes.  The per-step form has no matrix product: 5 D^2 flops a
 * step and head at the least (r.S, w.S + k v^T), 160.3 us at fp32's
 * 67 TFLOP/s, above the bytes.
 *
 * wkv_fwd_simt<T, TW, D>, fp32 inputs (the reduced configs, the fp32 serve
 * gates).  The per-step recurrence, in the shape of the public RWKV6 CUDA
 * kernel (wkv6_cuda.cu of BlinkDL's RWKV-LM):
 *   - one block of D threads owns one (batch, head) and walks all of S;
 *     thread j owns column j of the state, S[i][j] for every i, in D
 *     registers, so the state never leaves the SM until the end;
 *   - r, k, w = exp(logw) and v of 32 timesteps are staged in shared
 *     memory with coalesced loads (thread j loads element j of each row),
 *     then each step reads r_i, k_i, w_i, u_i as float4 broadcasts;
 *   - per step thread j computes y_j = sum_i r_i (S_ij + u_i k_i v_j) with
 *     no cross-thread reduction, then S_ij <- w_i S_ij + k_i v_j; the sum
 *     runs in four interleaved partial sums (i mod 4), added in a fixed
 *     order, to shorten the dependent FMA chain.
 *   B * H = 256 blocks of 2 warps on 132 SMs at the rwkv6 shape: too few
 *   warps to hide the dependent FMAs, so it is latency-bound.
 *
 * wkv_fwd_mma<TW, D>, bf16 r, k and v (the serve path).  The chunked form
 * of wkv_chunked with sub-chunks of 16 steps, the state carried from one
 * sub-chunk to the next in fp32 registers.  With cp_t = prod_{s<t} w_s and
 * cs_t = prod_{s>t} w_s inside a sub-chunk (every factor <= 1: a product
 * of w's, never exp of a positive sum, which overflows as wkv_chunked's
 * docstring warns), per sub-chunk
 *     y_t = (r_t o cp_t) . S_0 + sum_{j<=t} A[t][j] v_j,
 *     A[t][j] = sum_i r_ti k_ji prod_{j<s<t} w_si (j < t),
 *     A[t][t] = sum_i r_ti u_i k_ti,
 *     S <- diag(cp_16) S_0 + (k o cs)^T v.
 * More blocks than B * H: a cluster of two blocks owns one (batch, head),
 * each block half of the keys i, that is half of the state's rows.  Every
 * term above is a sum over i, so a block forms its keys' part of y (all D
 * value columns), of A, and its own rows of S; the only exchange is the
 * partial y of the other block's columns (16 x D / 2 fp32 a sub-chunk),
 * sent by st.async into the other block's shared memory and counted on
 * its mbarrier, so the sender never waits, and summed there one sub-chunk
 * later, once the next sub-chunk's prep has covered the transfer.  Two
 * buffers by sub-chunk parity make the reuse safe: a block sends for
 * c + 2 only after it has received c + 1, which the other sends only
 * after it has summed c.  512 blocks of 128 threads at the rwkv6 shape,
 * four on an SM.  Per sub-chunk:
 *   - prep, per key, the lanes of a key taking half of the steps each,
 *     joined by a shuffle: w = exp(logw) (ex2.approx), r o cp and k o cs
 *     as three bf16 terms in [key][step] tiles (one 16-byte store a term),
 *     cp_16, and the midpoint factors of the dense block below;
 *   - inter: (r o cp) . S_0 on tensor cores, mma.sync m16n8k16, both
 *     operands fp32 as three bf16 terms (hi, mid, lo) and the six products
 *     of terms at or above 2^-18, in four accumulator chains;
 *   - intra, fp32 SIMT: the pairs j <= t inside one half of the sub-chunk
 *     walk e = t - j up from the bonus, one w multiplied in a step, thread
 *     (t, slice of 4 keys), the 8 slices joined by a reduce-scatter of 7
 *     shuffles; the dense block t >= 8 > j is the dot product of
 *     r_t o prod_{8<=s<t} w_s and k_j o prod_{j<s<8} w_s (both <= 1, no
 *     walk); then A v on tensor cores, A as three terms, v bf16-exact;
 *   - state: (k o cs)^T v, three terms against v, into a fresh accumulator
 *     added to diag(cp_16) S in fp32.
 *   Two terms (16 significant bits), as flash's P has, would leave about
 *   6e-6 of |y| at the rwkv6 shape's inputs and a worst element above the
 *   2e-5 gate (PERF.md); three terms reach fp32's own rounding.  What
 *   holds it back (tools/scan_probe.py): the latency of the prep and of
 *   the intra walk, with 16 warps an SM and the shared-memory pipe about
 *   half busy; a per-sub-chunk cluster barrier in place of the mbarriers
 *   cost 1,500-2,000 cycles of a ~7,000-cycle sub-chunk.
 *
 * Shared by both: the ragged end of S is masked (a partial last tile),
 * never padded in device memory; every tensor is read and written through
 * its strides, so the model's (B, S, H, D) layout needs no transpose; no
 * atomics, and every sum runs in an order fixed by the shapes: two
 * launches give bit-identical output.
 *
 * Lines "// @probe <name>" mark where tools/scan_probe.py inserts clock
 * reads, or its deliberate faults, into a copy of this source; they are
 * comments and compile to nothing.
 */
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

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
wkv_fwd_simt(const Params p) {
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

// ---------------------------------------------------------------------------
// wkv_fwd_mma: bf16 r, k and v, the chunked form on tensor cores
// ---------------------------------------------------------------------------

constexpr int kMmaThreads = 128;
constexpr int kSub = 16;         // steps a sub-chunk
constexpr int kDSplit = 2;       // blocks a (batch, head): one cluster
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory of one block, in bytes: two stages of r, k and logw (the
// block's DH = D / 2 keys) and v (all D values) of a sub-chunk; w =
// exp(logw) of the block's keys (fp32); three bf16 terms each of r o cp
// and k o cs, [DH][kSub] (a key's steps contiguous), and of the block's
// rows of the state [DH][D] (swizzled); the other block's partial y of
// this block's columns [2][kSub][DH], by sub-chunk parity, and this
// block's partial scores [kSub][kSub] (fp32); its decays cp_16 [DH] and
// u [DH], and the midpoint factors of the dense block of the scores
// [8][DH + 4] each (fp32); two mbarriers, one a parity, counting the
// other block's bytes.  The Python wrapper's smem_bytes mirrors this.
template <typename TW, int D>
struct WkvTile {
  static constexpr int DH = D / kDSplit;
  static constexpr int kR = kSub * DH * 2;
  static constexpr int kV = kSub * D * 2;
  static constexpr int kW = kSub * DH * (int)sizeof(TW);
  static constexpr int kStage = 2 * kR + kV + kW;
  static constexpr int kF = kSub * DH * 4;
  static constexpr int kRt = kSub * DH * 2;
  static constexpr int kS = DH * D * 2;
  // the bytes one block sends the other a sub-chunk: its partial y of
  // the other's columns
  static constexpr int kSent = kSub * DH * 4;
  static constexpr int kBytes = 2 * kStage + kF + 3 * (2 * kRt + kS) +
                                2 * kSent + kSub * kSub * 4 + 2 * DH * 4 +
                                2 * 8 * (DH + 4) * 4 + 2 * 8;
};

__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = mma::unpack(u.x), b = mma::unpack(u.y);
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, a.x * b.x)));
}

// d += a b for a and b of three terms each: the five products of terms
// below the leading one whose order is at or above 2^-18 of |a b|
__device__ __forceinline__ void mma3x3(float (&d)[4],
                                       const uint32_t (&a)[3][4],
                                       const uint32_t (&b)[3][2]) {
  mma::mma_bf16(d, a[1], b[1][0], b[1][1]);
  mma::mma_bf16(d, a[2], b[0][0], b[0][1]);
  mma::mma_bf16(d, a[0], b[2][0], b[2][1]);
  mma::mma_bf16(d, a[1], b[0][0], b[0][1]);
  mma::mma_bf16(d, a[0], b[1][0], b[1][1]);
}

// One step of a reduce-scatter over lanes: this lane and lane ^ m swap
// halves of acc[0 .. 2 HS), each keeping the sum of the half it keeps
// (the upper if hi) in acc[0 .. HS)
template <int HS>
__device__ __forceinline__ void scatter_half(float (&acc)[8], bool hi,
                                             int m) {
#pragma unroll
  for (int k = 0; k < HS; ++k) {
    const float send = hi ? acc[k] : acc[k + HS];
    const float keep = hi ? acc[k + HS] : acc[k];
    acc[k] = keep + __shfl_xor_sync(0xffffffffu, send, m);
  }
}

__device__ __forceinline__ void sts(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(addr), "r"(v));
}

__device__ __forceinline__ void sts4(uint32_t addr, uint32_t a, uint32_t b,
                                     uint32_t c, uint32_t d) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(a), "r"(b), "r"(c), "r"(d));
}

template <typename TW, int D>
__global__ void __cluster_dims__(kDSplit, 1, 1)
__launch_bounds__(kMmaThreads, 4) wkv_fwd_mma(const Params p) {
  static_assert(D == 32 || D == 64, "tiling");
  using Tl = WkvTile<TW, D>;
  constexpr int DH = Tl::DH;
  constexpr int kWD = D / 8;     // 16-byte chunks in a row of D bf16
  constexpr int kWH = DH / 8;    // ... of DH bf16
  constexpr int kWL = DH * (int)sizeof(TW) / 16;  // ... of a logw row
  constexpr int kNSL = DH / 4;   // 4-column slices of the block's keys
  constexpr int kMT = DH / 16;   // m16 tiles of the block's state rows
  constexpr int kNT = D * DH / 512;   // n8 state tiles a warp owns
  constexpr int kHS = DH + 4;    // row stride of rh and kh (no conflicts)
  extern __shared__ __align__(128) unsigned char smem[];
  float* wf = reinterpret_cast<float*>(smem + 2 * Tl::kStage);
  const uint32_t rt = mma::smem_u32(wf + kSub * DH);
  const uint32_t kt = rt + 3 * Tl::kRt;
  const uint32_t sterm = kt + 3 * Tl::kRt;
  float* py = reinterpret_cast<float*>(smem + 2 * Tl::kStage + Tl::kF +
                                       3 * (2 * Tl::kRt + Tl::kS));
  float* pa = py + 2 * kSub * DH;
  float* dl = pa + kSub * kSub;
  float* us = dl + DH;
  float* rh = us + DH;           // [8][kHS]: r o prod_{8 <= s < t} w_s
  float* kh = rh + 8 * kHS;      // [8][kHS]: k o prod_{j < s < 8} w_s
  const uint32_t full = mma::smem_u32(kh + 8 * kHS);   // 2 mbarriers

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int q = lane & 3;
  const int h = blockIdx.x / kDSplit;
  const int half = blockIdx.x % kDSplit;   // the block's rank in its cluster
  const int64_t b = blockIdx.y;
  using bf16 = __nv_bfloat16;
  const bf16* rg =
      static_cast<const bf16*>(p.r) + b * p.srb + h * p.srh + half * DH;
  const bf16* kg =
      static_cast<const bf16*>(p.k) + b * p.skb + h * p.skh + half * DH;
  const bf16* vg = static_cast<const bf16*>(p.v) + b * p.svb + h * p.svh;
  const TW* wg =
      static_cast<const TW*>(p.lw) + b * p.swb + h * p.swh + half * DH;
  float* yg = p.y + b * p.syb + h * p.syh + half * DH;
  const int64_t so = ((b * p.H + h) * D + half * DH) * (int64_t)D;
  // the other block's py and mbarriers, through the cluster
  const uint32_t py_peer = mma::mapa(mma::smem_u32(py), half ^ 1);
  const uint32_t full_peer = mma::mapa(full, half ^ 1);

  // r, k and logw (the block's keys) and v (every value) of the sub-chunk
  // at t0
  auto prefetch = [&](int64_t t0, unsigned char* s) {
    const int Tc = (int)(p.S - t0 < kSub ? p.S - t0 : kSub);
    const uint32_t sr = mma::smem_u32(s);
    constexpr int T = kMmaThreads;
    mma::copy_rows<kWH, kSub, T, false>(sr, rg + t0 * p.srs, p.srs, Tc, tid);
    mma::copy_rows<kWH, kSub, T, false>(sr + Tl::kR, kg + t0 * p.sks, p.sks,
                                        Tc, tid);
    mma::copy_rows<kWD, kSub, T, true>(sr + 2 * Tl::kR, vg + t0 * p.svs,
                                       p.svs, Tc, tid);
    mma::copy_rows<kWL, kSub, T, false>(sr + 2 * Tl::kR + Tl::kV,
                                        wg + t0 * p.sws, p.sws, Tc, tid);
    mma::cp_async_commit();
  };

  // the block's rows of the state, fp32 in registers: warp w owns m-tile
  // w % kMT of them and n-tiles nt0..nt0 + kNT - 1 of the D columns
  const int mt = warp % kMT;
  const int nt0 = (warp / kMT) * kNT;
  float st[kNT][4];
#pragma unroll
  for (int n = 0; n < kNT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 16 * mt + g + 8 * (e >> 1);
      const int j = 8 * (nt0 + n) + 2 * q + (e & 1);
      st[n][e] = p.s0 ? p.s0[so + i * D + j] : 0.f;
    }
  // the state's three terms into shared memory, [i][j]
  auto write_state = [&]() {
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        uint32_t t[3];
        mma::split<3>(st[n][2 * hr], st[n][2 * hr + 1], t);
        const uint32_t at =
            sterm + mma::swz_el<kWD>(16 * mt + g + 8 * hr,
                                     8 * (nt0 + n) + 2 * q);
#pragma unroll
        for (int k3 = 0; k3 < 3; ++k3) sts(at + k3 * Tl::kS, t[k3]);
      }
  };

  // y of sub-chunk cc: the partial over the block's keys, kept in
  // registers by the warps whose columns are the block's (16w..16w+15,
  // w / 2 = half at D 64), plus the other block's, once its bytes are in
  const bool keeps = 16 * warp / DH == half;
  float ykeep[2][4] = {};
  auto finish = [&](int64_t cc) {
    if (!keeps) return;
    const int par = (int)(cc & 1);
    mma::mbar_wait(full + 8 * par, (int)((cc >> 1) & 1));
    const int64_t t0 = cc * kSub;
    const int Tc = (int)(p.S - t0 < kSub ? p.S - t0 : kSub);
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int row = g + 8 * hr;
        const int col = 16 * warp + 8 * n + 2 * q - half * DH;
        const float2 o =
            *reinterpret_cast<const float2*>(py + (par * kSub + row) * DH + col);
        if (row < Tc)
          *reinterpret_cast<float2*>(yg + (t0 + row) * p.sys + col) =
              make_float2(ykeep[n][2 * hr] + o.x, ykeep[n][2 * hr + 1] + o.y);
      }
  };

  const int64_t n_sub = (p.S + kSub - 1) / kSub;
  prefetch(0, smem);
  if (tid < DH) us[tid] = p.u[h * D + half * DH + tid];
  if (tid == 0) {
    mma::mbar_init(full, 1);
    mma::mbar_init(full + 8, 1);
  }
  for (int e = tid; e < kSub * kSub; e += kMmaThreads)
    pa[e] = 0.f;                 // j > t: never written again
  write_state();
  mma::cluster_sync();           // both blocks have started, mbarriers set
  // @probe start
  for (int64_t c = 0; c < n_sub; ++c) {
    const int cur = (int)(c & 1);
    const int64_t t0 = c * kSub;
    mma::cp_async_wait_all();
    __syncthreads();             // sub-chunk c, the state terms, u
    if (tid == 0) mma::mbar_expect(full + 8 * (int)(c & 1), Tl::kSent);
    // @probe phase:wait
    if (c + 1 < n_sub) prefetch(t0 + kSub, smem + (cur ^ 1) * Tl::kStage);
    const unsigned char* s = smem + cur * Tl::kStage;
    const bf16* rs = reinterpret_cast<const bf16*>(s);
    const bf16* ks = rs + kSub * DH;
    const uint32_t sv = mma::smem_u32(s) + 2 * Tl::kR;
    const TW* lws = reinterpret_cast<const TW*>(s + 2 * Tl::kR + Tl::kV);

    // the block's keys: warps 0-1 form w = exp(logw), r o cp and the
    // decays cp_16, warps 2-3 k o cs; lane l takes key 16 (warp & 1) +
    // l % 16 over the steps of half l / 16 of the sub-chunk, the two
    // halves' products joined by a shuffle, and stores its values as
    // three bf16 terms; on the way, the midpoint factors of the dense
    // block of the scores, r o prod_{8 <= s < t} w_s for t >= 8 and
    // k o prod_{j < s < 8} w_s for j < 8, in fp32
    {
      const int col = min(16 * (warp & 1) + (lane & 15), DH - 1);
      const bool mine = 16 * (warp & 1) + (lane & 15) < DH;
      const int th = lane >> 4;
      float w[kSub / 2], val[kSub / 2];
      float tot = 1.f;
#pragma unroll
      for (int u = 0; u < kSub / 2; ++u) {
        w[u] = mma::fast_exp2(ld(lws + (8 * th + u) * DH + col) * kLog2e);
        tot *= w[u];
      }
      const float first = __shfl_sync(0xffffffffu, tot, lane & 15);
      const float second = __shfl_sync(0xffffffffu, tot, (lane & 15) | 16);
      if (warp < 2) {            // cp_t = prod_{s<t} w_s
        float cp = th ? first : 1.f;
        float lp = 1.f;          // prod_{8 th <= s < t} w_s
#pragma unroll
        for (int u = 0; u < kSub / 2; ++u) {
          const int t = 8 * th + u;
          const float rv = ld(rs + t * DH + col);
          if (mine) wf[t * DH + col] = w[u];
          if (mine && th) rh[u * kHS + col] = rv * lp;
          val[u] = rv * cp;
          cp *= w[u];
          lp *= w[u];
        }
        if (th && mine) dl[col] = cp;
      } else {                   // cs_t = prod_{s>t} w_s
        float cs = th ? 1.f : second;
        float ls = 1.f;          // prod_{t < s < 8 th + 8} w_s
#pragma unroll
        for (int u = kSub / 2 - 1; u >= 0; --u) {
          const int t = 8 * th + u;
          const float kv = ld(ks + t * DH + col);
          if (mine && !th) kh[u * kHS + col] = kv * ls;
          val[u] = kv * cs;
          cs *= w[u];
          ls *= w[u];
        }
      }
      if (mine) {                // steps 8 th..8 th + 7 of key col: one
        uint32_t t3[4][3];       // 16-byte chunk of each term's row
#pragma unroll
        for (int u = 0; u < kSub / 2; u += 2)
          mma::split<3>(val[u], val[u + 1], t3[u / 2]);
        const uint32_t at = (warp < 2 ? rt : kt) + mma::swz<2>(col, th);
#pragma unroll
        for (int k3 = 0; k3 < 3; ++k3)
          sts4(at + k3 * Tl::kRt, t3[0][k3], t3[1][k3], t3[2][k3], t3[3][k3]);
      }
    }
    __syncthreads();             // w, r o cp, k o cs, cp_16, midpoints
    // @probe phase:prep
    if (c > 0) finish(c - 1);    // the other block's partial has had this
                                 // sub-chunk's prep to come
    // @probe phase:finish

    // partial y over the block's keys, all D columns, warp w owning
    // columns 16w..16w+15: inter (r o cp) . S_0 here, intra A v below
    const int par = (int)(c & 1);
    float yp[2][2][4] = {};      // [n-tile][16-key step parity]
    if (warp < D / 16) {
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        uint32_t a[3][4], bb[3][4];
#pragma unroll
        for (int k3 = 0; k3 < 3; ++k3) {
          mma::ldsm_x4_t(a[k3], rt + k3 * Tl::kRt +
                                    mma::swz<2>(16 * kk + (lane & 7) +
                                                    8 * (lane >> 4),
                                                (lane >> 3) & 1));
          mma::ldsm_x4_t(bb[k3], sterm + k3 * Tl::kS +
                                     mma::swz<kWD>(16 * kk + (lane & 15),
                                                   2 * warp + (lane >> 4)));
        }
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          const uint32_t b3[3][2] = {{bb[0][2 * n], bb[0][2 * n + 1]},
                                     {bb[1][2 * n], bb[1][2 * n + 1]},
                                     {bb[2][2 * n], bb[2][2 * n + 1]}};
          // @probe one_term (the next line)
          mma3x3(yp[n][kk & 1], a, b3);
          mma::mma_bf16(yp[n][kk & 1], a[0], b3[0][0], b3[0][1]);
        }
      }
    }
    // @probe phase:inter

    // the block's rows: S <- diag(cp_16) S + (k o cs)^T v
    auto update_state = [&]() {
      uint32_t ka[3][4];
#pragma unroll
      for (int k3 = 0; k3 < 3; ++k3)
        mma::ldsm_x4(ka[k3], kt + k3 * Tl::kRt +
                                 mma::swz<2>(16 * mt + (lane & 15),
                                             lane >> 4));
      float tmp[kNT][4] = {};
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        uint32_t vb[2];
        mma::ldsm_x2_t(vb, sv + mma::swz<kWD>(lane & 15, nt0 + n));
#pragma unroll
        for (int k3 = 2; k3 >= 0; --k3)
          mma::mma_bf16(tmp[n], ka[k3], vb[0], vb[1]);
      }
      const float da = dl[16 * mt + g], db = dl[16 * mt + g + 8];
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        st[n][0] = fmaf(da, st[n][0], tmp[n][0]);
        st[n][1] = fmaf(da, st[n][1], tmp[n][1]);
        st[n][2] = fmaf(db, st[n][2], tmp[n][2]);
        st[n][3] = fmaf(db, st[n][3], tmp[n][3]);
      }
    };
    // @probe state-update (the next line)
    update_state();
    // @probe phase:state

    // partial scores over the block's keys.  Pairs j <= t in one half of
    // the sub-chunk: thread (t, sl) walks e = t - j up from 0 (the bonus
    // A[t][t]) over keys 4 sl..4 sl + 3, multiplying in one w a step; a
    // reduce-scatter over the 8 slices leaves lane sl the sum for e = sl,
    // A[t][t - sl], which goes to both blocks
    {
      const int t = tid >> 3;
      const int sl = tid & 7;
      const int jmin = warp < 2 ? 0 : kSub / 2;
      const int emax = 4 * warp + 3 - jmin;   // the warp's largest t - jmin
      float acc[8] = {};
      if (sl < kNSL) {
        const int i = 4 * sl;
        const float4 rv = ld4(rs + t * DH + i);
        const float4 uv = *reinterpret_cast<const float4*>(us + i);
        acc[0] = dot4(make_float4(rv.x * uv.x, rv.y * uv.y, rv.z * uv.z,
                                  rv.w * uv.w),
                      ld4(ks + t * DH + i));
        float4 pr = rv;          // r_t o prod_{t-e < s < t} w_s
#pragma unroll
        for (int e = 1; e < 8; ++e) {
          if (e > emax) break;   // warp-uniform; past t - jmin: unused
          const int j = max(t - e, 0);
          if (e > 1) {
            const float4 wv =
                *reinterpret_cast<const float4*>(wf + (j + 1) * DH + i);
            pr.x *= wv.x;
            pr.y *= wv.y;
            pr.z *= wv.z;
            pr.w *= wv.w;
          }
          acc[e] = dot4(pr, ld4(ks + j * DH + i));
        }
      }
      scatter_half<4>(acc, sl & 4, 4);
      scatter_half<2>(acc, sl & 2, 2);
      scatter_half<1>(acc, sl & 1, 1);
      if (t - sl >= jmin) pa[t * kSub + t - sl] = acc[0];
    }
    // the dense block, t >= 8 > j: warps 0 and 2 (the short walks above),
    // one pair a lane, the dot product of the two midpoint factors
    if (!(warp & 1)) {
      const int pi = (warp >> 1) * 32 + lane;
      const int t = kSub / 2 + pi / 8, j = pi % 8;
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int i = 0; i < DH; i += 8) {
        s0 += dot4(*reinterpret_cast<const float4*>(rh + (t - 8) * kHS + i),
                   *reinterpret_cast<const float4*>(kh + j * kHS + i));
        s1 += dot4(
            *reinterpret_cast<const float4*>(rh + (t - 8) * kHS + i + 4),
            *reinterpret_cast<const float4*>(kh + j * kHS + i + 4));
      }
      pa[t * kSub + j] = s0 + s1;
    }
    // @probe phase:intra
    __syncthreads();             // the scores; every warp is done with
                                 // the old state
    // y += A v, A (the block's partial scores) as three terms; then the
    // partial y of the other block's columns goes to it by st.async, the
    // block's own stays in registers until finish
    if (warp < D / 16) {
      uint32_t a[3][4];
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const float2 v2 = *reinterpret_cast<const float2*>(
            pa + (g + 8 * (m & 1)) * kSub + 2 * q + 8 * (m >> 1));
        uint32_t t3[3];
        mma::split<3>(v2.x, v2.y, t3);
#pragma unroll
        for (int k3 = 0; k3 < 3; ++k3) a[k3][m] = t3[k3];
      }
      uint32_t vb[4];
      mma::ldsm_x4_t(vb, sv + mma::swz<kWD>(lane & 15, 2 * warp + (lane >> 4)));
#pragma unroll
      for (int k3 = 2; k3 >= 0; --k3)
#pragma unroll
        for (int n = 0; n < 2; ++n)
          mma::mma_bf16(yp[n][0], a[k3], vb[2 * n], vb[2 * n + 1]);
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) yp[n][0][e] += yp[n][1][e];
      if (keeps) {
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) ykeep[n][e] = yp[n][0][e];
      } else {
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const int off = (par * kSub + g + 8 * hr) * DH + 16 * warp +
                            8 * n + 2 * q - (half ^ 1) * DH;
            mma::st_async(py_peer + off * 4, yp[n][0][2 * hr],
                          yp[n][0][2 * hr + 1], full_peer + 8 * par);
          }
      }
    }
    write_state();
    // @probe phase:tail

  }
  // @probe epilogue
  finish(n_sub - 1);
  mma::cluster_sync();           // no block leaves while the other sends#pragma unroll
  for (int n = 0; n < kNT; ++n)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr)
      *reinterpret_cast<float2*>(p.sf + so + (16 * mt + g + 8 * hr) * D +
                                 8 * (nt0 + n) + 2 * q) =
          make_float2(st[n][2 * hr], st[n][2 * hr + 1]);
}

template <typename T, typename TW, int D>
int launch(const Params& p, int64_t B, int64_t H, cudaStream_t stream) {
  if constexpr (sizeof(T) == 2) {
    const int smem = WkvTile<TW, D>::kBytes;
    cudaError_t err = cudaFuncSetAttribute(
        wkv_fwd_mma<TW, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((unsigned)(H * kDSplit), (unsigned)B);
    wkv_fwd_mma<TW, D><<<grid, kMmaThreads, smem, stream>>>(p);
  } else {
    const dim3 grid((unsigned)H, (unsigned)B);
    wkv_fwd_simt<T, TW, D><<<grid, D, 0, stream>>>(p);
  }
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

// dtype (r, k, v) and w_dtype (logw): 0 = float32, 1 = bfloat16; dtype
// picks the variant (0: wkv_fwd_simt, 1: wkv_fwd_mma, which wants the rows
// of r, k, v and logw at 16-byte-aligned addresses: every stride but the
// last a multiple of 16 bytes, and 16-byte-aligned bases).  strides: 15
// element strides, (batch, head, seq) of r, k, v, logw and y in that
// order.  s0 may be null (zeros); u is (H, D) and sf (B, H, D, D), both
// contiguous.  Returns cudaGetLastError() after the launch (0 =
// cudaSuccess).  The caller handles S == 0 without a launch.
extern "C" int rwkv6_scan_fwd(int dtype, int w_dtype, int D, const void* r,
                              const void* k, const void* v, const void* lw,
                              const float* u, const float* s0, float* y,
                              float* sf, const int64_t* strides, int64_t B,
                              int64_t H, int64_t S, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0 || B > 65535 || H > 0x3fffffffLL)
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
