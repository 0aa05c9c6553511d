/*
 * ssm_scan_bwd_mma — the gradient of the Mamba2 SSD scan for Hopper
 * (sm_90a), its chunk products on the tensor cores: ssd_bwd_mma on bf16 x,
 * B and C (this header), ssd_bwd_mma_f32 on fp32 ones (the header of its
 * section below).
 *
 *     a_t = exp(dt_t A),  h_t = a_t h_{t-1} + dt_t x_t B_t^T,  y_t = h_t C_t
 *
 *     x, dx: (B, H, S, P) bf16; dt, ddt: (B, H, S) fp32 or bf16; A: (H,)
 *     fp32; B, C: (B, G, S, N) bf16 with head h reading group h / (H / G);
 *     dy: (B, H, S, P) fp32; h0, dh_f, dh0: (B, H, P, N) fp32 contiguous or
 *     null (zeros; dh0 null: not written).  dA per (batch, head), (B, H)
 *     contiguous, summed over batch by the caller.  dB and dC fp32 partial
 *     sums, (B, H / hpb, S, N): a block owns hpb heads of one group, walks
 *     them one after the other and adds each head's dB and dC to the
 *     partial in a fixed order (its own threads, the same element each
 *     head); the caller sums the partials of a group and rounds once.
 *     Every (B, ., S, .) tensor is a strided view whose last axis is
 *     contiguous; the rows of x, B and C are copied 16 bytes at a time
 *     (strides multiples of 8 elements, 16-byte-aligned bases), those of
 *     dy read as float4 (strides multiples of 4).  P in {32, 64}, N in {16,
 *     64}.
 *
 * It replaces, for bf16 inputs, the gradient of the TPU kernel
 * repro/kernels/ssm_scan/kernel.py:66 ssm_scan_pallas: the JAX package has
 * no backward kernel, so it computes what autodiff of the plain scan
 * computes.  ssd_bwd_simt (csrc/ssm_scan_bwd.cu) computes the same on the
 * SIMT pipes, for fp32 and, by name, for bf16 (the yardstick).  The
 * algebra is that kernel's (its header; ssm_scan_bwd_ref): per chunk of 64
 * rows, with seg the within-chunk cumsum of dt A, e = exp(seg), w_t =
 * exp(seg_last - seg_t) and D[tau][t] = exp(seg_tau - seg_t) for t <= tau,
 *     M = (C B^T) o D,  Q = (dY X^T) o D,
 *     G_t B_t = (M^T dY)_t + w_t (B Gc^T)_t,
 *     G_t^T x_t = (Q^T C)_t + w_t (X Gc)_t,
 *     dC = e o (dY h_s) + Q (dt o B),  Gc <- e_last Gc + (e o dY)^T C,
 * and lambda_t = dL/d log a_t from the chunk's own terms.
 *
 * ssd_bwd_mma<TD, P, N>: 128 threads, four warps, a block a (batch, hpb
 * heads); warp w owns rows 16w..16w+15 of each chunk.  Per head, a
 * forward walk rebuilds the chunk-start states (the SIMT kernel's state
 * update on the tensor cores, as ssd_fwd_mma forms it) and writes those of
 * chunks 1..n-2 to a workspace: the last one stays in registers and the
 * first is h0, so at S <= 128 nothing is written.  The reverse walk, per
 * chunk:
 *   - x, B and C land in shared memory by cp.async, swizzled for
 *     ldmatrix; dy (fp32) is split into two bf16 terms as it lands, Gc and
 *     h_s likewise from fp32 (warp w owns a quarter of each (P, N) state,
 *     as mma fragments: h_s in registers, Gc in shared memory, each
 *     thread's own values, between its first and last use in a chunk);
 *   - warp w forms, for its rows t and the columns tau >= t, M^T[t][tau] =
 *     (B_t . C_tau) D[tau][t] and Q^T[t][tau] = (x_t . dY_tau) D[tau][t]
 *     (mma.sync m16n8k16, bf16 -> fp32; exp2 of differences <= 0 only,
 *     never above the diagonal), so that G_t B_t = M^T dY + w_t B Gc^T
 *     (-> dx, q_t = x_t . G_t B_t, beta_t = x_t . Gc B_t) and G_t^T x_t =
 *     Q^T C + w_t X Gc (-> dB) take their A operands from its own
 *     accumulators (split into hi + lo in registers), one 16-column tile
 *     at a time, in two passes over the tiles (Q^T and GX, then C B^T
 *     again for M^T and GB: holding both sums spilled registers).  Q^T o
 *     dt goes to shared memory as hi + lo, where dC's rows read it
 *     transposed: dC_tau = e_tau (dY h_s)_tau + sum_l (Q^T o dt)[l][tau]
 *     B_l, and gamma_tau = C_tau . (dY h_s)_tau.  Then e o dy replaces dY
 *     in shared memory and each warp updates its quarter of Gc;
 *   - dB and dC: a head's pairs are added to what the block's earlier
 *     heads left in the partial, loaded before the products that precede
 *     the store so that the L2 round trip is hidden (loaded at the store,
 *     it made 2 heads a block 0.07 ms slower than one at the training
 *     shape; kernel.py's heads_per_block);
 *   - lambda.  The SIMT kernel's lambda_t holds + sum_{tau >= t} Z^T[t][tau]
 *     - dt_t (M^T dY)_t . x_t, two terms equal in exact arithmetic (Z^T[t]
 *     [tau] = M^T[t][tau] (x_t . dY_tau) dt_t) that cancel; here the second
 *     would come from the split M and the first from fp32, and their gap
 *     left dA 3e-4 of max |dA| from float64 in the mirror.  So both are
 *     dropped, with the w_t dt_t beta_t that q_t also holds:
 *         lambda_t = e_last <Gc, h_s> + sum_{l<t} w_l dt_l beta_l
 *                    + sum_{tau>=t} e_tau gamma_tau
 *                    + sum_{l<t} sum_{tau>=t} Z^T[l][tau],
 *     Z^T[l][tau] = (B_l . C_tau) Q^T[l][tau] dt_l, its rectangle sums
 *     taken as they stand (a difference of prefix sums cancels;
 *     kernels/ssm_scan/ref.py).  Each warp sums its rows' columns beyond
 *     its diagonal tile (column sums over its 16 rows, shuffles) and its
 *     diagonal 16 x 16 tile with the row sums beyond it (row suffixes, then
 *     column prefixes over l < t, in shared memory); warp 0 adds the
 *     suffixes of the column sums of the warps above and the scans, then
 *     ddt = q + A lambda and the chunk's share of dA, in fp32.
 * The fp32 factors go to the tensor cores as two bf16 terms (mma::split<2>:
 * 16 significant bits): dy, M, Q (and Q o dt), Gc, h_s, e o dy and the
 * forward walk's B o w o dt; a product of two of them takes three mma
 * (hi.hi, hi.lo, lo.hi).  One term fewer for any one of them fails
 * ref.bf16_grad_gate in the float64 mirror of these rounding points
 * (ref.ssm_scan_bwd_mma_mirror, tests/test_torch_scan_grad.py); x, B and
 * C are bf16 and exact.  Shared memory at P = N = 64: x, B, C, dY's two
 * terms, Gc's, h_s's and Q^T o dt's, Gc in fp32 and the fp32 rows,
 * 114,192 bytes: two blocks an SM (ptxas: 255 registers, no spill).
 *
 * What bounds it.  At zamba2-1.2b's training shape (B 32, S 128, H 64, P
 * = N = 64, G 1, fp32 dt) the function moves 138 MB (41.3 us at 3.35
 * TB/s); with the split terms the kernel issues ~2,000 m16n8k16 a chunk
 * and head (8.2e6 flops): 34 GFLOP a launch, 34 us at the dense bf16
 * rate, more at mma.sync's.  So the bytes and the tensor work are level,
 * and what the kernel loses to its bound is latency: two blocks of four
 * warps an SM, three block barriers a chunk, the lambda scans on one
 * warp, and the triangle (warp 0 forms four column tiles of M^T and Q^T,
 * warp 3 one).
 *
 * Rows past S are never loaded (zeros in shared memory; dt 0 there, so
 * seg_last is the last valid row's) and never written.  No atomics; every
 * sum runs in an order fixed by the shapes, so two launches give
 * bit-identical gradients.
 *
 * Lines "// @probe <name>" mark where tools/ssd_bwd_probe.py inserts clock
 * reads, or its deliberate faults, into a copy of this source; they are
 * comments and compile to nothing.
 */
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kL = 64;           // chunk length
constexpr float kLog2e = 1.4426950408889634f;

// T: the type of x, B, C and dx (bf16 for ssd_bwd_mma, fp32 for
// ssd_bwd_mma_f32)
template <typename T>
struct ParamsT {
  const T* x;
  const void* dt;                // TD
  const float* A;
  const T* bm;
  const T* cm;
  const float* h0;               // (B, H, P, N) contiguous, or null
  const float* dy;
  const float* dhf;              // (B, H, P, N) contiguous, or null
  T* dx;
  void* ddt;                     // TD
  float* dA;                     // (B, H) contiguous
  float* dB;                     // partials (B, H / hpb, S, N), strided
  float* dC;
  float* dh0;                    // (B, H, P, N) contiguous, or null
  float* ws;                     // (B, H, n_ws, P, N) contiguous
  int64_t st[9][3];              // x, dt, B, C, dy, dx, ddt, dB, dC:
                                 // (batch, head / group / partial, seq)
  int64_t S;
  int H;
  int rep;                       // heads per group, H / G
  int hpb;                       // heads per block, a divisor of rep
  int n_chunks;
  int n_ws;                      // chunk-start states in ws: n_chunks - 2
};
using Params = ParamsT<__nv_bfloat16>;

// Shared memory of one block, in bytes: x, dY's hi and lo terms [kL][P];
// B and C [kL][N]; Gc's and h_s's hi and lo terms [P][N]; Q^T o dt's hi
// and lo [kL][kL] (all bf16, swizzled); then fp32: dt [kL], each warp's
// seg [4][kL] and column sums of Z^T [4][kL], the rectangle sums, q, beta
// and gamma [kL] each, <Gc, h_s> a warp [4], each warp's 16 x 17 Z^T
// scratch, and Gc in fp32 [P * N], each thread's quarter-fragment values
// where only it reads them (out of its registers between a chunk's first
// and last use).  kernels/ssm_scan/kernel.py's bwd_smem_bytes mirrors
// this.
template <int P, int N>
struct Tile {
  static constexpr int kX = kL * P * 2;
  static constexpr int kBC = kL * N * 2;
  static constexpr int kS = P * N * 2;
  static constexpr int kQ = kL * kL * 2;
  static constexpr int oX = 0;
  static constexpr int oB = oX + kX;
  static constexpr int oC = oB + kBC;
  static constexpr int oDyh = oC + kBC;
  static constexpr int oDyl = oDyh + kX;
  static constexpr int oGh = oDyl + kX;
  static constexpr int oGl = oGh + kS;
  static constexpr int oHh = oGl + kS;
  static constexpr int oHl = oHh + kS;
  static constexpr int oQh = oHl + kS;
  static constexpr int oQl = oQh + kQ;
  static constexpr int oF = oQl + kQ;
  static constexpr int kFloats = kL + 4 * kL + 4 * kL + 4 * kL + 4
                                 + 4 * 16 * 17 + P * N;
  static constexpr int kBytes = oF + 4 * kFloats;
};

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st1(float* p, float v) { *p = v; }
__device__ __forceinline__ void st1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// d0 += a b[0..1], d1 += a b[2..3]: two n8 tiles from one x4 B load
__device__ __forceinline__ void mma_x2(float (&d0)[4], float (&d1)[4],
                                       const uint32_t (&a)[4],
                                       const uint32_t (&b)[4]) {
  mma::mma_bf16(d0, a, b[0], b[1]);
  mma::mma_bf16(d1, a, b[2], b[3]);
}

// v, a pair of row values of an accumulator, summed over the 4 lanes of
// a quad (one row's columns), in a fixed order
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

// inclusive prefix (up) or suffix (down) sum of (v0 at row lane, v1 at
// row lane + 32) over the 64 rows, by one warp
__device__ __forceinline__ void scan64(float& v0, float& v1, int lane,
                                       bool suffix) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float u0 = suffix ? __shfl_down_sync(0xffffffffu, v0, o)
                            : __shfl_up_sync(0xffffffffu, v0, o);
    const float u1 = suffix ? __shfl_down_sync(0xffffffffu, v1, o)
                            : __shfl_up_sync(0xffffffffu, v1, o);
    if (suffix ? lane + o < 32 : lane >= o) {
      v0 += u0;
      v1 += u1;
    }
  }
  if (suffix) v0 += __shfl_sync(0xffffffffu, v1, 0);
  else v1 += __shfl_sync(0xffffffffu, v0, 31);
}

// The pair of a dB or dC partial at p so far: 0 for the block's first head
// (or a row past S).  Loaded well before the pair is added and stored, so
// that the L2 round trip overlaps the products in between
__device__ __forceinline__ float2 old2(const float* p, bool load) {
  return load ? *reinterpret_cast<const float2*>(p) : make_float2(0.f, 0.f);
}
__device__ __forceinline__ void add2(float* p, float a, float b, float2 o) {
  *reinterpret_cast<float2*>(p) = make_float2(a + o.x, b + o.y);
}
__device__ __forceinline__ void put2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// kRows rows of fp32 dy from row r0 of the chunk at c0 (0 past Lc), by kT
// threads of which this is thread t, scaled by exp2(seg) if kE, as hi +
// lo bf16 terms into the [kL][P] tiles at dyh and dyl: every load issued
// before the first split, so that their latencies overlap
template <int P, int kRows, int kT, bool kE>
__device__ __forceinline__ void stage_dy(unsigned char* dyh,
                                         unsigned char* dyl, const float* yg,
                                         int64_t rs, int64_t c0, int Lc,
                                         int r0, int t, const float* seg) {
  constexpr int kC4 = P / 4;
  constexpr int kIt = kRows * kC4 / kT;
  static_assert(kRows * kC4 % kT == 0, "tiling");
  float4 v[kIt];
#pragma unroll
  for (int i = 0; i < kIt; ++i) {
    const int e = t + i * kT, row = r0 + e / kC4, col = 4 * (e % kC4);
    v[i] = row < Lc
        ? *reinterpret_cast<const float4*>(yg + (c0 + row) * rs + col)
        : make_float4(0.f, 0.f, 0.f, 0.f);
  }
#pragma unroll
  for (int i = 0; i < kIt; ++i) {
    const int e = t + i * kT, row = r0 + e / kC4, col = 4 * (e % kC4);
    if (kE) {
      const float ev = mma::fast_exp2(seg[row]);
      v[i].x *= ev;
      v[i].y *= ev;
      v[i].z *= ev;
      v[i].w *= ev;
    }
    uint32_t a[2], b[2];
    mma::split<2>(v[i].x, v[i].y, a);
    mma::split<2>(v[i].z, v[i].w, b);
    const int off = mma::swz_el<P / 8>(row, col);
    *reinterpret_cast<uint2*>(dyh + off) = make_uint2(a[0], b[0]);
    *reinterpret_cast<uint2*>(dyl + off) = make_uint2(a[1], b[1]);
  }
}

template <typename TD, int P, int N>
__global__ void __launch_bounds__(kThreads, 2)
ssd_bwd_mma(const Params p) {
  static_assert((P == 32 || P == 64) && (N == 16 || N == 64), "tiling");
  using Tl = Tile<P, N>;
  constexpr int kWP = P / 8;     // 16-byte chunks in a row of x and dY
  constexpr int kWN = N / 8;     // ... of B, C, Gc and h_s
  constexpr int kPK = P / 16;    // k-steps over P
  constexpr int kNK = N / 16;    // k-steps over N
  constexpr int kPT = P / 8;     // n8 tiles over P
  constexpr int kNT = N / 8;     // n8 tiles over N
  constexpr int kPM = P / 16;    // m16 tiles of a state over P
  constexpr int kOwn = kNT * kPM / 4;   // n8 tiles of a state a warp owns
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t s0 = mma::smem_u32(smem);
  const uint32_t sx = s0 + Tl::oX, sb = s0 + Tl::oB, sc = s0 + Tl::oC;
  const uint32_t sdyh = s0 + Tl::oDyh, sdyl = s0 + Tl::oDyl;
  const uint32_t sgh = s0 + Tl::oGh, sgl = s0 + Tl::oGl;
  const uint32_t shh = s0 + Tl::oHh, shl = s0 + Tl::oHl;
  const uint32_t sqh = s0 + Tl::oQh, sql = s0 + Tl::oQl;
  float* dts = reinterpret_cast<float*>(smem + Tl::oF);   // [kL]
  float* segs = dts + kL;        // [4][kL], log2 units
  float* colw = segs + 4 * kL;   // [4][kL] column sums of Z^T, a warp
  float* rect = colw + 4 * kL;   // [kL] the rectangle sums (own warp)
  float* qv = rect + kL;         // [kL] x_t . G_t B_t
  float* bv = qv + kL;           // [kL] beta_t = x_t . Gc B_t
  float* gv = bv + kL;           // [kL] gamma_t = C_t . (dY h_s)_t
  float* red = gv + kL;          // [4]  <Gc, h_s>, a warp
  float* zscr = red + 4;         // [4][16][17]
  float* gcf = zscr + 4 * 16 * 17;   // [kOwn * 4][kThreads] Gc, fp32

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int q = lane & 3;
  const int64_t b = blockIdx.y;
  float* segw = segs + warp * kL;
  float* zw = zscr + warp * 16 * 17;
  // the warp's quarter of a (P, N) state: m16 tile pt, n8 tiles jof(i)
  const int pt = kPM == 4 ? warp : (warp & 1);
  auto jof = [&](int i) { return kPM == 4 ? i : 2 * i + (warp >> 1); };
  const int r0 = 16 * warp;      // the warp's rows of a chunk
  const int ta = r0 + g, tb = ta + 8;

  // a (P, N) fp32 state of the warp's quarter from / to a contiguous
  // (P, N) array (null: zeros)
  auto load_state = [&](float (&s)[kOwn][4], const float* src) {
#pragma unroll
    for (int i = 0; i < kOwn; ++i)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int row = 16 * pt + g + 8 * hr, col = 8 * jof(i) + 2 * q;
        const float2 v = src ? *reinterpret_cast<const float2*>(
                                   src + row * N + col)
                             : make_float2(0.f, 0.f);
        s[i][2 * hr] = v.x;
        s[i][2 * hr + 1] = v.y;
      }
  };
  auto store_state = [&](const float (&s)[kOwn][4], float* dst) {
#pragma unroll
    for (int i = 0; i < kOwn; ++i)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int row = 16 * pt + g + 8 * hr, col = 8 * jof(i) + 2 * q;
        *reinterpret_cast<float2*>(dst + row * N + col) =
            make_float2(s[i][2 * hr], s[i][2 * hr + 1]);
      }
  };
  auto get_gc = [&](float (&s)[kOwn][4]) {
#pragma unroll
    for (int i = 0; i < kOwn; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = gcf[(4 * i + e) * kThreads + tid];
  };
  auto put_gc = [&](const float (&s)[kOwn][4]) {
#pragma unroll
    for (int i = 0; i < kOwn; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) gcf[(4 * i + e) * kThreads + tid] = s[i][e];
  };
  // its hi and lo terms into the [P][N] tiles at (hi, lo)
  auto split_state = [&](const float (&s)[kOwn][4], uint32_t hi,
                         uint32_t lo) {
#pragma unroll
    for (int i = 0; i < kOwn; ++i)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int row = 16 * pt + g + 8 * hr, col = 8 * jof(i) + 2 * q;
        uint32_t t[2];
        mma::split<2>(s[i][2 * hr], s[i][2 * hr + 1], t);
        const int off = mma::swz_el<kWN>(row, col);
        *reinterpret_cast<uint32_t*>(smem + (hi - s0) + off) = t[0];
        *reinterpret_cast<uint32_t*>(smem + (lo - s0) + off) = t[1];
      }
  };

  // @probe start
  for (int hh = 0; hh < p.hpb; ++hh) {
    const int h = blockIdx.x * p.hpb + hh;
    const bool first = hh == 0;
    const int64_t grp = h / p.rep;
    const float A = p.A[h];
    const float A2 = A * kLog2e;
    const __nv_bfloat16* xg = p.x + b * p.st[0][0] + h * p.st[0][1];
    const TD* dg = static_cast<const TD*>(p.dt) + b * p.st[1][0] +
                   h * p.st[1][1];
    const __nv_bfloat16* bg = p.bm + b * p.st[2][0] + grp * p.st[2][1];
    const __nv_bfloat16* cg = p.cm + b * p.st[3][0] + grp * p.st[3][1];
    const float* yg = p.dy + b * p.st[4][0] + h * p.st[4][1];
    __nv_bfloat16* dxg = p.dx + b * p.st[5][0] + h * p.st[5][1];
    TD* ddg = static_cast<TD*>(p.ddt) + b * p.st[6][0] + h * p.st[6][1];
    float* dbg = p.dB + b * p.st[7][0] + blockIdx.x * p.st[7][1];
    float* dcg = p.dC + b * p.st[8][0] + blockIdx.x * p.st[8][1];
    const int64_t so = (b * p.H + h) * (int64_t)(P * N);
    float* wsg = p.ws + (b * p.H + h) * (int64_t)p.n_ws * (P * N);

    // dt of the chunk at c0 into dts (0 past S); x (and B, C) by cp.async
    auto load_chunk = [&](int64_t c0, int Lc, bool with_c) {
      mma::copy_rows<kWP, kL, kThreads, true>(sx, xg + c0 * p.st[0][2],
                                              p.st[0][2], Lc, tid);
      mma::copy_rows<kWN, kL, kThreads, true>(sb, bg + c0 * p.st[2][2],
                                              p.st[2][2], Lc, tid);
      if (with_c)
        mma::copy_rows<kWN, kL, kThreads, true>(sc, cg + c0 * p.st[3][2],
                                                p.st[3][2], Lc, tid);
      mma::cp_async_commit();
      if (tid < kL)
        dts[tid] = tid < Lc ? ld(dg + (c0 + tid) * p.st[1][2]) : 0.f;
    };
    // each warp's own seg (after a barrier past load_chunk)
    auto chunk_seg = [&]() {
      float a0 = dts[lane] * A2, a1 = dts[lane + 32] * A2;
      scan64(a0, a1, lane, false);
      segw[lane] = a0;
      segw[lane + 32] = a1;
      __syncwarp();
    };

    // ---- forward walk: the chunk-start states ----------------------------
    float hs[kOwn][4];           // the state, the warp's quarter
    load_state(hs, p.h0 ? p.h0 + so : nullptr);
    for (int c = 0; c + 1 < p.n_chunks; ++c) {
      const int64_t c0 = (int64_t)c * kL;
      const int Lc = (int)(p.S - c0 < kL ? p.S - c0 : kL);
      __syncthreads();           // the last readers of x, B and dts are done
      load_chunk(c0, Lc, false);
      mma::cp_async_wait_all();
      __syncthreads();
      chunk_seg();
      const float seg_last = segw[kL - 1];
      const float decay = mma::fast_exp2(seg_last);
#pragma unroll
      for (int i = 0; i < kOwn; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) hs[i][e] *= decay;
      // state += x^T (B o w o dt), the right factor as hi + lo
#pragma unroll
      for (int kk = 0; kk < kL / 16; ++kk) {
        uint32_t xa[4];
        mma::ldsm_x4_t(xa, sx + mma::swz<kWP>(16 * kk + (lane & 7) +
                                                  8 * (lane >> 4),
                                              2 * pt + ((lane >> 3) & 1)));
        const int la = 16 * kk + 2 * q, lb = la + 8;
        const float w[4] = {
            mma::fast_exp2(seg_last - segw[la]) * dts[la],
            mma::fast_exp2(seg_last - segw[la + 1]) * dts[la + 1],
            mma::fast_exp2(seg_last - segw[lb]) * dts[lb],
            mma::fast_exp2(seg_last - segw[lb + 1]) * dts[lb + 1]};
#pragma unroll
        for (int i = 0; i < kOwn; ++i) {
          uint32_t r[2];
          mma::ldsm_x2_t(r, sb + mma::swz<kWN>(16 * kk + (lane & 15),
                                               jof(i)));
          uint32_t bh[2], bl[2];
#pragma unroll
          for (int m = 0; m < 2; ++m) {          // r[0]: rows la, r[1]: lb
            const float2 f = mma::unpack(r[m]);
            uint32_t t[2];
            mma::split<2>(f.x * w[2 * m], f.y * w[2 * m + 1], t);
            bh[m] = t[0];
            bl[m] = t[1];
          }
          mma::mma_bf16(hs[i], xa, bh[0], bh[1]);
          mma::mma_bf16(hs[i], xa, bl[0], bl[1]);
        }
      }
      if (c + 1 < p.n_chunks - 1)                // chunk c + 1's start state
        store_state(hs, wsg + (int64_t)c * (P * N));
    }

    // ---- reverse walk ----------------------------------------------------
    // a chunk-start state's terms into the h_s tiles, and <Gc, h_s> a warp
    auto stage_hs = [&](const float (&h)[kOwn][4]) {
      split_state(h, shh, shl);
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < kOwn; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          part = fmaf(gcf[(4 * i + e) * kThreads + tid], h[i][e], part);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, o);
      if (lane == 0) red[warp] = part;
    };
    __syncthreads();             // the forward walk's readers are done
    {                            // Gc, the warp's quarter, from dh_f
      float gc[kOwn][4];
      load_state(gc, p.dhf ? p.dhf + so : nullptr);
      put_gc(gc);
      split_state(gc, sgh, sgl);
    }
    if (p.n_chunks > 1) stage_hs(hs);   // the last chunk's, from the walk
    float dA_acc = 0.f;          // warp 0
    for (int c = p.n_chunks - 1; c >= 0; --c) {
      const int64_t c0 = (int64_t)c * kL;
      const int Lc = (int)(p.S - c0 < kL ? p.S - c0 : kL);
      if (c != p.n_chunks - 1)
        __syncthreads();         // the last chunk's readers are done
      load_chunk(c0, Lc, true);
      stage_dy<P, kL, kThreads, false>(smem + Tl::oDyh, smem + Tl::oDyl, yg,
                                       p.st[4][2], c0, Lc, 0, tid, segw);
      if (c != p.n_chunks - 1 || c == 0) {   // h0, or from the workspace
        float h[kOwn][4];
        load_state(h, c == 0 ? (p.h0 ? p.h0 + so : nullptr)
                             : wsg + (int64_t)(c - 1) * (P * N));
        stage_hs(h);
      }
      mma::cp_async_wait_all();
      __syncthreads();           // x, B, C, dt, dY, h_s, Gc, red
      chunk_seg();
      // @probe phase:load
      const float seg_last = segw[kL - 1];
      const float seg_a = segw[ta], seg_b = segw[tb];
      const float dta = dts[ta], dtb = dts[tb];
      const float wa = mma::fast_exp2(seg_last - seg_a);
      const float wb = mma::fast_exp2(seg_last - seg_b);

      // Two passes over the column tiles jj >= warp (tau >= t) of the
      // warp's rows t, one tile's products live at a time: the first forms
      // C B^T and Q^T = (dY X^T) o D, Z^T's sums, Q^T o dt into shared
      // memory and GX = Q^T C; the second forms C B^T again, M^T = (C B^T)
      // o D and GB = M^T dY (8 more mma a tile, where holding GX and GB
      // together spilled registers)
      {
        uint32_t ba[kNK][4], xa[kPK][4];
#pragma unroll
        for (int kk = 0; kk < kNK; ++kk)
          mma::ldsm_x4(ba[kk], sb + mma::swz<kWN>(r0 + (lane & 15),
                                                  2 * kk + (lane >> 4)));
#pragma unroll
        for (int kk = 0; kk < kPK; ++kk)
          mma::ldsm_x4(xa[kk], sx + mma::swz<kWP>(r0 + (lane & 15),
                                                  2 * kk + (lane >> 4)));
        float gx[kNT][4] = {};
        float off_a = 0.f, off_b = 0.f;   // rows' sums beyond the diagonal
        // the column sums left of the diagonal tile are 0 (no later warp's
        // rectangle reaches them)
        for (int u = lane; u < r0; u += 32) colw[warp * kL + u] = 0.f;
        // a loop, not unrolled: one tile's registers at a time
#pragma unroll 1
        for (int jj = warp; jj < 4; ++jj) {
          float cs[2] = {0.f, 0.f}, cs1[2] = {0.f, 0.f};
          {
            float cb[2][4] = {}, qt[2][4] = {};   // C B^T; dY X^T, then o D
#pragma unroll
            for (int kk = 0; kk < kNK; ++kk) {
              uint32_t r[4];
              mma::ldsm_x4(r, sc + mma::swz<kWN>(16 * jj + (lane & 7) +
                                                     8 * (lane >> 4),
                                                 2 * kk + ((lane >> 3) & 1)));
              mma_x2(cb[0], cb[1], ba[kk], r);
            }
#pragma unroll
            for (int kk = 0; kk < kPK; ++kk) {
              const int off = mma::swz<kWP>(16 * jj + (lane & 7) +
                                                8 * (lane >> 4),
                                            2 * kk + ((lane >> 3) & 1));
              uint32_t r[4];
              mma::ldsm_x4(r, sdyh + off);
              mma_x2(qt[0], qt[1], xa[kk], r);
              mma::ldsm_x4(r, sdyl + off);
              mma_x2(qt[0], qt[1], xa[kk], r);
            }
#pragma unroll
            for (int j = 0; j < 2; ++j)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int u = 16 * jj + 8 * j + 2 * q + (e & 1);
                const int t = e >> 1 ? tb : ta;
                const float d = u >= t
                    ? mma::fast_exp2(segw[u] - (e >> 1 ? seg_b : seg_a))
                    : 0.f;
                qt[j][e] *= d;
                const float z = cb[j][e] * qt[j][e] * (e >> 1 ? dtb : dta);
                if (jj == warp) {
                  zw[(t - r0) * 17 + (u - r0)] = z;
                } else {
                  if (e >> 1) off_b += z;
                  else off_a += z;
                  if (j == 0) cs[e & 1] += z;
                  else cs1[e & 1] += z;
                }
              }
            // Q^T o dt as hi + lo into shared memory, for dC's rows
#pragma unroll
            for (int j = 0; j < 2; ++j)
#pragma unroll
              for (int hr = 0; hr < 2; ++hr) {
                const int row = hr ? tb : ta, col = 16 * jj + 8 * j + 2 * q;
                const float d = hr ? dtb : dta;
                uint32_t t[2];
                mma::split<2>(qt[j][2 * hr] * d, qt[j][2 * hr + 1] * d, t);
                const int off = mma::swz_el<8>(row, col);
                *reinterpret_cast<uint32_t*>(smem + Tl::oQh + off) = t[0];
                *reinterpret_cast<uint32_t*>(smem + Tl::oQl + off) = t[1];
              }
            // GX += Q^T C over the tile's tau, Q^T as hi + lo A operands
            uint32_t ah[4], al[4], t[2];
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              mma::split<2>(qt[j][0], qt[j][1], t);     // row g
              ah[2 * j] = t[0];
              al[2 * j] = t[1];
              mma::split<2>(qt[j][2], qt[j][3], t);     // row g + 8
              ah[2 * j + 1] = t[0];
              al[2 * j + 1] = t[1];
            }
#pragma unroll
            for (int jp = 0; jp < kNT / 2; ++jp) {
              uint32_t r[4];
              mma::ldsm_x4_t(r, sc + mma::swz<kWN>(16 * jj + (lane & 15),
                                                   2 * jp + (lane >> 4)));
              mma_x2(gx[2 * jp], gx[2 * jp + 1], ah, r);
              mma_x2(gx[2 * jp], gx[2 * jp + 1], al, r);
            }
          }
          // column sums over the warp's 16 rows (0 on the diagonal tile)
#pragma unroll
          for (int k = 0; k < 2; ++k)
#pragma unroll
            for (int o = 4; o < 32; o <<= 1) {
              cs[k] += __shfl_xor_sync(0xffffffffu, cs[k], o);
              cs1[k] += __shfl_xor_sync(0xffffffffu, cs1[k], o);
            }
          if (g == 0) {
            colw[warp * kL + 16 * jj + 2 * q] = cs[0];
            colw[warp * kL + 16 * jj + 2 * q + 1] = cs[1];
            colw[warp * kL + 16 * jj + 8 + 2 * q] = cs1[0];
            colw[warp * kL + 16 * jj + 8 + 2 * q + 1] = cs1[1];
          }
        }
        off_a = quad_sum(off_a);
        off_b = quad_sum(off_b);
        if (q == 0) {
          zw[g * 17 + 16] = off_a;
          zw[(g + 8) * 17 + 16] = off_b;
        }
        __syncwarp();
        if (lane < 16) {         // row suffixes, the beyond column last
          float run = 0.f;
          for (int k = 16; k >= 0; --k) {
            run += zw[lane * 17 + k];
            zw[lane * 17 + k] = run;
          }
        }
        __syncwarp();
        if (lane < 16) {         // column prefixes over rows l < t
          float run = 0.f;
          for (int l = 0; l < lane; ++l) run += zw[l * 17 + lane];
          rect[r0 + lane] = run;
        }

        // G^T x = GX + w_t X Gc -> dB = dt G^T x
        float* dba = dbg + (c0 + ta) * p.st[7][2] + 2 * q;
        float* dbb = dbg + (c0 + tb) * p.st[7][2] + 2 * q;
        float2 old[kNT][2];
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          old[j][0] = old2(dba + 8 * j, !first && ta < Lc);
          old[j][1] = old2(dbb + 8 * j, !first && tb < Lc);
        }
#pragma unroll
        for (int jp = 0; jp < kNT / 2; ++jp) {
          float o[2][4] = {};
#pragma unroll
          for (int kp = 0; kp < kPK; ++kp) {
            const int off = mma::swz<kWN>(16 * kp + (lane & 15),
                                          2 * jp + (lane >> 4));
            uint32_t r[4];
            mma::ldsm_x4_t(r, sgh + off);
            mma_x2(o[0], o[1], xa[kp], r);
            mma::ldsm_x4_t(r, sgl + off);
            mma_x2(o[0], o[1], xa[kp], r);
          }
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int j = 2 * jp + i;
            if (ta < Lc)
              add2(dba + 8 * j, dta * fmaf(wa, o[i][0], gx[j][0]),
                   dta * fmaf(wa, o[i][1], gx[j][1]), old[j][0]);
            if (tb < Lc)
              add2(dbb + 8 * j, dtb * fmaf(wb, o[i][2], gx[j][2]),
                   dtb * fmaf(wb, o[i][3], gx[j][3]), old[j][1]);
          }
        }

        // @probe phase:pass_a
        // The second pass, on the mirrored row tile 3 - warp: pass A walks
        // 4 - w column tiles, this one w + 1, so each warp walks five.
        // GB = M^T dY, both as hi + lo (hi.hi, hi.lo, lo.hi)
        const int rm = 16 * (3 - warp);
        const int ma = rm + g, mb = ma + 8;
        const float sma = segw[ma], smb = segw[mb];
        const float dma = dts[ma], dmb = dts[mb];
        const float wma = mma::fast_exp2(seg_last - sma);
        const float wmb = mma::fast_exp2(seg_last - smb);
#pragma unroll
        for (int kk = 0; kk < kNK; ++kk)
          mma::ldsm_x4(ba[kk], sb + mma::swz<kWN>(rm + (lane & 15),
                                                  2 * kk + (lane >> 4)));
#pragma unroll
        for (int kk = 0; kk < kPK; ++kk)
          mma::ldsm_x4(xa[kk], sx + mma::swz<kWP>(rm + (lane & 15),
                                                  2 * kk + (lane >> 4)));
        float gb[kPT][4] = {};
#pragma unroll 1
        for (int jj = 3 - warp; jj < 4; ++jj) {
          float mt[2][4] = {};
#pragma unroll
          for (int kk = 0; kk < kNK; ++kk) {
            uint32_t r[4];
            mma::ldsm_x4(r, sc + mma::swz<kWN>(16 * jj + (lane & 7) +
                                                   8 * (lane >> 4),
                                               2 * kk + ((lane >> 3) & 1)));
            mma_x2(mt[0], mt[1], ba[kk], r);
          }
          uint32_t ah[4], al[4], t[2];
#pragma unroll
          for (int j = 0; j < 2; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int u = 16 * jj + 8 * j + 2 * q + (e & 1);
              const int tr = e >> 1 ? mb : ma;
              mt[j][e] *= u >= tr
                  ? mma::fast_exp2(segw[u] - (e >> 1 ? smb : sma))
                  : 0.f;
            }
            mma::split<2>(mt[j][0], mt[j][1], t);       // row g
            ah[2 * j] = t[0];
            al[2 * j] = t[1];
            mma::split<2>(mt[j][2], mt[j][3], t);       // row g + 8
            ah[2 * j + 1] = t[0];
            al[2 * j + 1] = t[1];
          }
#pragma unroll
          for (int jp = 0; jp < kPT / 2; ++jp) {
            const int off = mma::swz<kWP>(16 * jj + (lane & 15),
                                          2 * jp + (lane >> 4));
            uint32_t rh[4], rl[4];
            mma::ldsm_x4_t(rh, sdyh + off);
            mma::ldsm_x4_t(rl, sdyl + off);
            mma_x2(gb[2 * jp], gb[2 * jp + 1], ah, rh);
            mma_x2(gb[2 * jp], gb[2 * jp + 1], ah, rl);
            // @probe one_term (the next line)
            mma_x2(gb[2 * jp], gb[2 * jp + 1], al, rh);
          }
        }

        // G B = GB + w_t B Gc^T -> dx = dt G B, q_t = x_t . G_t B_t,
        // beta_t = x_t . (B Gc^T)_t, on the mirrored rows
        {
          float qa = 0.f, qb = 0.f, be_a = 0.f, be_b = 0.f;
#pragma unroll
          for (int jp = 0; jp < kPT / 2; ++jp) {
            float o[2][4] = {};
#pragma unroll
            for (int kn = 0; kn < kNK; ++kn) {
              const int off = mma::swz<kWN>(16 * jp + (lane & 7) +
                                                8 * (lane >> 4),
                                            2 * kn + ((lane >> 3) & 1));
              uint32_t r[4];
              mma::ldsm_x4(r, sgh + off);
              mma_x2(o[0], o[1], ba[kn], r);
              mma::ldsm_x4(r, sgl + off);
              mma_x2(o[0], o[1], ba[kn], r);
            }
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              const int j = 2 * jp + i, col = 8 * j + 2 * q;
              const float2 xv = mma::unpack(xa[jp][2 * i]);       // row g
              const float2 xw = mma::unpack(xa[jp][2 * i + 1]);   // g + 8
              be_a = fmaf(xv.x, o[i][0], fmaf(xv.y, o[i][1], be_a));
              be_b = fmaf(xw.x, o[i][2], fmaf(xw.y, o[i][3], be_b));
              const float g0 = fmaf(wma, o[i][0], gb[j][0]);
              const float g1 = fmaf(wma, o[i][1], gb[j][1]);
              const float g2 = fmaf(wmb, o[i][2], gb[j][2]);
              const float g3 = fmaf(wmb, o[i][3], gb[j][3]);
              qa = fmaf(xv.x, g0, fmaf(xv.y, g1, qa));
              qb = fmaf(xw.x, g2, fmaf(xw.y, g3, qb));
              if (ma < Lc)
                *reinterpret_cast<__nv_bfloat162*>(
                    dxg + (c0 + ma) * p.st[5][2] + col) =
                    __floats2bfloat162_rn(dma * g0, dma * g1);
              if (mb < Lc)
                *reinterpret_cast<__nv_bfloat162*>(
                    dxg + (c0 + mb) * p.st[5][2] + col) =
                    __floats2bfloat162_rn(dmb * g2, dmb * g3);
            }
          }
          qa = quad_sum(qa);
          qb = quad_sum(qb);
          be_a = quad_sum(be_a);
          be_b = quad_sum(be_b);
          if (q == 0) {
            qv[ma] = qa;
            qv[mb] = qb;
            bv[ma] = be_a;
            bv[mb] = be_b;
          }
        }
      }
      // @probe phase:pass_b

      // dC's first term on the warp's rows tau: e_tau (dY h_s)_tau;
      // gamma_tau = C_tau . (dY h_s)_tau
      float dc[kNT][4] = {};
      {
#pragma unroll
        for (int kp = 0; kp < kPK; ++kp) {
          const int aoff = mma::swz<kWP>(r0 + (lane & 15),
                                         2 * kp + (lane >> 4));
          uint32_t yh[4], yl[4];
          mma::ldsm_x4(yh, sdyh + aoff);
          mma::ldsm_x4(yl, sdyl + aoff);
#pragma unroll
          for (int jp = 0; jp < kNT / 2; ++jp) {
            const int off = mma::swz<kWN>(16 * kp + (lane & 15),
                                          2 * jp + (lane >> 4));
            uint32_t rh[4], rl[4];
            mma::ldsm_x4_t(rh, shh + off);
            mma::ldsm_x4_t(rl, shl + off);
            mma_x2(dc[2 * jp], dc[2 * jp + 1], yh, rh);
            mma_x2(dc[2 * jp], dc[2 * jp + 1], yh, rl);
            mma_x2(dc[2 * jp], dc[2 * jp + 1], yl, rh);
          }
        }
        float ga = 0.f, gbb = 0.f;
#pragma unroll
        for (int kk = 0; kk < kNK; ++kk) {
          uint32_t ca[4];
          mma::ldsm_x4(ca, sc + mma::swz<kWN>(r0 + (lane & 15),
                                              2 * kk + (lane >> 4)));
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int j = 2 * kk + i;
            const float2 cv = mma::unpack(ca[2 * i]);
            const float2 cw = mma::unpack(ca[2 * i + 1]);
            ga = fmaf(cv.x, dc[j][0], fmaf(cv.y, dc[j][1], ga));
            gbb = fmaf(cw.x, dc[j][2], fmaf(cw.y, dc[j][3], gbb));
          }
        }
        ga = quad_sum(ga);
        gbb = quad_sum(gbb);
        if (q == 0) {
          gv[ta] = ga;
          gv[tb] = gbb;
        }
        const float ea = mma::fast_exp2(seg_a), eb = mma::fast_exp2(seg_b);
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          dc[j][0] *= ea;
          dc[j][1] *= ea;
          dc[j][2] *= eb;
          dc[j][3] *= eb;
        }
      }
      // @probe phase:dc_inter
      __syncthreads();           // Q^T o dt, rect, colw, q, beta, gamma;
                                 // every read of dY done
      // @probe phase:barrier2

      // dC += (Q^T o dt)^T B over the column tiles kk <= warp (l <= tau)
      float* dca = dcg + (c0 + ta) * p.st[8][2] + 2 * q;
      float* dcb = dcg + (c0 + tb) * p.st[8][2] + 2 * q;
      float2 oldc[kNT][2];
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        oldc[j][0] = old2(dca + 8 * j, !first && ta < Lc);
        oldc[j][1] = old2(dcb + 8 * j, !first && tb < Lc);
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (kk > warp) break;
        const int aoff = mma::swz<8>(16 * kk + (lane & 7) + 8 * (lane >> 4),
                                     2 * warp + ((lane >> 3) & 1));
        uint32_t ah[4], al[4];
        mma::ldsm_x4_t(ah, sqh + aoff);
        mma::ldsm_x4_t(al, sql + aoff);
#pragma unroll
        for (int jp = 0; jp < kNT / 2; ++jp) {
          uint32_t r[4];
          mma::ldsm_x4_t(r, sb + mma::swz<kWN>(16 * kk + (lane & 15),
                                               2 * jp + (lane >> 4)));
          mma_x2(dc[2 * jp], dc[2 * jp + 1], ah, r);
          mma_x2(dc[2 * jp], dc[2 * jp + 1], al, r);
        }
      }
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        if (ta < Lc) add2(dca + 8 * j, dc[j][0], dc[j][1], oldc[j][0]);
        if (tb < Lc) add2(dcb + 8 * j, dc[j][2], dc[j][3], oldc[j][1]);
      }
      // e o dy over dY, the warp's rows
      stage_dy<P, 16, 32, true>(smem + Tl::oDyh, smem + Tl::oDyl, yg,
                                p.st[4][2], c0, Lc, r0, lane, segw);

      // lambda, ddt and dA by warp 0
      if (warp == 0) {
        const float d0 = dts[lane], d1 = dts[lane + 32];
        const float sa = segw[lane], sb_ = segw[lane + 32];
        float p0 = mma::fast_exp2(seg_last - sa) * d0 * bv[lane];
        float p1 = mma::fast_exp2(seg_last - sb_) * d1 * bv[lane + 32];
        scan64(p0, p1, lane, false);
        {                        // exclusive: rows l < t
          const float u0 = __shfl_up_sync(0xffffffffu, p0, 1);
          const float u1 = __shfl_up_sync(0xffffffffu, p1, 1);
          const float top = __shfl_sync(0xffffffffu, p0, 31);
          p0 = lane ? u0 : 0.f;
          p1 = lane ? u1 : top;
        }
        float s0_ = mma::fast_exp2(sa) * gv[lane];
        float s1_ = mma::fast_exp2(sb_) * gv[lane + 32];
        scan64(s0_, s1_, lane, true);
        // the rectangles' parts from the warps above a row's own: the
        // suffixes of their column sums
        float t0 = rect[lane], t1 = rect[lane + 32];
#pragma unroll
        for (int w = 0; w < 3; ++w) {
          float c0_ = colw[w * kL + lane], c1_ = colw[w * kL + lane + 32];
          scan64(c0_, c1_, lane, true);
          if (lane >= 16 * (w + 1)) t0 += c0_;
          if (lane + 32 >= 16 * (w + 1)) t1 += c1_;
        }
        const float gh = mma::fast_exp2(seg_last) *
                         (((red[0] + red[1]) + red[2]) + red[3]);
        const float l0 = ((gh + p0) + s0_) + t0;
        const float l1 = ((gh + p1) + s1_) + t1;
        if (lane < Lc)
          st1(ddg + (c0 + lane) * p.st[6][2], fmaf(A, l0, qv[lane]));
        if (lane + 32 < Lc)
          st1(ddg + (c0 + lane + 32) * p.st[6][2],
              fmaf(A, l1, qv[lane + 32]));
        float da = fmaf(d0, l0, d1 * l1);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          da += __shfl_xor_sync(0xffffffffu, da, o);
        dA_acc += da;
      }
      // @probe phase:dc_lambda
      __syncthreads();           // e o dy
      // @probe phase:barrier3

      // Gc <- e_last Gc + (e o dY)^T C, the warp's quarter
      auto update_gc = [&]() {
        const float decay = mma::fast_exp2(seg_last);
        float gc[kOwn][4];
        get_gc(gc);
#pragma unroll
        for (int i = 0; i < kOwn; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) gc[i][e] *= decay;
#pragma unroll
        for (int kk = 0; kk < kL / 16; ++kk) {
          const int aoff = mma::swz<kWP>(16 * kk + (lane & 7) +
                                             8 * (lane >> 4),
                                         2 * pt + ((lane >> 3) & 1));
          uint32_t ah[4], al[4];
          mma::ldsm_x4_t(ah, sdyh + aoff);
          mma::ldsm_x4_t(al, sdyl + aoff);
#pragma unroll
          for (int i = 0; i < kOwn; ++i) {
            uint32_t r[2];
            mma::ldsm_x2_t(r, sc + mma::swz<kWN>(16 * kk + (lane & 15),
                                                 jof(i)));
            mma::mma_bf16(gc[i], ah, r[0], r[1]);
            mma::mma_bf16(gc[i], al, r[0], r[1]);
          }
        }
        put_gc(gc);
        split_state(gc, sgh, sgl);   // every read of the old terms is done
      };
      // @probe state-update (the next line)
      update_gc();
      // @probe phase:gc
    }
    if (p.dh0) {
      float gc[kOwn][4];
      get_gc(gc);
      store_state(gc, p.dh0 + so);
    }
    if (tid == 0) p.dA[b * p.H + h] = dA_acc;
  }
  // @probe epilogue
}

// ===================== fp32 x, B and C: ssd_bwd_mma_f32 ======================
//
// The same gradient on fp32 x, B and C (variant mma_f32, what fp32
// training runs): ssd_bwd_mma's algebra and orientation, with every factor
// of a tensor-core product in bf16 terms, three for x, B, C, dY, M^T, Q^T,
// Gc and e o dY and two for h_s and the forward walk's B o w o dt (a
// product of two three-term factors six mma: hi.hi, hi.mid, mid.hi,
// hi.lo, mid.mid, lo.hi, the small ones first).  The fewest terms with
// which the float64 mirror of these rounding points
// (ref.ssm_scan_bwd_f32_mirror, tests/test_torch_scan_grad.py) stays
// within 2x of ssd_bwd_simt's fp32 distance from float64 at every shape.
// Three more rules from the mirror:
//   - the within-chunk cumsum of dt A is kept as a compensated pair (hi,
//     lo; a two-sum scan), and every decay is exp2 of a difference of
//     two such pairs: the plain fp32 cumsum's rounding in exp(seg_tau -
//     seg_t) is what puts the SIMT kernel 2-34x as far from float64 as
//     plain fp32 autograd, and its mirror's gap to the SIMT one's sat
//     at 0.4-1.9x;
//   - the tensor cores truncate each mma's sum, so every product of a
//     chunk starts from a zeroed partial, and the two sums carried from
//     chunk to chunk (h walking forward, Gc walking back) take each
//     k-step's products into a zeroed partial added rounded to nearest
//     (chained into the carried sum, dh0 read 2.76x);
//   - a k-step's term pairs are issued together (its fragments loaded
//     once), the small ones first.
// x, B, C and dY land as three bf16 term planes each (split as they land
// from fp32 rows read as float4: no pre-pass), and e o dY is formed from
// dY's planes in place.  Shared memory at P = N = 64 is 191,008 bytes:
// one block an SM.  So the block has eight warps, and passes A and B, on
// four warps each, run at once: warps 0-3 pass A on rows 16w.. (C B^T,
// Q^T, Z^T's sums, Q^T o dt, GX, then dB with X Gc), warps 4-7 pass B on
// rows 16 (3 - w).. (M^T, GB, B Gc^T, dx, q, beta) and dC's first term on
// rows 16w..; after a barrier warps 4-7 add dC's second term and warps
// 0-3 form e o dY, warp 0 lambda; after another, all eight warps update
// Gc, a state tile or more each, and walk the forward states the same
// way.  One head a block, so each block writes its head's own dB and dC
// partial (two and four heads a block, adding into one, were slower at
// the training shapes and the full layer).
//
// What bounds it.  At zamba2 100m's training shape (B 32, S 128, H 24, P
// = N = 64) the causal chunk products that a call with no h0 and no dh_f
// needs come to 4.06e9 flops; as bf16 term products (six for a product of
// two three-term factors, five where one factor has two terms) 2.35e10,
// 23.8 us at 989 TFLOP/s, against 80.5 MB, 24.0 us at 3.35 TB/s: the
// bytes bound it there, the term products at the zamba2-1.2b layer (B 4,
// S 4096, H 64: 371.6 us; chip_smoke.py's ssd_bwd_bounds).
// The kernel forms the full 16 x 16 diagonal tiles and issues ~6,700
// m16n8k16 a chunk and head on mma.sync, and with one block of eight
// warps an SM it is bound by latency: the products' dependent sums, the
// load round a chunk (a block has nothing to overlap it with) and pass
// A's warp 0, which walks four column tiles where warp 3 walks one
// (tools/ssd_bwd_probe.py --fp32: cycles by phase).  Lines "// @probe f32
// <name>" mark its probe points.

constexpr int kT3 = 3;           // terms of x, B, C, dY, M^T, Q^T, Gc, e o dY
constexpr int kT2 = 2;           // terms of h_s and the walk's B o w o dt
constexpr int kThreadsF = 256;   // ssd_bwd_mma_f32: eight warps
constexpr int kWarpsF = kThreadsF / 32;

// Shared memory of one ssd_bwd_mma_f32 block, in bytes: three bf16 term
// planes each of x and dY [kL][P], B and C [kL][N], Gc [P][N] and Q^T o dt
// [kL][kL], two of h_s [P][N] (all swizzled); then fp32: dt [kL], each of
// the 8 warps' compensated seg (hi [8][kL], lo [8][kL]), pass A's column
// sums of Z^T [4][kL], the rectangle sums, q, beta and gamma [kL] each,
// <Gc, h_s> a warp [8], pass A's 16 x 17 Z^T scratch [4] and Gc (P * N,
// or 1,024 at P 32 / N 16: a warp's tile at least), each thread's own
// fragment values.  kernels/ssm_scan/kernel.py's
// bwd_smem_bytes ("mma_f32") mirrors this.
template <int P, int N>
struct TileF32 {
  static constexpr int kX = kL * P * 2;   // one plane of x or dY
  static constexpr int kBC = kL * N * 2;  // ... of B or C
  static constexpr int kS = P * N * 2;    // ... of Gc or h_s
  static constexpr int kQ = kL * kL * 2;  // ... of Q^T o dt
  static constexpr int oX = 0;
  static constexpr int oB = oX + kT3 * kX;
  static constexpr int oC = oB + kT3 * kBC;
  static constexpr int oDy = oC + kT3 * kBC;
  static constexpr int oG = oDy + kT3 * kX;
  static constexpr int oH = oG + kT3 * kS;
  static constexpr int oQ = oH + kT2 * kS;
  static constexpr int oF = oQ + kT3 * kQ;
  // Gc's fp32 values: 4 a state tile a thread, one tile a warp at least
  static constexpr int kGc =
      ((N / 8) * (P / 16) + kWarpsF - 1) / kWarpsF * 4 * kThreadsF;
  static constexpr int kFloats = kL + 2 * kWarpsF * kL + 4 * kL + 4 * kL +
                                 kWarpsF + 4 * 16 * 17 + kGc;
  static constexpr int kBytes = oF + 4 * kFloats;
};

// the term-product and compensated-scan helpers shared with ssd_fwd_mma_f32
// (mma.cuh)
using mma::exp2_2;
using mma::exp2_d;
using mma::ldsm_k;
using mma::ldsm_k_t;
using mma::mma_terms_n;
using mma::mma_terms_xn;
using mma::pair3;
using mma::scan64_2;
using mma::two_sum;

// The rows of a chunk of fp32 x, B, C or dY (C columns; 0 at rows past
// Lc) into registers and then, as three bf16 terms, into the planes of a
// swizzled tile (C / 8 chunks a row, `plane` bytes apart): thread tid of
// kThreadsF loads float4 e = tid + i kThreadsF of the kL x C tile.  A chunk
// issues every tensor's loads before the first split, so that their
// latencies overlap
template <int C>
struct Rows {
  static constexpr int kC4 = C / 4;
  static constexpr int kIt = kL * kC4 / kThreadsF;
  static_assert(kL * kC4 % kThreadsF == 0, "tiling");
  float4 v[kIt];

  __device__ __forceinline__ void load(const float* src, int64_t rs, int Lc,
                                       int tid) {
#pragma unroll
    for (int i = 0; i < kIt; ++i) {
      const int e = tid + i * kThreadsF, row = e / kC4, col = 4 * (e % kC4);
      v[i] = row < Lc
          ? *reinterpret_cast<const float4*>(src + row * rs + col)
          : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }

  __device__ __forceinline__ void split(unsigned char* dst, int plane,
                                        int tid) const {
#pragma unroll
    for (int i = 0; i < kIt; ++i) {
      const int e = tid + i * kThreadsF, row = e / kC4, col = 4 * (e % kC4);
      uint32_t a[kT3], b[kT3];
      mma::split<kT3>(v[i].x, v[i].y, a);
      mma::split<kT3>(v[i].z, v[i].w, b);
      const int off = mma::swz_el<C / 8>(row, col);
#pragma unroll
      for (int k = 0; k < kT3; ++k)
        *reinterpret_cast<uint2*>(dst + k * plane + off) =
            make_uint2(a[k], b[k]);
    }
  }
};

template <typename TD, int P, int N>
__global__ void __launch_bounds__(kThreadsF, 1)
ssd_bwd_mma_f32(const ParamsT<float> p) {
  static_assert((P == 32 || P == 64) && (N == 16 || N == 64), "tiling");
  using Tl = TileF32<P, N>;
  constexpr int kWP = P / 8;     // 16-byte chunks in a row of a plane of x
  constexpr int kWN = N / 8;     // ... of B, C, Gc and h_s
  constexpr int kPK = P / 16;    // k-steps over P
  constexpr int kNK = N / 16;    // k-steps over N
  constexpr int kPT = P / 8;     // n8 tiles over P
  constexpr int kNT = N / 8;     // n8 tiles over N
  constexpr int kPM = P / 16;    // m16 tiles of a state over P
  // the (m16, n8) tiles of a (P, N) state: warp w owns tiles w, w + 8, ..
  // (all of one m16 row of tiles, as kPM divides 8)
  constexpr int kTiles = kNT * kPM;
  constexpr int kOwn = (kTiles + kWarpsF - 1) / kWarpsF;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t s0 = mma::smem_u32(smem);
  const uint32_t sx = s0 + Tl::oX, sb = s0 + Tl::oB, sc = s0 + Tl::oC;
  const uint32_t sdy = s0 + Tl::oDy, sg = s0 + Tl::oG, sh = s0 + Tl::oH;
  const uint32_t sq = s0 + Tl::oQ;
  float* dts = reinterpret_cast<float*>(smem + Tl::oF);   // [kL]
  float* segs = dts + kL;        // [8][kL] hi, log2 units, a warp
  float* segls = segs + kWarpsF * kL;   // [8][kL] lo
  float* colw = segls + kWarpsF * kL;   // [4][kL] column sums of Z^T
  float* rect = colw + 4 * kL;   // [kL] the rectangle sums
  float* qv = rect + kL;         // [kL] x_t . G_t B_t
  float* bv = qv + kL;           // [kL] beta_t = x_t . Gc B_t
  float* gv = bv + kL;           // [kL] gamma_t = C_t . (dY h_s)_t
  float* red = gv + kL;          // [8]  <Gc, h_s>, a warp
  float* zscr = red + kWarpsF;   // [4][16][17]
  float* gcf = zscr + 4 * 16 * 17;   // [kOwn * 4][kThreadsF] Gc, fp32

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int q = lane & 3;
  const int64_t b = blockIdx.y;
  // warps 0-3 run pass A on rows 16w.. of a chunk; warps 4-7 pass B on
  // rows 16 (3 - w).. and dC on rows 16w..
  const bool pass_b = warp >= 4;
  const int w = warp & 3;
  float* segw = segs + warp * kL;
  float* seglw = segls + warp * kL;
  float* zw = zscr + w * 16 * 17;
  const int pt = warp % kPM;     // the m16 row of the warp's state tiles
  auto own = [&](int i) { return warp + kWarpsF * i < kTiles; };
  auto jof = [&](int i) { return (warp + kWarpsF * i) / kPM; };
  const int r0 = 16 * w;
  const int ta = r0 + g, tb = ta + 8;

  auto load_state = [&](float (&s)[kOwn][4], const float* src) {
#pragma unroll
    for (int i = 0; i < kOwn; ++i)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int row = 16 * pt + g + 8 * hr, col = 8 * jof(i) + 2 * q;
        const float2 v = src && own(i)
                             ? *reinterpret_cast<const float2*>(
                                   src + row * N + col)
                             : make_float2(0.f, 0.f);
        s[i][2 * hr] = v.x;
        s[i][2 * hr + 1] = v.y;
      }
  };
  auto store_state = [&](const float (&s)[kOwn][4], float* dst) {
#pragma unroll
    for (int i = 0; i < kOwn; ++i)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int row = 16 * pt + g + 8 * hr, col = 8 * jof(i) + 2 * q;
        if (own(i))
          *reinterpret_cast<float2*>(dst + row * N + col) =
              make_float2(s[i][2 * hr], s[i][2 * hr + 1]);
      }
  };
  auto get_gc = [&](float (&s)[kOwn][4]) {
#pragma unroll
    for (int i = 0; i < kOwn; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[i][e] = gcf[(4 * i + e) * kThreadsF + tid];
  };
  auto put_gc = [&](const float (&s)[kOwn][4]) {
#pragma unroll
    for (int i = 0; i < kOwn; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        gcf[(4 * i + e) * kThreadsF + tid] = s[i][e];
  };
  // a state's three terms (Gc) or two (h_s) into the [P][N] planes at `at`
  auto split_state = [&](const float (&s)[kOwn][4], int at, bool three) {
#pragma unroll
    for (int i = 0; i < kOwn; ++i)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        if (!own(i)) continue;
        const int row = 16 * pt + g + 8 * hr, col = 8 * jof(i) + 2 * q;
        uint32_t t[kT3];
        mma::split<kT3>(s[i][2 * hr], s[i][2 * hr + 1], t);
        const int off = mma::swz_el<kWN>(row, col);
        unsigned char* dst = smem + at + off;
        *reinterpret_cast<uint32_t*>(dst) = t[0];
        *reinterpret_cast<uint32_t*>(dst + Tl::kS) = t[1];
        if (three) *reinterpret_cast<uint32_t*>(dst + 2 * Tl::kS) = t[2];
      }
  };
  // s += a^T f over the kL rows of a chunk, the warp's state tiles: the A
  // operand from the three planes at `at` (x, or e o dY), the B operand
  // the rows of B or C (three planes at `bt`), times wrow[row] if wrow
  // is given (then in two terms: the walk's B o w o dt), each k-step's
  // products into a zeroed partial
  auto state_product = [&](float (&s)[kOwn][4], uint32_t at, uint32_t bt,
                           const float* wrow) {
#pragma unroll 1
    for (int kk = 0; kk < kL / 16; ++kk) {
      uint32_t a[kT3][4];
      ldsm_k_t(a, at + mma::swz<kWP>(16 * kk + (lane & 7) + 8 * (lane >> 4),
                                     2 * pt + ((lane >> 3) & 1)),
               Tl::kX);
      float part[kOwn][4] = {};
      if (wrow) {
        const int la = 16 * kk + 2 * q, lb = la + 8;
        const float wv[4] = {wrow[la], wrow[la + 1], wrow[lb], wrow[lb + 1]};
        uint32_t bw[kOwn][kT2][2];
#pragma unroll
        for (int i = 0; i < kOwn; ++i) {
          uint32_t r[kT3][2];
#pragma unroll
          for (int k = 0; k < kT3; ++k)
            mma::ldsm_x2_t(r[k], bt + k * Tl::kBC +
                                     mma::swz<kWN>(16 * kk + (lane & 15),
                                                   own(i) ? jof(i) : 0));
#pragma unroll
          for (int m = 0; m < 2; ++m) {        // r[.][0]: rows la, [1]: lb
            const float2 f0 = mma::unpack(r[0][m]);
            const float2 f1 = mma::unpack(r[1][m]);
            const float2 f2 = mma::unpack(r[2][m]);
            uint32_t t[kT2];
            mma::split<kT2>(((f0.x + f1.x) + f2.x) * wv[2 * m],
                            ((f0.y + f1.y) + f2.y) * wv[2 * m + 1], t);
#pragma unroll
            for (int k = 0; k < kT2; ++k) bw[i][k][m] = t[k];
          }
        }
        mma_terms_n(part, a, bw);
      } else {
        uint32_t r[kOwn][kT3][2];
#pragma unroll
        for (int i = 0; i < kOwn; ++i)
#pragma unroll
          for (int k = 0; k < kT3; ++k)
            mma::ldsm_x2_t(r[i][k], bt + k * Tl::kBC +
                                        mma::swz<kWN>(16 * kk + (lane & 15),
                                                      own(i) ? jof(i) : 0));
        mma_terms_n(part, a, r);
      }
#pragma unroll
      for (int i = 0; i < kOwn; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[i][e] += part[i][e];
    }
  };

  // @probe f32 start
  const int h = blockIdx.x;
  const int64_t grp = h / p.rep;
  const float A = p.A[h];
  const float A2 = A * kLog2e;
  const float* xg = p.x + b * p.st[0][0] + h * p.st[0][1];
  const TD* dg = static_cast<const TD*>(p.dt) + b * p.st[1][0] +
                 h * p.st[1][1];
  const float* bg = p.bm + b * p.st[2][0] + grp * p.st[2][1];
  const float* cg = p.cm + b * p.st[3][0] + grp * p.st[3][1];
  const float* yg = p.dy + b * p.st[4][0] + h * p.st[4][1];
  float* dxg = p.dx + b * p.st[5][0] + h * p.st[5][1];
  TD* ddg = static_cast<TD*>(p.ddt) + b * p.st[6][0] + h * p.st[6][1];
  float* dbg = p.dB + b * p.st[7][0] + h * p.st[7][1];
  float* dcg = p.dC + b * p.st[8][0] + h * p.st[8][1];
  const int64_t so = (b * p.H + h) * (int64_t)(P * N);
  float* wsg = p.ws + (b * p.H + h) * (int64_t)p.n_ws * (P * N);

  // dt of the chunk at c0 into dts (0 past S); x and B (and dY and C)
  // as three bf16 terms each, every load (dt's too) issued before the
  // first split
  auto load_chunk = [&](int c, bool all) {
    const int64_t c0 = (int64_t)c * kL;
    const int Lc = (int)(p.S - c0 < kL ? p.S - c0 : kL);
    const float dtv = tid < Lc ? ld(dg + (c0 + tid) * p.st[1][2]) : 0.f;
    Rows<P> xr, yr;
    Rows<N> br, cr;
    xr.load(xg + c0 * p.st[0][2], p.st[0][2], Lc, tid);
    br.load(bg + c0 * p.st[2][2], p.st[2][2], Lc, tid);
    if (all) {
      yr.load(yg + c0 * p.st[4][2], p.st[4][2], Lc, tid);
      cr.load(cg + c0 * p.st[3][2], p.st[3][2], Lc, tid);
    }
    xr.split(smem + Tl::oX, Tl::kX, tid);
    br.split(smem + Tl::oB, Tl::kBC, tid);
    if (all) {
      yr.split(smem + Tl::oDy, Tl::kX, tid);
      cr.split(smem + Tl::oC, Tl::kBC, tid);
    }
    if (tid < kL) dts[tid] = dtv;
  };
  // each warp's own compensated seg (after a barrier past load_chunk)
  auto chunk_seg = [&]() {
    float h0 = dts[lane] * A2, h1 = dts[lane + 32] * A2;
    float l0 = 0.f, l1 = 0.f;
    scan64_2(h0, l0, h1, l1, lane);
    segw[lane] = h0;
    segw[lane + 32] = h1;
    seglw[lane] = l0;
    seglw[lane + 32] = l1;
    __syncwarp();
  };

  // ---- forward walk: the chunk-start states ----------------------------
  float hs[kOwn][4];           // the state, the warp's tiles
  load_state(hs, p.h0 ? p.h0 + so : nullptr);
  for (int c = 0; c + 1 < p.n_chunks; ++c) {
    __syncthreads();           // the last readers of x, B and dts are done
    load_chunk(c, false);
    __syncthreads();
    chunk_seg();
    const float hl = segw[kL - 1], ll = seglw[kL - 1];
    const float decay = exp2_2(hl, ll);
#pragma unroll
    for (int i = 0; i < kOwn; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) hs[i][e] *= decay;
    {                          // w_t dt_t over the warp's lo row
      float wv0 = exp2_d(hl, ll, segw[lane], seglw[lane]) * dts[lane];
      float wv1 = exp2_d(hl, ll, segw[lane + 32], seglw[lane + 32]) *
                  dts[lane + 32];
      __syncwarp();
      seglw[lane] = wv0;       // the warp's lo row, read no more
      seglw[lane + 32] = wv1;
      __syncwarp();
    }
    // state += x^T (B o w o dt), B o w o dt in two terms
    state_product(hs, sx, sb, seglw);
    if (c + 1 < p.n_chunks - 1)                // chunk c + 1's start state
      store_state(hs, wsg + (int64_t)c * (P * N));
  }

  // ---- reverse walk ----------------------------------------------------
  auto stage_hs = [&](const float (&hv)[kOwn][4]) {
    split_state(hv, Tl::oH, false);
    float part = 0.f;
#pragma unroll
    for (int i = 0; i < kOwn; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (own(i))
          part = fmaf(gcf[(4 * i + e) * kThreadsF + tid], hv[i][e], part);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      part += __shfl_xor_sync(0xffffffffu, part, o);
    if (lane == 0) red[warp] = part;
  };
  __syncthreads();             // the forward walk's readers are done
  {                            // Gc, the warp's tiles, from dh_f
    float gc[kOwn][4];
    load_state(gc, p.dhf ? p.dhf + so : nullptr);
    put_gc(gc);
    split_state(gc, Tl::oG, true);
  }
  if (p.n_chunks > 1) stage_hs(hs);   // the last chunk's, from the walk
  float dA_acc = 0.f;          // warp 0
  for (int c = p.n_chunks - 1; c >= 0; --c) {
    const int64_t c0 = (int64_t)c * kL;
    const int Lc = (int)(p.S - c0 < kL ? p.S - c0 : kL);
    if (c != p.n_chunks - 1)
      __syncthreads();         // the last chunk's readers are done
    load_chunk(c, true);
    if (c != p.n_chunks - 1 || c == 0) {   // h0, or from the workspace
      float hv[kOwn][4];
      load_state(hv, c == 0 ? (p.h0 ? p.h0 + so : nullptr)
                            : wsg + (int64_t)(c - 1) * (P * N));
      stage_hs(hv);
    }
    __syncthreads();           // x, B, C, dt, dY, h_s, Gc, red
    chunk_seg();
    // @probe f32 phase:load
    const float hl = segw[kL - 1], ll = seglw[kL - 1];
    const float seg_a = segw[ta], seg_b = segw[tb];
    const float sl_a = seglw[ta], sl_b = seglw[tb];
    const float dta = dts[ta], dtb = dts[tb];
    float dc[kNT][4] = {};     // dC on rows 16w.., warps 4-7

    if (!pass_b) {
      // Pass A over the column tiles jj >= w (tau >= t) of rows t: C B^T
      // and Q^T = (dY X^T) o D, Z^T's sums, Q^T o dt into shared memory
      // and GX = Q^T C, one tile's products live at a time
      const float wa = exp2_d(hl, ll, seg_a, sl_a);
      const float wb = exp2_d(hl, ll, seg_b, sl_b);
      float gx[kNT][4] = {};
      float off_a = 0.f, off_b = 0.f;
      for (int u = lane; u < r0; u += 32) colw[w * kL + u] = 0.f;
#pragma unroll 1
      for (int jj = w; jj < 4; ++jj) {
        float cs[2] = {0.f, 0.f}, cs1[2] = {0.f, 0.f};
        {
          float cb[2][4] = {}, qt[2][4] = {};
#pragma unroll 2
          for (int kk = 0; kk < kNK; ++kk) {
            uint32_t a[kT3][4], r[1][kT3][4];
            ldsm_k(a, sb + mma::swz<kWN>(r0 + (lane & 15),
                                         2 * kk + (lane >> 4)), Tl::kBC);
            ldsm_k(r[0], sc + mma::swz<kWN>(16 * jj + (lane & 7) +
                                                8 * (lane >> 4),
                                            2 * kk + ((lane >> 3) & 1)),
                   Tl::kBC);
            mma_terms_xn(cb, a, r);
          }
#pragma unroll 2
          for (int kk = 0; kk < kPK; ++kk) {
            uint32_t a[kT3][4], r[1][kT3][4];
            ldsm_k(a, sx + mma::swz<kWP>(r0 + (lane & 15),
                                         2 * kk + (lane >> 4)), Tl::kX);
            ldsm_k(r[0], sdy + mma::swz<kWP>(16 * jj + (lane & 7) +
                                                 8 * (lane >> 4),
                                             2 * kk + ((lane >> 3) & 1)),
                   Tl::kX);
            mma_terms_xn(qt, a, r);
          }
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int u = 16 * jj + 8 * j + 2 * q + (e & 1);
              const int t = e >> 1 ? tb : ta;
              const float d = u >= t
                  ? exp2_d(segw[u], seglw[u], e >> 1 ? seg_b : seg_a,
                           e >> 1 ? sl_b : sl_a)
                  : 0.f;
              qt[j][e] *= d;
              const float z = cb[j][e] * qt[j][e] * (e >> 1 ? dtb : dta);
              if (jj == w) {
                zw[(t - r0) * 17 + (u - r0)] = z;
              } else {
                if (e >> 1) off_b += z;
                else off_a += z;
                if (j == 0) cs[e & 1] += z;
                else cs1[e & 1] += z;
              }
            }
          // Q^T o dt as three terms into shared memory, for dC's rows
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int hr = 0; hr < 2; ++hr) {
              const int row = hr ? tb : ta, col = 16 * jj + 8 * j + 2 * q;
              const float d = hr ? dtb : dta;
              uint32_t t[kT3];
              mma::split<kT3>(qt[j][2 * hr] * d, qt[j][2 * hr + 1] * d, t);
              const int off = mma::swz_el<8>(row, col);
#pragma unroll
              for (int k = 0; k < kT3; ++k)
                *reinterpret_cast<uint32_t*>(smem + Tl::oQ + k * Tl::kQ +
                                             off) = t[k];
            }
          // GX += Q^T C over the tile's tau, Q^T as three A terms
          uint32_t a[kT3][4];
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int hr = 0; hr < 2; ++hr) {
              uint32_t t[kT3];
              mma::split<kT3>(qt[j][2 * hr], qt[j][2 * hr + 1], t);
#pragma unroll
              for (int k = 0; k < kT3; ++k) a[k][2 * j + hr] = t[k];
            }
          uint32_t r[kNT / 2][kT3][4];
#pragma unroll
          for (int jp = 0; jp < kNT / 2; ++jp)
            ldsm_k_t(r[jp], sc + mma::swz<kWN>(16 * jj + (lane & 15),
                                               2 * jp + (lane >> 4)),
                     Tl::kBC);
          mma_terms_xn(gx, a, r);
        }
#pragma unroll
        for (int k = 0; k < 2; ++k)
#pragma unroll
          for (int o = 4; o < 32; o <<= 1) {
            cs[k] += __shfl_xor_sync(0xffffffffu, cs[k], o);
            cs1[k] += __shfl_xor_sync(0xffffffffu, cs1[k], o);
          }
        if (g == 0) {
          colw[w * kL + 16 * jj + 2 * q] = cs[0];
          colw[w * kL + 16 * jj + 2 * q + 1] = cs[1];
          colw[w * kL + 16 * jj + 8 + 2 * q] = cs1[0];
          colw[w * kL + 16 * jj + 8 + 2 * q + 1] = cs1[1];
        }
      }
      off_a = quad_sum(off_a);
      off_b = quad_sum(off_b);
      if (q == 0) {
        zw[g * 17 + 16] = off_a;
        zw[(g + 8) * 17 + 16] = off_b;
      }
      __syncwarp();
      if (lane < 16) {         // row suffixes, the beyond column last
        float run = 0.f;
        for (int k = 16; k >= 0; --k) {
          run += zw[lane * 17 + k];
          zw[lane * 17 + k] = run;
        }
      }
      __syncwarp();
      if (lane < 16) {         // column prefixes over rows l < t
        float run = 0.f;
        for (int l = 0; l < lane; ++l) run += zw[l * 17 + lane];
        rect[r0 + lane] = run;
      }

      // G^T x = GX + w_t X Gc -> dB = dt G^T x (a later head of the
      // block adds to the partial, loaded at the store)
      float o[kNT][4] = {};
#pragma unroll
      for (int kp = 0; kp < kPK; ++kp) {
        uint32_t a[kT3][4], r[kNT / 2][kT3][4];
        ldsm_k(a, sx + mma::swz<kWP>(r0 + (lane & 15),
                                     2 * kp + (lane >> 4)), Tl::kX);
#pragma unroll
        for (int jp = 0; jp < kNT / 2; ++jp)
          ldsm_k_t(r[jp], sg + mma::swz<kWN>(16 * kp + (lane & 15),
                                             2 * jp + (lane >> 4)),
                   Tl::kS);
        mma_terms_xn(o, a, r);
      }
      float* dba = dbg + (c0 + ta) * p.st[7][2] + 2 * q;
      float* dbb = dbg + (c0 + tb) * p.st[7][2] + 2 * q;
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        if (ta < Lc)
          put2(dba + 8 * j, dta * fmaf(wa, o[j][0], gx[j][0]),
               dta * fmaf(wa, o[j][1], gx[j][1]));
        if (tb < Lc)
          put2(dbb + 8 * j, dtb * fmaf(wb, o[j][2], gx[j][2]),
               dtb * fmaf(wb, o[j][3], gx[j][3]));
      }
      // @probe f32 phase:pass_a
    } else {
      // Pass B on the row tile 3 - w: M^T = (C B^T) o D as three A
      // terms, GB = M^T dY
      const int rm = 16 * (3 - w);
      const int ma = rm + g, mb = ma + 8;
      const float sma = segw[ma], smb = segw[mb];
      const float lma = seglw[ma], lmb = seglw[mb];
      const float dma = dts[ma], dmb = dts[mb];
      const float wma = exp2_d(hl, ll, sma, lma);
      const float wmb = exp2_d(hl, ll, smb, lmb);
      float gb[kPT][4] = {};
#pragma unroll 1
      for (int jj = 3 - w; jj < 4; ++jj) {
        float mt[2][4] = {};
#pragma unroll 2
        for (int kk = 0; kk < kNK; ++kk) {
          uint32_t a[kT3][4], r[1][kT3][4];
          ldsm_k(a, sb + mma::swz<kWN>(rm + (lane & 15),
                                       2 * kk + (lane >> 4)), Tl::kBC);
          ldsm_k(r[0], sc + mma::swz<kWN>(16 * jj + (lane & 7) +
                                              8 * (lane >> 4),
                                          2 * kk + ((lane >> 3) & 1)),
                 Tl::kBC);
          mma_terms_xn(mt, a, r);
        }
        uint32_t a[kT3][4];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int u = 16 * jj + 8 * j + 2 * q + (e & 1);
            const int tr = e >> 1 ? mb : ma;
            mt[j][e] *= u >= tr
                ? exp2_d(segw[u], seglw[u], e >> 1 ? smb : sma,
                         e >> 1 ? lmb : lma)
                : 0.f;
          }
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            uint32_t t[kT3];
            mma::split<kT3>(mt[j][2 * hr], mt[j][2 * hr + 1], t);
#pragma unroll
            for (int k = 0; k < kT3; ++k) a[k][2 * j + hr] = t[k];
          }
        }
        // @probe f32 one_term (M^T's lower terms zeroed here)
        uint32_t r[kPT / 2][kT3][4];
#pragma unroll
        for (int jp = 0; jp < kPT / 2; ++jp)
          ldsm_k_t(r[jp], sdy + mma::swz<kWP>(16 * jj + (lane & 15),
                                              2 * jp + (lane >> 4)),
                   Tl::kX);
        mma_terms_xn(gb, a, r);
      }

      // G B = GB + w_t B Gc^T -> dx = dt G B, q_t = x_t . G_t B_t,
      // beta_t = x_t . (B Gc^T)_t
      {
        float o[kPT][4] = {};
#pragma unroll
        for (int kn = 0; kn < kNK; ++kn) {
          uint32_t a[kT3][4], r[kPT / 2][kT3][4];
          ldsm_k(a, sb + mma::swz<kWN>(rm + (lane & 15),
                                       2 * kn + (lane >> 4)), Tl::kBC);
#pragma unroll
          for (int jp = 0; jp < kPT / 2; ++jp)
            ldsm_k(r[jp], sg + mma::swz<kWN>(16 * jp + (lane & 7) +
                                                 8 * (lane >> 4),
                                             2 * kn + ((lane >> 3) & 1)),
                   Tl::kS);
          mma_terms_xn(o, a, r);
        }
        float qa = 0.f, qb = 0.f, be_a = 0.f, be_b = 0.f;
#pragma unroll
        for (int j = 0; j < kPT; ++j) {
          const int col = 8 * j + 2 * q;
          const float2 xv = pair3<kWP>(smem + Tl::oX, Tl::kX, ma, col);
          const float2 xw = pair3<kWP>(smem + Tl::oX, Tl::kX, mb, col);
          be_a = fmaf(xv.x, o[j][0], fmaf(xv.y, o[j][1], be_a));
          be_b = fmaf(xw.x, o[j][2], fmaf(xw.y, o[j][3], be_b));
          const float g0 = fmaf(wma, o[j][0], gb[j][0]);
          const float g1 = fmaf(wma, o[j][1], gb[j][1]);
          const float g2 = fmaf(wmb, o[j][2], gb[j][2]);
          const float g3 = fmaf(wmb, o[j][3], gb[j][3]);
          qa = fmaf(xv.x, g0, fmaf(xv.y, g1, qa));
          qb = fmaf(xw.x, g2, fmaf(xw.y, g3, qb));
          if (ma < Lc)
            *reinterpret_cast<float2*>(dxg + (c0 + ma) * p.st[5][2] + col) =
                make_float2(dma * g0, dma * g1);
          if (mb < Lc)
            *reinterpret_cast<float2*>(dxg + (c0 + mb) * p.st[5][2] + col) =
                make_float2(dmb * g2, dmb * g3);
        }
        qa = quad_sum(qa);
        qb = quad_sum(qb);
        be_a = quad_sum(be_a);
        be_b = quad_sum(be_b);
        if (q == 0) {
          qv[ma] = qa;
          qv[mb] = qb;
          bv[ma] = be_a;
          bv[mb] = be_b;
        }
      }
      // @probe f32 phase:pass_b

      // dC's first term on rows tau = 16w..: e_tau (dY h_s)_tau;
      // gamma_tau = C_tau . (dY h_s)_tau
#pragma unroll
      for (int kp = 0; kp < kPK; ++kp) {
        uint32_t a[kT3][4], r[kNT / 2][kT2][4];
        ldsm_k(a, sdy + mma::swz<kWP>(r0 + (lane & 15),
                                      2 * kp + (lane >> 4)), Tl::kX);
#pragma unroll
        for (int jp = 0; jp < kNT / 2; ++jp)
          ldsm_k_t(r[jp], sh + mma::swz<kWN>(16 * kp + (lane & 15),
                                             2 * jp + (lane >> 4)),
                   Tl::kS);
        mma_terms_xn(dc, a, r);
      }
      float ga = 0.f, gbb = 0.f;
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const float2 cv = pair3<kWN>(smem + Tl::oC, Tl::kBC, ta,
                                     8 * j + 2 * q);
        const float2 cw = pair3<kWN>(smem + Tl::oC, Tl::kBC, tb,
                                     8 * j + 2 * q);
        ga = fmaf(cv.x, dc[j][0], fmaf(cv.y, dc[j][1], ga));
        gbb = fmaf(cw.x, dc[j][2], fmaf(cw.y, dc[j][3], gbb));
      }
      ga = quad_sum(ga);
      gbb = quad_sum(gbb);
      if (q == 0) {
        gv[ta] = ga;
        gv[tb] = gbb;
      }
      const float ea = exp2_2(seg_a, sl_a), eb = exp2_2(seg_b, sl_b);
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        dc[j][0] *= ea;
        dc[j][1] *= ea;
        dc[j][2] *= eb;
        dc[j][3] *= eb;
      }
      // @probe f32 phase:dc_inter
    }
    __syncthreads();           // Q^T o dt, rect, colw, q, beta, gamma;
                               // every read of dY done
    // @probe f32 phase:barrier2

    if (pass_b) {
      // dC += (Q^T o dt)^T B over the column tiles kk <= w (l <= tau)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (kk > w) break;
        uint32_t a[kT3][4], r[kNT / 2][kT3][4];
        ldsm_k_t(a, sq + mma::swz<8>(16 * kk + (lane & 7) + 8 * (lane >> 4),
                                     2 * w + ((lane >> 3) & 1)), Tl::kQ);
#pragma unroll
        for (int jp = 0; jp < kNT / 2; ++jp)
          ldsm_k_t(r[jp], sb + mma::swz<kWN>(16 * kk + (lane & 15),
                                             2 * jp + (lane >> 4)),
                   Tl::kBC);
        mma_terms_xn(dc, a, r);
      }
      float* dca = dcg + (c0 + ta) * p.st[8][2] + 2 * q;
      float* dcb = dcg + (c0 + tb) * p.st[8][2] + 2 * q;
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        if (ta < Lc)
          put2(dca + 8 * j, dc[j][0], dc[j][1]);
        if (tb < Lc)
          put2(dcb + 8 * j, dc[j][2], dc[j][3]);
      }
    } else {
      // e o dY over dY, rows 16w.., from its terms in shared memory
      // (their sum is dY exactly)
#pragma unroll
      for (int i = 0; i < 16 * P / 64; ++i) {
        const int e = lane + 32 * i, row = r0 + e / (P / 2);
        const int col = 2 * (e % (P / 2));
        const float ev = exp2_2(segw[row], seglw[row]);
        const float2 v = pair3<kWP>(smem + Tl::oDy, Tl::kX, row, col);
        uint32_t t[kT3];
        mma::split<kT3>(v.x * ev, v.y * ev, t);
        const int off = mma::swz_el<kWP>(row, col);
#pragma unroll
        for (int k = 0; k < kT3; ++k)
          *reinterpret_cast<uint32_t*>(smem + Tl::oDy + k * Tl::kX + off) =
              t[k];
      }
    }

    // lambda, ddt and dA by warp 0
    if (warp == 0) {
      const float d0 = dts[lane], d1 = dts[lane + 32];
      const float sa = segw[lane], sb_ = segw[lane + 32];
      const float la_ = seglw[lane], lb_ = seglw[lane + 32];
      float p0 = exp2_d(hl, ll, sa, la_) * d0 * bv[lane];
      float p1 = exp2_d(hl, ll, sb_, lb_) * d1 * bv[lane + 32];
      scan64(p0, p1, lane, false);
      {                        // exclusive: rows l < t
        const float u0 = __shfl_up_sync(0xffffffffu, p0, 1);
        const float u1 = __shfl_up_sync(0xffffffffu, p1, 1);
        const float top = __shfl_sync(0xffffffffu, p0, 31);
        p0 = lane ? u0 : 0.f;
        p1 = lane ? u1 : top;
      }
      float s0_ = exp2_2(sa, la_) * gv[lane];
      float s1_ = exp2_2(sb_, lb_) * gv[lane + 32];
      scan64(s0_, s1_, lane, true);
      float t0 = rect[lane], t1 = rect[lane + 32];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        float c0_ = colw[k * kL + lane], c1_ = colw[k * kL + lane + 32];
        scan64(c0_, c1_, lane, true);
        if (lane >= 16 * (k + 1)) t0 += c0_;
        if (lane + 32 >= 16 * (k + 1)) t1 += c1_;
      }
      float gsum = 0.f;
#pragma unroll
      for (int k = 0; k < kWarpsF; ++k) gsum += red[k];
      const float gh = exp2_2(hl, ll) * gsum;
      const float l0 = ((gh + p0) + s0_) + t0;
      const float l1 = ((gh + p1) + s1_) + t1;
      if (lane < Lc)
        st1(ddg + (c0 + lane) * p.st[6][2], fmaf(A, l0, qv[lane]));
      if (lane + 32 < Lc)
        st1(ddg + (c0 + lane + 32) * p.st[6][2],
            fmaf(A, l1, qv[lane + 32]));
      float da = fmaf(d0, l0, d1 * l1);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        da += __shfl_xor_sync(0xffffffffu, da, o);
      dA_acc += da;
    }
    // @probe f32 phase:dc_lambda
    __syncthreads();           // e o dy
    // @probe f32 phase:barrier3

    // Gc <- e_last Gc + (e o dY)^T C, the warp's tiles
    {
      const float decay = exp2_2(hl, ll);
      float gc[kOwn][4];
      get_gc(gc);
#pragma unroll
      for (int i = 0; i < kOwn; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) gc[i][e] *= decay;
      // @probe f32 state-update (the next line)
      state_product(gc, sdy, sc, nullptr);
      put_gc(gc);
      split_state(gc, Tl::oG, true);   // every read of the old terms done
    }
    // @probe f32 phase:gc
  }
  if (p.dh0) {
    float gc[kOwn][4];
    get_gc(gc);
    store_state(gc, p.dh0 + so);
  }
  if (tid == 0) p.dA[b * p.H + h] = dA_acc;
  // @probe f32 epilogue
}

template <typename TD, int P, int N>
int launch(const Params& p, int64_t B, int64_t blocks, cudaStream_t stream) {
  const int smem = Tile<P, N>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_bwd_mma<TD, P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)blocks, (unsigned)B);
  ssd_bwd_mma<TD, P, N><<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename TD>
int dispatch_pn(int P, int N, const Params& p, int64_t B, int64_t blocks,
                cudaStream_t s) {
  if (P == 64 && N == 64) return launch<TD, 64, 64>(p, B, blocks, s);
  if (P == 64 && N == 16) return launch<TD, 64, 16>(p, B, blocks, s);
  if (P == 32 && N == 64) return launch<TD, 32, 64>(p, B, blocks, s);
  if (P == 32 && N == 16) return launch<TD, 32, 16>(p, B, blocks, s);
  return (int)cudaErrorInvalidValue;
}

template <typename TD, int P, int N>
int launch_f32(const ParamsT<float>& p, int64_t B, int64_t blocks,
               cudaStream_t stream) {
  const int smem = TileF32<P, N>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_bwd_mma_f32<TD, P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)blocks, (unsigned)B);
  ssd_bwd_mma_f32<TD, P, N><<<grid, kThreadsF, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename TD>
int dispatch_pn_f32(int P, int N, const ParamsT<float>& p, int64_t B,
                    int64_t blocks, cudaStream_t s) {
  if (P == 64 && N == 64) return launch_f32<TD, 64, 64>(p, B, blocks, s);
  if (P == 64 && N == 16) return launch_f32<TD, 64, 16>(p, B, blocks, s);
  if (P == 32 && N == 64) return launch_f32<TD, 32, 64>(p, B, blocks, s);
  if (P == 32 && N == 16) return launch_f32<TD, 32, 16>(p, B, blocks, s);
  return (int)cudaErrorInvalidValue;
}

// The arguments of either entry point into ParamsT<T>; false where they
// are out of range
template <typename T>
bool fill(ParamsT<T>& p, const void* x, const void* dt, const float* A,
          const void* bm, const void* cm, const float* h0, const float* dy,
          const float* dhf, void* dx, void* ddt, float* dA, float* dB,
          float* dC, float* dh0, float* ws, const int64_t* strides,
          int64_t B, int64_t H, int64_t G, int64_t S, int64_t hpb) {
  if (B <= 0 || H <= 0 || G <= 0 || S <= 0 || H % G || B > 65535 ||
      H > 0x3fffffffLL || hpb <= 0 || (H / G) % hpb ||
      (S + kL - 1) / kL > 0x7fffffffLL)
    return false;
  p.x = static_cast<const T*>(x);
  p.dt = dt;
  p.A = A;
  p.bm = static_cast<const T*>(bm);
  p.cm = static_cast<const T*>(cm);
  p.h0 = h0;
  p.dy = dy;
  p.dhf = dhf;
  p.dx = static_cast<T*>(dx);
  p.ddt = ddt;
  p.dA = dA;
  p.dB = dB;
  p.dC = dC;
  p.dh0 = dh0;
  p.ws = ws;
  for (int i = 0; i < 9; ++i)
    for (int j = 0; j < 3; ++j) p.st[i][j] = strides[i * 3 + j];
  p.S = S;
  p.H = (int)H;
  p.rep = (int)(H / G);
  p.hpb = (int)hpb;
  p.n_chunks = (int)((S + kL - 1) / kL);
  p.n_ws = p.n_chunks > 2 ? p.n_chunks - 2 : 0;
  return true;
}

}  // namespace

// dt_dtype (dt and ddt): 0 = float32, 1 = bfloat16; x, B, C and dx bf16;
// A, h0, dy, dhf and every other output fp32.  strides: 27 element
// strides, (batch, head or group or partial, seq) of x, dt, B, C, dy, dx,
// ddt, dB and dC in that order; dB and dC are (B, H / hpb, S, N) partials,
// hpb a divisor of H / G.  h0, dhf and dh0 may be null; ws holds (B, H,
// max(ceil(S / 64) - 2, 0), P, N) floats (null when that is 0).  Returns
// cudaGetLastError() after the launch (0 = cudaSuccess).  The caller
// handles S == 0 without a launch.
extern "C" int ssm_scan_bwd_mma(int dt_dtype, int P, int N, const void* x,
                                const void* dt, const float* A,
                                const void* bm, const void* cm,
                                const float* h0, const float* dy,
                                const float* dhf, void* dx, void* ddt,
                                float* dA, float* dB, float* dC, float* dh0,
                                float* ws, const int64_t* strides, int64_t B,
                                int64_t H, int64_t G, int64_t S, int64_t hpb,
                                void* stream) {
  Params p;
  if (!fill(p, x, dt, A, bm, cm, h0, dy, dhf, dx, ddt, dA, dB, dC, dh0, ws,
            strides, B, H, G, S, hpb))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int64_t blocks = H / hpb;
  if (dt_dtype == 0) return dispatch_pn<float>(P, N, p, B, blocks, s);
  if (dt_dtype == 1)
    return dispatch_pn<__nv_bfloat16>(P, N, p, B, blocks, s);
  return (int)cudaErrorInvalidValue;
}

// The same on fp32 x, B, C and dx (ssd_bwd_mma_f32), one head a block, so
// dB and dC are (B, H, S, N) partials: the rows of x, B, C and dy read as
// float4 (strides multiples of 4 elements, 16-byte-aligned bases)
extern "C" int ssm_scan_bwd_mma_f32(int dt_dtype, int P, int N,
                                    const void* x, const void* dt,
                                    const float* A, const void* bm,
                                    const void* cm, const float* h0,
                                    const float* dy, const float* dhf,
                                    void* dx, void* ddt, float* dA,
                                    float* dB, float* dC, float* dh0,
                                    float* ws, const int64_t* strides,
                                    int64_t B, int64_t H, int64_t G,
                                    int64_t S, void* stream) {
  ParamsT<float> p;
  if (!fill(p, x, dt, A, bm, cm, h0, dy, dhf, dx, ddt, dA, dB, dC, dh0, ws,
            strides, B, H, G, S, 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dt_dtype == 0) return dispatch_pn_f32<float>(P, N, p, B, H, s);
  if (dt_dtype == 1)
    return dispatch_pn_f32<__nv_bfloat16>(P, N, p, B, H, s);
  return (int)cudaErrorInvalidValue;
}
