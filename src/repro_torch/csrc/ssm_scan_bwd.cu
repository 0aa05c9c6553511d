/*
 * ssm_scan_bwd — the gradient of the Mamba2 SSD scan for Hopper (sm_90a),
 * SIMT fp32 arithmetic for fp32 and bf16 inputs.
 *
 *     a_t = exp(dt_t A),  h_t = a_t h_{t-1} + dt_t x_t B_t^T,  y_t = h_t C_t
 *
 *     x, dy, dx: (B, H, S, P); dt, ddt: (B, H, S); A: (H,); B, C: (B, G,
 *     S, N) with head h reading group h / (H / G); h0, dh_f, dh0: (B, H,
 *     P, N) contiguous or null (zeros; dh0 null: not written).  dB and dC
 *     are written per head, (B, H, S, N), and summed over the heads of a
 *     group by the caller; dA per (batch, head), (B, H) contiguous, summed
 *     over batch by the caller: no atomics, so the sums run in a fixed
 *     order.  Every (B, H, S, ·) tensor is a strided view whose last axis
 *     is contiguous.  P in {32, 64}, N in {16, 64}.  x, B, C (and dx)
 *     fp32 or bf16, dt (and ddt) fp32 or bf16, as the forward takes them;
 *     A, h0, dy, dh_f, dA, dB, dC (per head) and dh0 fp32.
 *
 * The JAX package has no backward kernel: its model trains through plain
 * JAX and autodiff.  The port's model runs the hand-written forward
 * (csrc/ssm_scan.cu, ssd_fwd_simt, the replacement of the TPU kernel
 * repro/kernels/ssm_scan/kernel.py:66 ssm_scan_pallas), so its gradient
 * comes from this kernel: what autodiff of ssm_scan_ref computes for the
 * same inputs.  Under bf16 (the training path of a bf16 model, whose
 * forward is ssd_fwd_mma) every bf16 input is widened to fp32 as it
 * loads and the walks are the fp32 walks, instruction for instruction:
 * the chunk-start states are rebuilt in fp32 from the bf16 values.  dx
 * (and a bf16 dt's ddt) are rounded once, as they are stored; the
 * per-head dB and dC stay fp32 for the caller's sum over the group's
 * heads, rounded after it.
 *
 * The adjoints, with G_t = dL/dh_t = a_{t+1} G_{t+1} + dy_t C_t^T (G_S =
 * dh_f):  dx_t = dt_t G_t B_t,  dB_t = dt_t G_t^T x_t,  dC_t = h_t^T dy_t,
 * dh0 = a_1 G_1,  ddt_t = x_t^T G_t B_t + A lambda_t,  dA = sum_t dt_t
 * lambda_t, where lambda_t = dL/d log a_t = <G_t, a_t h_{t-1}>.  No walk
 * runs the recurrence backwards (which divides by a_t).
 * ssm_scan_bwd_ref (kernels/ssm_scan/ref.py) is the plain mirror of what
 * follows.
 *
 * ssd_bwd_simt<P, N>: one block of 256 threads owns one (batch, head),
 * as ssd_fwd_simt does, and walks S twice in chunks of 64 rows:
 *   - forward walk: the state update of ssd_fwd_simt alone (no y); each
 *     chunk's start state h_s goes to a workspace (B, H, n_chunks, P, N);
 *   - reverse walk, Gc (the gradient of the chunk's end state from later
 *     chunks, dh_f first) in shared memory.  With seg the within-chunk
 *     cumsum of dt A, e = exp(seg), w_t = exp(seg_last - seg_t) and
 *     Dm[tau][t] = exp(seg_tau - seg_t) for t <= tau (else 0, no exp
 *     taken above the diagonal, where it could overflow):
 *         M = (C B^T) o Dm,  Q = (dY X^T) o Dm,
 *         GB_t = (M^T dY)_t + w_t (B Gc^T)_t    (G_t B_t)  -> dx, q_t = x_t . GB_t
 *         GX_t = (Q^T C)_t + w_t (X Gc)_t       (G_t^T x_t) -> dB
 *         dC_tau = e_tau (dY h_s)_tau + sum_l Q[tau][l] dt_l B_l,
 *     then Gc <- e_last Gc + sum_tau e_tau dy_tau C_tau^T, which after
 *     chunk 0 is dh0.  lambda from the chunk's own terms (G_t and h_t
 *     expanded over the chunk; w_t Dm[t][l] = w_l, e_t Dm[tau][t] = e_tau):
 *         lambda_t = e_last <Gc, h_s> + sum_{l <= t} w_l dt_l beta_l
 *                    + sum_{tau >= t} e_tau gamma_tau
 *                    + sum_{tau >= t} sum_{l <= t} Z[tau][l] - dt_t q_t,
 *         beta_l = x_l^T Gc B_l,  gamma_tau = dy_tau^T h_s C_tau,
 *         Z[tau][l] = Dm[tau][l] dt_l (dy_tau . x_l)(C_tau . B_l):
 *     a prefix and a suffix scan by one warp, Z's rectangle sums as row
 *     prefixes then column suffixes, one thread a row or column.  Every
 *     sum stays inside one chunk: the shorter identity lambda_t = sum over
 *     tau >= t of (C_tau . dC_tau - dt_tau q_tau) plus <dh_f, h_f> sums
 *     over all of S and cancels (in fp32 at S 4096, dA 1.2e-3 of max |dA|
 *     from float64, measured with the mirror on the CPU).
 *   Each product is register-tiled on a 16 x 16 thread grid as in the
 *   forward (4 rows x P/16 or N/16 columns a thread), fp32 FMAs in a
 *   fixed order; the row sums q, beta and gamma are shuffle trees over 16
 *   threads of a row.  Shared memory: x, dY, B, C, Gc, the chunk's start
 *   state, M, Q and Z, rows padded by one float, 152,096 bytes at P = N =
 *   64 (one block an SM).
 *
 * What bounds it.  The reverse walk's products at chunk 64 are 2 L^2 (N +
 * P) + 4 L P N multiply-adds a chunk, the forward walk's L P N: at the
 * 100m training shape (B 32, H 24, S 128, P = N = 64) 9.06e9 flops, 135
 * us at fp32's 67 TFLOP/s, against 101 MB read and written (30 us at
 * 3.35 TB/s; computed): the SIMT FMAs bound it.  In bf16 the same
 * products could run on the tensor cores (989 TFLOP/s), which this kernel
 * does not use: a tensor-core backward (the bf16 forward's mma.sync) is
 * a kernel redesign item of ROADMAP Queue B.
 *
 * Shared with the forward: rows past S are never loaded (zeros in shared
 * memory, dt past S 0, so seg_last is the last valid row's) and never
 * written; every sum runs in an order fixed by the shapes, so two
 * launches give bit-identical gradients.
 */
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kL = 64;           // chunk length, as ssd_fwd_simt's
constexpr int kMS = kL + 1;      // row stride of the M, Q and Z tiles

struct BwdParams {
  const void* x;                 // T: fp32 or bf16, as B and C
  const void* dt;                // TD: fp32 or bf16
  const float* A;
  const void* bm;
  const void* cm;
  const float* h0;               // (B, H, P, N) contiguous, or null
  const float* dy;
  const float* dhf;              // (B, H, P, N) contiguous, or null
  void* dx;                      // T, as x
  void* ddt;                     // TD, as dt
  float* dA;                     // (B, H) contiguous: per (batch, head)
  float* dB;                     // per head, strided
  float* dC;
  float* dh0;                    // (B, H, P, N) contiguous, or null
  float* ws;                     // (B, H, n_chunks, P, N) contiguous
  int64_t st[9][3];              // x, dt, B, C, dy, dx, ddt, dB, dC:
                                 // (batch, head or group, seq) in elements
  int64_t S;
  int H;
  int rep;                       // heads per group, H / G
  int n_chunks;
};

template <int P, int N>
constexpr int bwd_smem_floats() {
  return 2 * kL * (P + 1) + 2 * kL * (N + 1) + 2 * P * (N + 1)
         + 3 * kL * kMS + 9 * kL + 8;
}

// an input element widened to fp32 (bf16 -> fp32 is exact), and a
// gradient's one rounding from fp32 to its input's type
__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// the sum of v over the 16 threads of one row of the 16 x 16 grid (lanes
// l and l ^ 16 hold other rows), in a fixed order
__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// seg (inclusive cumsum of dt A over the chunk, by a scan over 2 x 32
// lanes), exp(seg) and exp(seg_last - seg), by warp 0, as ssd_fwd_simt
__device__ __forceinline__ void chunk_decays(int lane, float A, int Lc,
                                             const float* dts, float* seg,
                                             float* eseg, float* wl) {
  float a0 = dts[lane] * A, a1 = dts[lane + 32] * A;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float u0 = __shfl_up_sync(0xffffffffu, a0, o);
    const float u1 = __shfl_up_sync(0xffffffffu, a1, o);
    if (lane >= o) {
      a0 += u0;
      a1 += u1;
    }
  }
  a1 += __shfl_sync(0xffffffffu, a0, 31);
  seg[lane] = a0;
  seg[lane + 32] = a1;
  __syncwarp();
  const float last = seg[Lc - 1];
  eseg[lane] = expf(a0);
  eseg[lane + 32] = expf(a1);
  wl[lane] = expf(last - a0);
  wl[lane + 32] = expf(last - a1);
}

// one block an SM (its shared memory), so every register is its to use
template <typename T, typename TD, int P, int N>
__global__ void __launch_bounds__(kThreads, 1)
ssd_bwd_simt(const BwdParams p) {
  static_assert(P % 16 == 0 && N % 16 == 0 && kL == 64, "tiling");
  constexpr int kXS = P + 1;     // row strides, one float of padding
  constexpr int kNS = N + 1;
  constexpr int kPC = P / 16;    // columns or rows of P a thread owns
  constexpr int kNC = N / 16;
  extern __shared__ float smem[];
  float* xs = smem;              // [kL][kXS]  x (x * dt in the forward walk)
  float* dys = xs + kL * kXS;    // [kL][kXS]  dy
  float* bs = dys + kL * kXS;    // [kL][kNS]  B
  float* cs = bs + kL * kNS;     // [kL][kNS]  C
  float* gs = cs + kL * kNS;     // [P][kNS]   Gc
  float* hs = gs + P * kNS;      // [P][kNS]   the state (chunk start)
  float* ms = hs + P * kNS;      // [kL][kMS]  M = (C B^T) o Dm
  float* qs = ms + kL * kMS;     // [kL][kMS]  Q = (dY X^T) o Dm
  float* zs = qs + kL * kMS;     // [kL][kMS]  Z, then its row prefix sums
  float* dts = zs + kL * kMS;    // [kL] dt
  float* seg = dts + kL;         // [kL] inclusive cumsum of dt * A
  float* eseg = seg + kL;        // [kL] exp(seg)
  float* wl = eseg + kL;         // [kL] exp(seg_last - seg)
  float* qv = wl + kL;           // [kL] x_t . G_t B_t
  float* bv = qv + kL;           // [kL] beta_t = x_t . Gc B_t
  float* gv = bv + kL;           // [kL] gamma_t = dy_t . h_s C_t
  float* t4 = gv + kL;           // [kL] sum_{tau >= t} sum_{l <= t} Z
  float* red = t4 + kL;          // [8]  <Gc, h_s>, one partial a warp

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int h = blockIdx.x;
  const int64_t b = blockIdx.y;
  const int64_t g = h / p.rep;
  const float A = p.A[h];
  const T* xg = static_cast<const T*>(p.x) + b * p.st[0][0] +
                h * p.st[0][1];
  const TD* dg = static_cast<const TD*>(p.dt) + b * p.st[1][0] +
                 h * p.st[1][1];
  const T* bg = static_cast<const T*>(p.bm) + b * p.st[2][0] +
                g * p.st[2][1];
  const T* cg = static_cast<const T*>(p.cm) + b * p.st[3][0] +
                g * p.st[3][1];
  const float* yg = p.dy + b * p.st[4][0] + h * p.st[4][1];
  T* dxg = static_cast<T*>(p.dx) + b * p.st[5][0] + h * p.st[5][1];
  TD* ddg = static_cast<TD*>(p.ddt) + b * p.st[6][0] + h * p.st[6][1];
  float* dbg = p.dB + b * p.st[7][0] + h * p.st[7][1];
  float* dcg = p.dC + b * p.st[8][0] + h * p.st[8][1];
  const int64_t so = (b * p.H + h) * (int64_t)(P * N);
  float* wsg = p.ws + (b * p.H + h) * (int64_t)p.n_chunks * (P * N);

  // ---- forward walk: each chunk's start state to the workspace -------
  // (Gc starts at dh_f)
  for (int e = tid; e < P * N; e += kThreads) {
    hs[(e / N) * kNS + e % N] = p.h0 ? p.h0[so + e] : 0.f;
    gs[(e / N) * kNS + e % N] = p.dhf ? p.dhf[so + e] : 0.f;
  }
  for (int c = 0; c < p.n_chunks; ++c) {
    const int64_t c0 = (int64_t)c * kL;
    const int Lc = (int)(p.S - c0 < kL ? p.S - c0 : kL);
    __syncthreads();             // the last chunk's readers are done
    if (tid < kL)
      dts[tid] = tid < Lc ? widen(dg[(c0 + tid) * p.st[1][2]]) : 0.f;
    for (int e = tid; e < kL * N; e += kThreads) {
      const int l = e / N, n = e % N;
      bs[l * kNS + n] = l < Lc ? widen(bg[(c0 + l) * p.st[2][2] + n]) : 0.f;
    }
    __syncthreads();             // dts
    for (int e = tid; e < kL * P; e += kThreads) {
      const int l = e / P, q = e % P;
      xs[l * kXS + q] =
          l < Lc ? widen(xg[(c0 + l) * p.st[0][2] + q]) * dts[l] : 0.f;
    }
    if (tid < 32) chunk_decays(lane, A, Lc, dts, seg, eseg, wl);
    __syncthreads();             // xs, eseg, wl
    // state[q][n] = exp(seg_last) state[q][n]
    //               + sum_l (xdt[l][q] exp(seg_last - seg_l)) B[l][n]
    float acc[kPC][kNC] = {};
#pragma unroll 4
    for (int l = 0; l < kL; ++l) {
      const float w = wl[l];
      float xv[kPC], bv[kNC];
#pragma unroll
      for (int a = 0; a < kPC; ++a) xv[a] = xs[l * kXS + ty + 16 * a] * w;
#pragma unroll
      for (int j = 0; j < kNC; ++j) bv[j] = bs[l * kNS + tx + 16 * j];
#pragma unroll
      for (int a = 0; a < kPC; ++a)
#pragma unroll
        for (int j = 0; j < kNC; ++j) acc[a][j] = fmaf(xv[a], bv[j], acc[a][j]);
    }
    const float decay = eseg[Lc - 1];
    float* wsc = wsg + (int64_t)c * (P * N);
#pragma unroll
    for (int a = 0; a < kPC; ++a)
#pragma unroll
      for (int j = 0; j < kNC; ++j) {
        const int q = ty + 16 * a, n = tx + 16 * j;
        float* s = hs + q * kNS + n;
        wsc[q * N + n] = *s;
        *s = decay * *s + acc[a][j];
      }
  }
  float dA_acc = 0.f;            // sum_t dt_t lambda_t (warp 0)

  // ---- reverse walk --------------------------------------------------
  for (int c = p.n_chunks - 1; c >= 0; --c) {
    const int64_t c0 = (int64_t)c * kL;
    const int Lc = (int)(p.S - c0 < kL ? p.S - c0 : kL);
    __syncthreads();             // the last chunk's readers are done
    if (tid < kL)
      dts[tid] = tid < Lc ? widen(dg[(c0 + tid) * p.st[1][2]]) : 0.f;
    for (int e = tid; e < kL * N; e += kThreads) {
      const int l = e / N, n = e % N;
      const bool ok = l < Lc;
      bs[l * kNS + n] = ok ? widen(bg[(c0 + l) * p.st[2][2] + n]) : 0.f;
      cs[l * kNS + n] = ok ? widen(cg[(c0 + l) * p.st[3][2] + n]) : 0.f;
    }
    for (int e = tid; e < kL * P; e += kThreads) {
      const int l = e / P, q = e % P;
      const bool ok = l < Lc;
      xs[l * kXS + q] = ok ? widen(xg[(c0 + l) * p.st[0][2] + q]) : 0.f;
      dys[l * kXS + q] = ok ? yg[(c0 + l) * p.st[4][2] + q] : 0.f;
    }
    {
      const float* wsc = wsg + (int64_t)c * (P * N);
      for (int e = tid; e < P * N; e += kThreads)
        hs[(e / N) * kNS + e % N] = wsc[e];
    }
    __syncthreads();             // dts
    if (tid < 32) chunk_decays(lane, A, Lc, dts, seg, eseg, wl);
    __syncthreads();             // seg, eseg, wl

    // M[i][l] = (C_i . B_l) Dm[i][l], Q[i][l] = (dy_i . x_l) Dm[i][l],
    // Z[i][l] = M[i][l] (dy_i . x_l) dt_l; thread (ty, tx) owns rows
    // ty + 16a, columns tx + 16j
    {
      float am[4][4] = {}, aq[4][4] = {};
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        float cv[4], bv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) cv[a] = cs[(ty + 16 * a) * kNS + n];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = bs[(tx + 16 * j) * kNS + n];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int j = 0; j < 4; ++j) am[a][j] = fmaf(cv[a], bv[j], am[a][j]);
      }
#pragma unroll 4
      for (int q = 0; q < P; ++q) {
        float dv[4], xv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) dv[a] = dys[(ty + 16 * a) * kXS + q];
#pragma unroll
        for (int j = 0; j < 4; ++j) xv[j] = xs[(tx + 16 * j) * kXS + q];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int j = 0; j < 4; ++j) aq[a][j] = fmaf(dv[a], xv[j], aq[a][j]);
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = ty + 16 * a;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int l = tx + 16 * j;
          const float d = l <= i ? expf(seg[i] - seg[l]) : 0.f;
          const float m = am[a][j] * d;
          ms[i * kMS + l] = m;
          qs[i * kMS + l] = aq[a][j] * d;
          zs[i * kMS + l] = m * aq[a][j] * dts[l];
        }
      }
    }
    __syncthreads();             // ms, qs, zs
    if (tid < kL) {              // Z's row prefix sums, a thread a row
      float run = 0.f;
      for (int l = 0; l < kL; ++l) {
        run += zs[tid * kMS + l];
        zs[tid * kMS + l] = run;
      }
    }

    // GB[t][q] = sum_tau M[tau][t] dy[tau][q] + w_t sum_n B[t][n] Gc[q][n];
    // dx = dt GB, q_t = x_t . GB_t, beta_t = x_t . (Gc B_t).  Rows t =
    // ty + 16a, columns tx + 16j
    {
      float acc[4][kPC] = {}, acc2[4][kPC] = {};
#pragma unroll 4
      for (int tau = 0; tau < kL; ++tau) {
        float mv[4], dv[kPC];
#pragma unroll
        for (int a = 0; a < 4; ++a) mv[a] = ms[tau * kMS + ty + 16 * a];
#pragma unroll
        for (int j = 0; j < kPC; ++j) dv[j] = dys[tau * kXS + tx + 16 * j];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int j = 0; j < kPC; ++j) acc[a][j] = fmaf(mv[a], dv[j], acc[a][j]);
      }
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        float bv[4], gv[kPC];
#pragma unroll
        for (int a = 0; a < 4; ++a) bv[a] = bs[(ty + 16 * a) * kNS + n];
#pragma unroll
        for (int j = 0; j < kPC; ++j) gv[j] = gs[(tx + 16 * j) * kNS + n];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int j = 0; j < kPC; ++j)
            acc2[a][j] = fmaf(bv[a], gv[j], acc2[a][j]);
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int t = ty + 16 * a;
        float part = 0.f, partb = 0.f;
#pragma unroll
        for (int j = 0; j < kPC; ++j) {
          const float xv = xs[t * kXS + tx + 16 * j];
          const float gb = fmaf(wl[t], acc2[a][j], acc[a][j]);
          part = fmaf(xv, gb, part);
          partb = fmaf(xv, acc2[a][j], partb);
          if (t < Lc) store1(dxg + (c0 + t) * p.st[5][2] + tx + 16 * j,
                             dts[t] * gb);
        }
        part = row_sum16(part);
        partb = row_sum16(partb);
        if (tx == 0) {
          qv[t] = part;
          bv[t] = partb;
        }
      }
    }

    // GX[t][n] = sum_tau Q[tau][t] C[tau][n] + w_t sum_q x[t][q] Gc[q][n];
    // dB = dt GX.  Rows t = ty + 16a, columns tx + 16j
    {
      float acc[4][kNC] = {}, acc2[4][kNC] = {};
#pragma unroll 4
      for (int tau = 0; tau < kL; ++tau) {
        float qv4[4], cv[kNC];
#pragma unroll
        for (int a = 0; a < 4; ++a) qv4[a] = qs[tau * kMS + ty + 16 * a];
#pragma unroll
        for (int j = 0; j < kNC; ++j) cv[j] = cs[tau * kNS + tx + 16 * j];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int j = 0; j < kNC; ++j) acc[a][j] = fmaf(qv4[a], cv[j], acc[a][j]);
      }
#pragma unroll 4
      for (int q = 0; q < P; ++q) {
        float xv[4], gv[kNC];
#pragma unroll
        for (int a = 0; a < 4; ++a) xv[a] = xs[(ty + 16 * a) * kXS + q];
#pragma unroll
        for (int j = 0; j < kNC; ++j) gv[j] = gs[q * kNS + tx + 16 * j];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int j = 0; j < kNC; ++j)
            acc2[a][j] = fmaf(xv[a], gv[j], acc2[a][j]);
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int t = ty + 16 * a;
        if (t < Lc) {
          float* row = dbg + (c0 + t) * p.st[7][2];
#pragma unroll
          for (int j = 0; j < kNC; ++j)
            row[tx + 16 * j] = dts[t] * fmaf(wl[t], acc2[a][j], acc[a][j]);
        }
      }
    }

    // dC[tau][n] = e_tau sum_q dy[tau][q] h[q][n] + sum_l Q[tau][l] dt_l
    // B[l][n]; gamma_tau = C_tau . (dy_tau^T h).  Rows tau = ty + 16a,
    // columns tx + 16j
    {
      float acc[4][kNC] = {}, acc2[4][kNC] = {};
#pragma unroll 4
      for (int q = 0; q < P; ++q) {
        float dv[4], hv[kNC];
#pragma unroll
        for (int a = 0; a < 4; ++a) dv[a] = dys[(ty + 16 * a) * kXS + q];
#pragma unroll
        for (int j = 0; j < kNC; ++j) hv[j] = hs[q * kNS + tx + 16 * j];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int j = 0; j < kNC; ++j) acc[a][j] = fmaf(dv[a], hv[j], acc[a][j]);
      }
#pragma unroll 4
      for (int l = 0; l < kL; ++l) {
        const float d = dts[l];
        float qv4[4], bv[kNC];
#pragma unroll
        for (int a = 0; a < 4; ++a) qv4[a] = qs[(ty + 16 * a) * kMS + l];
#pragma unroll
        for (int j = 0; j < kNC; ++j) bv[j] = bs[l * kNS + tx + 16 * j] * d;
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int j = 0; j < kNC; ++j)
            acc2[a][j] = fmaf(qv4[a], bv[j], acc2[a][j]);
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int t = ty + 16 * a;
        float part = 0.f;
#pragma unroll
        for (int j = 0; j < kNC; ++j) {
          const float dc = fmaf(eseg[t], acc[a][j], acc2[a][j]);
          part = fmaf(cs[t * kNS + tx + 16 * j], acc[a][j], part);
          if (t < Lc) dcg[(c0 + t) * p.st[8][2] + tx + 16 * j] = dc;
        }
        part = row_sum16(part);
        if (tx == 0) gv[t] = part;
      }
    }
    {                            // <Gc, h_s>: a partial a warp
      float part = 0.f;
      for (int e = tid; e < P * N; e += kThreads)
        part = fmaf(gs[(e / N) * kNS + e % N], hs[(e / N) * kNS + e % N],
                    part);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, o);
      if (lane == 0) red[tid >> 5] = part;
    }
    __syncthreads();             // qv, bv, gv, red, zs's row prefixes;
                                 // every read of the old Gc done
    if (tid < kL) {              // Z's column suffix sums of row prefixes
      float run = 0.f;
      for (int tau = kL - 1; tau >= tid; --tau) run += zs[tau * kMS + tid];
      t4[tid] = run;
    }
    __syncthreads();             // t4

    // lambda_t = e_last <Gc, h_s> + (prefix of w dt beta)_t + (suffix of
    // e gamma)_t + t4_t - dt_t q_t, by warp 0 over 2 x 32 lanes; then
    // ddt = q + A lambda and the chunk's share of dA
    if (tid < 32) {
      const float d0 = dts[lane], d1 = dts[lane + 32];
      float p0 = wl[lane] * d0 * bv[lane];
      float p1 = wl[lane + 32] * d1 * bv[lane + 32];
      float s0 = eseg[lane] * gv[lane];
      float s1 = eseg[lane + 32] * gv[lane + 32];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float u0 = __shfl_up_sync(0xffffffffu, p0, o);
        const float u1 = __shfl_up_sync(0xffffffffu, p1, o);
        const float v0 = __shfl_down_sync(0xffffffffu, s0, o);
        const float v1 = __shfl_down_sync(0xffffffffu, s1, o);
        if (lane >= o) {
          p0 += u0;
          p1 += u1;
        }
        if (lane + o < 32) {
          s0 += v0;
          s1 += v1;
        }
      }
      p1 += __shfl_sync(0xffffffffu, p0, 31);
      s0 += __shfl_sync(0xffffffffu, s1, 0);
      float gh = 0.f;
#pragma unroll
      for (int w = 0; w < kThreads / 32; ++w) gh += red[w];
      gh *= eseg[Lc - 1];
      const float l0 = (((gh + p0) + s0) + t4[lane]) - d0 * qv[lane];
      const float l1 = (((gh + p1) + s1) + t4[lane + 32]) - d1 * qv[lane + 32];
      if (lane < Lc)
        store1(ddg + (c0 + lane) * p.st[6][2], fmaf(A, l0, qv[lane]));
      if (lane + 32 < Lc)
        store1(ddg + (c0 + lane + 32) * p.st[6][2],
               fmaf(A, l1, qv[lane + 32]));
      float da = fmaf(d0, l0, d1 * l1);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        da += __shfl_xor_sync(0xffffffffu, da, o);
      dA_acc += da;
    }

    // Gc[q][n] = e_last Gc[q][n] + sum_tau e_tau dy[tau][q] C[tau][n];
    // rows q = ty + 16a, columns tx + 16j
    {
      float acc[kPC][kNC] = {};
#pragma unroll 4
      for (int tau = 0; tau < kL; ++tau) {
        const float ev = eseg[tau];
        float dv[kPC], cv[kNC];
#pragma unroll
        for (int a = 0; a < kPC; ++a) dv[a] = dys[tau * kXS + ty + 16 * a] * ev;
#pragma unroll
        for (int j = 0; j < kNC; ++j) cv[j] = cs[tau * kNS + tx + 16 * j];
#pragma unroll
        for (int a = 0; a < kPC; ++a)
#pragma unroll
          for (int j = 0; j < kNC; ++j) acc[a][j] = fmaf(dv[a], cv[j], acc[a][j]);
      }
      const float decay = eseg[Lc - 1];
#pragma unroll
      for (int a = 0; a < kPC; ++a)
#pragma unroll
        for (int j = 0; j < kNC; ++j) {
          float* s = gs + (ty + 16 * a) * kNS + tx + 16 * j;
          *s = decay * *s + acc[a][j];
        }
    }
  }
  __syncthreads();
  if (p.dh0)
    for (int e = tid; e < P * N; e += kThreads)
      p.dh0[so + e] = gs[(e / N) * kNS + e % N];
  if (tid == 0) p.dA[b * p.H + h] = dA_acc;
}

template <typename T, typename TD, int P, int N>
int launch(const BwdParams& p, int64_t B, int64_t H, cudaStream_t stream) {
  const int smem = bwd_smem_floats<P, N>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_bwd_simt<T, TD, P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)H, (unsigned)B);
  ssd_bwd_simt<T, TD, P, N><<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T, typename TD>
int dispatch_pn(int P, int N, const BwdParams& p, int64_t B, int64_t H,
                cudaStream_t s) {
  if (P == 64 && N == 64) return launch<T, TD, 64, 64>(p, B, H, s);
  if (P == 64 && N == 16) return launch<T, TD, 64, 16>(p, B, H, s);
  if (P == 32 && N == 64) return launch<T, TD, 32, 64>(p, B, H, s);
  if (P == 32 && N == 16) return launch<T, TD, 32, 16>(p, B, H, s);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int dispatch_dt(int dt_dtype, int P, int N, const BwdParams& p, int64_t B,
                int64_t H, cudaStream_t s) {
  if (dt_dtype == 0) return dispatch_pn<T, float>(P, N, p, B, H, s);
  if (dt_dtype == 1) return dispatch_pn<T, __nv_bfloat16>(P, N, p, B, H, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype (x, B, C, and dx) and dt_dtype (dt and ddt): 0 = float32, 1 =
// bfloat16, as ssm_scan_fwd takes them; A, h0, dy, dhf and every other
// output are float32 (dB and dC per head, summed and rounded by the
// caller).  strides: 27 element strides, (batch, head or group, seq) of x, dt, B,
// C, dy, dx, ddt, dB and dC in that order (dB and dC per head).  h0, dhf
// and dh0 may be null; ws holds (B, H, ceil(S / 64), P, N) floats.
// Returns cudaGetLastError() after the launch (0 = cudaSuccess).  The
// caller handles S == 0 without a launch.
extern "C" int ssm_scan_bwd(int dtype, int dt_dtype, int P, int N,
                            const void* x, const void* dt, const float* A,
                            const void* bm, const void* cm, const float* h0,
                            const float* dy, const float* dhf, void* dx,
                            void* ddt, float* dA, float* dB, float* dC,
                            float* dh0,
                            float* ws, const int64_t* strides, int64_t B,
                            int64_t H, int64_t G, int64_t S, void* stream) {
  if (B <= 0 || H <= 0 || G <= 0 || S <= 0 || H % G || B > 65535 ||
      H > 0x3fffffffLL || (S + kL - 1) / kL > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  BwdParams p;
  p.x = x;
  p.dt = dt;
  p.A = A;
  p.bm = bm;
  p.cm = cm;
  p.h0 = h0;
  p.dy = dy;
  p.dhf = dhf;
  p.dx = dx;
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
  p.n_chunks = (int)((S + kL - 1) / kL);
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return dispatch_dt<float>(dt_dtype, P, N, p, B, H, s);
  if (dtype == 1)
    return dispatch_dt<__nv_bfloat16>(dt_dtype, P, N, p, B, H, s);
  return (int)cudaErrorInvalidValue;
}
