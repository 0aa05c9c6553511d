/*
 * rwkv6_scan_bwd — the gradient of the fp32 WKV6 recurrence for Hopper
 * (sm_90a), SIMT fp32.
 *
 *     y_t = r_t . (S_{t-1} + diag(u) k_t v_t^T),
 *     S_t = diag(w_t) S_{t-1} + k_t v_t^T,   w_t = exp(logw_t)
 *
 *     r, k, v, logw, dy, dr, dk, dv, dlogw: (B, H, S, D), strided views
 *     whose last axis is contiguous; u: (H, D); s0, dS_f, ds0: (B, H, D, D)
 *     contiguous or null (zeros; ds0 null: not written); du per (batch,
 *     head), (B, H, D) contiguous, summed over batch by the caller (no
 *     atomics, so the sum runs in a fixed order).  D in {32, 64}, fp32.
 *
 * The JAX package has no backward kernel: its model trains through plain
 * JAX and autodiff.  The port's model runs the hand-written forward
 * (csrc/rwkv6_scan.cu, wkv_fwd_simt, the replacement of the TPU kernel
 * repro/kernels/rwkv6_scan/kernel.py:55 rwkv6_scan_pallas), so its
 * gradient comes from this kernel: what autodiff of rwkv6_scan_ref
 * computes for the same inputs.
 *
 * The adjoints, with G_t = dL/dS_t, G_{t-1} = diag(w_t) G_t + r_t dy_t^T
 * (G_S = dS_f) and c_t = v_t . dy_t:
 *     dr_t = S_{t-1} dy_t + u o k_t c_t,
 *     dk_t = G_t v_t + r_t o u c_t,
 *     dv_t = G_t^T k_t + (sum_i r_ti u_i k_ti) dy_t,
 *     du = sum_t r_t o k_t c_t,   ds0 = G_0,
 *     dlogw_t = sum_{tau > t} rho_tau + rowsum(dS_f o S_f)
 *               - sum_{s >= t} kappa_s,
 * with rho_tau = r_tau o (S_{tau-1} dy_tau) and kappa_s = k_s o (G_s v_s):
 * dlogw_t = w_t o rowsum(G_t o S_{t-1}) rewritten as two reverse
 * cumulative sums, so that no walk needs S_{t-1} and G_t at once (S
 * cannot be run backwards: that divides by w).  Its fp32 cancellation,
 * measured on the CPU with the plain mirror (rwkv6_scan_bwd_ref) at S
 * 2048, D 64, decays down to exp(-exp(-9)): 1.6e-6 of max |dlogw|.
 *
 * wkv_bwd_simt<D>: one block of 2 D threads owns one (batch, head), the
 * per-step walks in the shape of wkv_fwd_simt (and of the backward of the
 * public RWKV6 CUDA kernel, wkv6_cuda.cu of BlinkDL's RWKV-LM):
 *   - threads 0..D-1 are row threads, thread i holding row i of S, then
 *     of G, in D registers; threads D..2D-1 are column threads, thread
 *     D + j holding column j of G.  A row of S or G gives dr, rho, dk,
 *     kappa and du with no sum across threads, a column of G gives dv;
 *     the two copies of G run the same FMAs;
 *   - forward walk (row threads): dr, rho (kept in dlogw's buffer until
 *     the reverse walk reads it back), du; the walk ends with S_f, from
 *     which rowsum(dS_f o S_f) starts the running dlogw sum;
 *   - reverse walk (both): dk, dlogw (row threads), dv (column threads),
 *     then G <- diag(w_t) G + r_t dy_t^T; ds0 at the end;
 *   - r, k, w, v, dy (and rho) of 32 steps are staged in shared memory
 *     with coalesced loads and read as float4 broadcasts; c_t and
 *     sum_i r_ti u_i k_ti of the 32 steps by one thread a step; every dot
 *     product in four interleaved partial sums added in a fixed order.
 *   B * H blocks of 4 warps (D 64): latency-bound, as wkv_fwd_simt is.
 *
 * What bounds it.  5 D^2 multiply-adds a step and head at the least (S.dy
 * and the S update, G.v, G^T.k and the G update; the second copy of G
 * adds D^2): at the 100m training shape (B 32, H 12, S 128, D 64) 2.01e9
 * flops, 30.0 us at fp32's 67 TFLOP/s, against 113 MB read and written
 * (33.8 us at 3.35 TB/s; computed).  A bf16 backward, and tensor cores
 * (the chunked form, as the bf16 forward runs it), are ROADMAP Queue A
 * #15g step 3.
 *
 * The ragged end of S is masked (a partial last tile), never padded in
 * device memory; every sum runs in an order fixed by the shapes, so two
 * launches give bit-identical gradients.
 */
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kT = 32;           // timesteps staged at once

struct BwdParams {
  const float* r;
  const float* k;
  const float* v;
  const float* lw;
  const float* u;                // (H, D) contiguous
  const float* s0;               // (B, H, D, D) contiguous, or null
  const float* dy;
  const float* dsf;              // (B, H, D, D) contiguous, or null
  float* dr;
  float* dk;
  float* dv;
  float* dlw;
  float* du;                     // (B, H, D) contiguous: per (batch, head)
  float* ds0;                    // (B, H, D, D) contiguous, or null
  int64_t st[9][3];              // r, k, v, logw, dy, dr, dk, dv, dlogw:
                                 // (batch, head, seq) in elements
  int64_t S;
  int H;
};

template <int D>
constexpr int bwd_smem_floats() {
  return 6 * kT * D + 2 * kT + D;
}

// sum_j a[j] * x[j] over a row of D floats in shared memory (float4
// broadcasts), in four interleaved partial sums added in a fixed order
template <int D>
__device__ __forceinline__ float dot_row(const float (&a)[D],
                                         const float* x) {
  float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int j = 0; j < D; j += 4) {
    const float4 x4 = *reinterpret_cast<const float4*>(x + j);
    s[0] = fmaf(a[j], x4.x, s[0]);
    s[1] = fmaf(a[j + 1], x4.y, s[1]);
    s[2] = fmaf(a[j + 2], x4.z, s[2]);
    s[3] = fmaf(a[j + 3], x4.w, s[3]);
  }
  return (s[0] + s[1]) + (s[2] + s[3]);
}

template <int D>
__global__ void __launch_bounds__(2 * D)
wkv_bwd_simt(const BwdParams p) {
  static_assert(D % 32 == 0 && D <= 64, "D a multiple of 32, at most 64");
  extern __shared__ __align__(16) float sm[];
  float* rs = sm;                // [kT][D] r
  float* ks = rs + kT * D;       // [kT][D] k
  float* ws = ks + kT * D;       // [kT][D] w = exp(logw)
  float* vs = ws + kT * D;       // [kT][D] v
  float* dys = vs + kT * D;      // [kT][D] dy
  float* rhos = dys + kT * D;    // [kT][D] rho (reverse walk)
  float* cs = rhos + kT * D;     // [kT] v_t . dy_t
  float* as = cs + kT;           // [kT] sum_i r_ti u_i k_ti
  float* us = as + kT;           // [D]  u

  const int tid = threadIdx.x;
  const bool row = tid < D;      // warp-uniform: D is a multiple of 32
  const int i = row ? tid : tid - D;   // the row, or the column, owned
  const int h = blockIdx.x;
  const int64_t b = blockIdx.y;
  const float* rg = p.r + b * p.st[0][0] + h * p.st[0][1];
  const float* kg = p.k + b * p.st[1][0] + h * p.st[1][1];
  const float* vg = p.v + b * p.st[2][0] + h * p.st[2][1];
  const float* wg = p.lw + b * p.st[3][0] + h * p.st[3][1];
  const float* yg = p.dy + b * p.st[4][0] + h * p.st[4][1];
  float* drg = p.dr + b * p.st[5][0] + h * p.st[5][1];
  float* dkg = p.dk + b * p.st[6][0] + h * p.st[6][1];
  float* dvg = p.dv + b * p.st[7][0] + h * p.st[7][1];
  float* dwg = p.dlw + b * p.st[8][0] + h * p.st[8][1];
  const int64_t so = (b * p.H + h) * (int64_t)(D * D);

  if (row) us[i] = p.u[h * D + i];

  // stage r, k, w, v, dy (and rho) of steps t0 .. t0 + Tc, then c and the
  // bonus term of each step: thread t the first, thread kT + t the second,
  // reading element (j + t) mod D in turn (32 steps on 32 banks)
  auto stage = [&](int64_t t0, int Tc, bool with_rho) {
    __syncthreads();             // the last tile's readers are done
    for (int e = tid; e < Tc * D; e += 2 * D) {
      const int t = e / D, j = e % D;
      const int64_t s = t0 + t;
      rs[e] = rg[s * p.st[0][2] + j];
      ks[e] = kg[s * p.st[1][2] + j];
      vs[e] = vg[s * p.st[2][2] + j];
      ws[e] = expf(wg[s * p.st[3][2] + j]);
      dys[e] = yg[s * p.st[4][2] + j];
      if (with_rho) rhos[e] = dwg[s * p.st[8][2] + j];
    }
    __syncthreads();
    if (tid < Tc) {
      float c = 0.f;
      for (int e = 0; e < D; ++e) {
        const int j = (e + tid) % D;
        c = fmaf(vs[tid * D + j], dys[tid * D + j], c);
      }
      cs[tid] = c;
    } else if (tid >= kT && tid < kT + Tc) {
      const int t = tid - kT;
      float a = 0.f;
      for (int e = 0; e < D; ++e) {
        const int j = (e + t) % D;
        a = fmaf(rs[t * D + j] * us[j], ks[t * D + j], a);
      }
      as[t] = a;
    }
    __syncthreads();
  };

  float a[D];                    // row i of S, then of G; or column i of G
  float du = 0.f;
#pragma unroll
  for (int j = 0; j < D; ++j) a[j] = row && p.s0 ? p.s0[so + i * D + j] : 0.f;

  // ---- forward walk: dr, rho (into dlogw's buffer), du ---------------
  for (int64_t t0 = 0; t0 < p.S; t0 += kT) {
    const int Tc = (int)(p.S - t0 < kT ? p.S - t0 : kT);
    stage(t0, Tc, false);
    if (row) {
      for (int t = 0; t < Tc; ++t) {
        const float ri = rs[t * D + i], ki = ks[t * D + i];
        const float wi = ws[t * D + i];
        const float sdy = dot_row<D>(a, dys + t * D);
        const int64_t s = t0 + t;
        drg[s * p.st[5][2] + i] = fmaf(us[i] * ki, cs[t], sdy);
        dwg[s * p.st[8][2] + i] = ri * sdy;
        du = fmaf(ri * ki, cs[t], du);
#pragma unroll
        for (int j = 0; j < D; j += 4) {
          const float4 v4 = *reinterpret_cast<const float4*>(vs + t * D + j);
          a[j] = fmaf(wi, a[j], ki * v4.x);
          a[j + 1] = fmaf(wi, a[j + 1], ki * v4.y);
          a[j + 2] = fmaf(wi, a[j + 2], ki * v4.z);
          a[j + 3] = fmaf(wi, a[j + 3], ki * v4.w);
        }
      }
    }
  }

  // a: row i of S_f (row threads).  The running dlogw sum starts at
  // rowsum(dS_f o S_f); G starts at dS_f in both layouts
  float run = 0.f;
  if (row && p.dsf) {
    float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < D; ++j) s[j & 3] = fmaf(p.dsf[so + i * D + j], a[j],
                                                s[j & 3]);
    run = (s[0] + s[1]) + (s[2] + s[3]);
  }
#pragma unroll
  for (int j = 0; j < D; ++j)
    a[j] = !p.dsf ? 0.f : row ? p.dsf[so + i * D + j] : p.dsf[so + j * D + i];

  // ---- reverse walk: dk, dlogw (rows), dv (columns), G ----------------
  const int64_t n_tiles = (p.S + kT - 1) / kT;
  for (int64_t tile = n_tiles - 1; tile >= 0; --tile) {
    const int64_t t0 = tile * kT;
    const int Tc = (int)(p.S - t0 < kT ? p.S - t0 : kT);
    stage(t0, Tc, true);
    if (row) {
      for (int t = Tc - 1; t >= 0; --t) {
        const float ri = rs[t * D + i], ki = ks[t * D + i];
        const float wi = ws[t * D + i];
        const float gv = dot_row<D>(a, vs + t * D);
        const int64_t s = t0 + t;
        dkg[s * p.st[6][2] + i] = fmaf(ri * us[i], cs[t], gv);
        const float dlw = run - ki * gv;
        dwg[s * p.st[8][2] + i] = dlw;
        run = dlw + rhos[t * D + i];
#pragma unroll
        for (int j = 0; j < D; j += 4) {
          const float4 y4 = *reinterpret_cast<const float4*>(dys + t * D + j);
          a[j] = fmaf(wi, a[j], ri * y4.x);
          a[j + 1] = fmaf(wi, a[j + 1], ri * y4.y);
          a[j + 2] = fmaf(wi, a[j + 2], ri * y4.z);
          a[j + 3] = fmaf(wi, a[j + 3], ri * y4.w);
        }
      }
    } else {
      for (int t = Tc - 1; t >= 0; --t) {
        const float dyj = dys[t * D + i];
        const float gk = dot_row<D>(a, ks + t * D);
        dvg[(t0 + t) * p.st[7][2] + i] = fmaf(as[t], dyj, gk);
#pragma unroll
        for (int j = 0; j < D; j += 4) {
          const float4 w4 = *reinterpret_cast<const float4*>(ws + t * D + j);
          const float4 r4 = *reinterpret_cast<const float4*>(rs + t * D + j);
          a[j] = fmaf(w4.x, a[j], r4.x * dyj);
          a[j + 1] = fmaf(w4.y, a[j + 1], r4.y * dyj);
          a[j + 2] = fmaf(w4.z, a[j + 2], r4.z * dyj);
          a[j + 3] = fmaf(w4.w, a[j + 3], r4.w * dyj);
        }
      }
    }
  }
  if (row) {
    if (p.ds0) {
#pragma unroll
      for (int j = 0; j < D; ++j) p.ds0[so + i * D + j] = a[j];
    }
    p.du[(b * p.H + h) * D + i] = du;
  }
}

template <int D>
int launch(const BwdParams& p, int64_t B, int64_t H, cudaStream_t stream) {
  const int smem = bwd_smem_floats<D>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      wkv_bwd_simt<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)H, (unsigned)B);
  wkv_bwd_simt<D><<<grid, 2 * D, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// strides: 27 element strides, (batch, head, seq) of r, k, v, logw, dy,
// dr, dk, dv and dlogw in that order.  s0, dsf and ds0 may be null; u is
// (H, D) and du (B, H, D), both contiguous.  Returns cudaGetLastError()
// after the launch (0 = cudaSuccess).  The caller handles S == 0 without
// a launch.
extern "C" int rwkv6_scan_bwd(int D, const float* r, const float* k,
                              const float* v, const float* lw, const float* u,
                              const float* s0, const float* dy,
                              const float* dsf, float* dr, float* dk,
                              float* dv, float* dlw, float* du, float* ds0,
                              const int64_t* strides, int64_t B, int64_t H,
                              int64_t S, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0 || B > 65535 || H > 0x3fffffffLL)
    return (int)cudaErrorInvalidValue;
  BwdParams p;
  p.r = r;
  p.k = k;
  p.v = v;
  p.lw = lw;
  p.u = u;
  p.s0 = s0;
  p.dy = dy;
  p.dsf = dsf;
  p.dr = dr;
  p.dk = dk;
  p.dv = dv;
  p.dlw = dlw;
  p.du = du;
  p.ds0 = ds0;
  for (int i = 0; i < 9; ++i)
    for (int j = 0; j < 3; ++j) p.st[i][j] = strides[i * 3 + j];
  p.S = S;
  p.H = (int)H;
  cudaStream_t s = (cudaStream_t)stream;
  if (D == 64) return launch<64>(p, B, H, s);
  if (D == 32) return launch<32>(p, B, H, s);
  return (int)cudaErrorInvalidValue;
}
