/*
 * ssm_scan — the chunked Mamba2 SSD scan for Hopper (sm_90a).
 *
 *     h_t = exp(dt_t * A_h) * h_{t-1} + dt_t * x_t (x) B_t,   y_t = C_t . h_t
 *
 *     x: (B, H, S, P), dt: (B, H, S), A: (H,) fp32, B/C: (B, G, S, N) with
 *     head h reading group h / (H / G), h0: (B, H, P, N) fp32 or null
 *     (zeros) -> y (B, H, S, P) fp32, h_final (B, H, P, N) fp32.  x, dt,
 *     B, C and y are strided views whose last axis is contiguous (x, B, C,
 *     y); x, B and C are fp32 or bf16, dt fp32 or bf16, computed in fp32.
 *     P in {32, 64}, N in {16, 64}: zamba2-1.2b's heads (P 64, N 64) and
 *     its reduced() variant's (P 32, N 16).
 *
 * Replaces the TPU kernel repro/kernels/ssm_scan/kernel.py:66
 * ssm_scan_pallas (body _ssd_kernel).  It computes the same chunked form:
 * per chunk, the within-chunk cumulative log-decay seg = cumsum(dt * A);
 * the intra-chunk term M = (C B^T) o exp(seg_i - seg_l) [l <= i] and
 * y = M (x dt); the inter-chunk term exp(seg_i) C_i . state; and the state
 * update state <- exp(seg_last) state + sum_l exp(seg_last - seg_l)
 * (x_l dt_l) (x) B_l.
 *
 * Design.  On the TPU the chunk axis is the innermost, sequential grid axis
 * and the (P, N) state carries in VMEM scratch across it; on Hopper no
 * state carries from one block to the next, so one block of 256 threads
 * owns one (batch, head) and walks the chunks of S in a loop, with the
 * fp32 state in shared memory for the whole walk:
 *   - the chunk length inside the kernel is 64, whatever chunk the plain
 *     path uses: x dt, B and C of a chunk (64 rows each), the state and
 *     the 64 x 64 masked decay matrix fit in 84,224 bytes of shared memory
 *     at P = N = 64 (256 fp32 rows would take 196 KB for x, B and C
 *     alone).  Rows are padded by one float, so the 16 threads of a
 *     half-warp that read one column of 16 rows hit 16 banks;
 *   - seg is an inclusive warp scan (shuffles) of dt * A; exp(seg_i - seg_l)
 *     is taken only where l <= i.  Above the diagonal the difference is
 *     positive and its exp can overflow to inf: it is never formed, so
 *     no inf * 0 can occur;
 *   - the three products (C B^T, M (x dt) with C state^T, and the state
 *     update) are register-tiled on a 16 x 16 thread grid, fp32 FMAs,
 *     each output summed in a fixed order;
 *   - groups are an index (head h reads B and C of group h / (H / G)),
 *     not a copy; every tensor is read and written through its strides,
 *     so the model's (B, S, H, P) layout needs no transpose;
 *   - the ragged last chunk is masked: rows past S are never loaded (they
 *     hold zeros in shared memory) and seg_last is the last valid row's;
 *   - no atomics, so two launches give bit-identical output.
 *
 * What bounds it.  At the zamba2-1.2b prefill shape (B 4, S 4096, H 64,
 * P 64, N 64, one group, bf16 x/B/C, fp32 dt, no h0) the function reads
 * and writes 415,236,352 bytes: 123.9 us at 3.35 TB/s.  The chunked form
 * at chunk 64 takes 2.59e10 flops: 26 us on bf16 tensor cores, so the
 * bound is the bytes, but 387 us on the fp32 cores this kernel uses.  The
 * grid is B * H = 256 blocks of 256 threads on 132 SMs (two blocks fit an
 * SM at 84 KB each), so it is one wave.  The kernel is bound by its SIMT
 * FMAs and the shared-memory reads that feed them (two loads per four
 * FMAs in the C B^T tile).  Left to a redesign (ROADMAP Queue B #4): the
 * three chunk products on bf16 tensor cores (wgmma or mma.sync), one
 * C B^T shared by all the heads of a group (zamba2 has 64 heads on one
 * group: the same 64 x 64 C B^T is formed 64 times), TMA staging of the
 * next chunk while this one computes, and more blocks than B * H.
 */
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kL = 64;           // chunk length inside the kernel
constexpr int kMS = kL + 1;      // row stride of the M tile

struct Params {
  const void* x;
  const void* dt;
  const float* A;
  const void* bm;
  const void* cm;
  const float* h0;               // (B, H, P, N) contiguous, or null
  float* y;
  float* hf;                     // (B, H, P, N) contiguous
  int64_t sxb, sxh, sxs;         // strides in elements: batch, head, seq
  int64_t sdb, sdh, sds;
  int64_t sbb, sbg, sbs;         // B and C: batch, group, seq
  int64_t scb, scg, scs;
  int64_t syb, syh, sys;
  int64_t S;
  int H;
  int rep;                       // heads per group, H / G
};

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <int P, int N>
constexpr int smem_floats() {
  return kL * (P + 1) + 2 * kL * (N + 1) + P * (N + 1) + kL * kMS + 4 * kL;
}

template <typename T, typename TD, int P, int N>
__global__ void __launch_bounds__(kThreads)
ssd_fwd(const Params p) {
  static_assert(P % 16 == 0 && N % 16 == 0 && kL == 64, "tiling");
  constexpr int kXS = P + 1;     // row strides, one float of padding
  constexpr int kNS = N + 1;
  constexpr int kPC = P / 16;    // columns or rows of P a thread owns
  constexpr int kNC = N / 16;
  extern __shared__ float smem[];
  float* xs = smem;              // [kL][kXS]  x * dt
  float* bs = xs + kL * kXS;     // [kL][kNS]  B
  float* cs = bs + kL * kNS;     // [kL][kNS]  C
  float* st = cs + kL * kNS;     // [P][kNS]   the state
  float* ms = st + P * kNS;      // [kL][kMS]  M = (C B^T) o decay, masked
  float* dts = ms + kL * kMS;    // [kL] dt
  float* seg = dts + kL;         // [kL] inclusive cumsum of dt * A
  float* eseg = seg + kL;        // [kL] exp(seg)
  float* wl = eseg + kL;         // [kL] exp(seg_last - seg)

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int h = blockIdx.x;
  const int64_t b = blockIdx.y;
  const int64_t g = h / p.rep;
  const float A = p.A[h];
  const T* xg = static_cast<const T*>(p.x) + b * p.sxb + h * p.sxh;
  const TD* dg = static_cast<const TD*>(p.dt) + b * p.sdb + h * p.sdh;
  const T* bg = static_cast<const T*>(p.bm) + b * p.sbb + g * p.sbg;
  const T* cg = static_cast<const T*>(p.cm) + b * p.scb + g * p.scg;
  float* yg = p.y + b * p.syb + h * p.syh;
  const int64_t so = (b * p.H + h) * (int64_t)(P * N);

  for (int e = tid; e < P * N; e += kThreads)
    st[(e / N) * kNS + e % N] = p.h0 ? p.h0[so + e] : 0.f;

  for (int64_t c0 = 0; c0 < p.S; c0 += kL) {
    const int Lc = (int)(p.S - c0 < kL ? p.S - c0 : kL);
    __syncthreads();             // the last chunk's readers are done
    if (tid < kL) dts[tid] = tid < Lc ? ld(dg + (c0 + tid) * p.sds) : 0.f;
    for (int e = tid; e < kL * N; e += kThreads) {
      const int l = e / N, n = e % N;
      const bool ok = l < Lc;
      bs[l * kNS + n] = ok ? ld(bg + (c0 + l) * p.sbs + n) : 0.f;
      cs[l * kNS + n] = ok ? ld(cg + (c0 + l) * p.scs + n) : 0.f;
    }
    __syncthreads();             // dts
    for (int e = tid; e < kL * P; e += kThreads) {
      const int l = e / P, c = e % P;
      xs[l * kXS + c] = l < Lc ? ld(xg + (c0 + l) * p.sxs + c) * dts[l] : 0.f;
    }
    if (tid < 32) {              // seg: an inclusive scan over 2 x 32 lanes
      float a0 = dts[tid] * A, a1 = dts[tid + 32] * A;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float u0 = __shfl_up_sync(0xffffffffu, a0, o);
        const float u1 = __shfl_up_sync(0xffffffffu, a1, o);
        if (tid >= o) {
          a0 += u0;
          a1 += u1;
        }
      }
      a1 += __shfl_sync(0xffffffffu, a0, 31);
      seg[tid] = a0;
      seg[tid + 32] = a1;
      __syncwarp();
      const float last = seg[Lc - 1];
      eseg[tid] = expf(a0);
      eseg[tid + 32] = expf(a1);
      wl[tid] = expf(last - a0);
      wl[tid + 32] = expf(last - a1);
    }
    __syncthreads();             // xs, seg, eseg, wl

    // M[i][l] = (C_i . B_l) exp(seg_i - seg_l) for l <= i, else 0;
    // thread (ty, tx) owns rows ty + 16a, columns tx + 16c
    {
      float acc[4][4] = {};
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        float cv[4], bv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) cv[a] = cs[(ty + 16 * a) * kNS + n];
#pragma unroll
        for (int c = 0; c < 4; ++c) bv[c] = bs[(tx + 16 * c) * kNS + n];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[a][c] = fmaf(cv[a], bv[c], acc[a][c]);
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = ty + 16 * a;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int l = tx + 16 * c;
          ms[i * kMS + l] = l <= i ? acc[a][c] * expf(seg[i] - seg[l]) : 0.f;
        }
      }
    }
    __syncthreads();             // ms

    // y[i][q] = sum_l M[i][l] xdt[l][q] + exp(seg_i) sum_n C[i][n] st[q][n];
    // thread (ty, tx) owns rows ty + 16a, columns tx + 16c
    {
      float intra[4][kPC] = {};
      float inter[4][kPC] = {};
#pragma unroll 4
      for (int l = 0; l < kL; ++l) {
        float mv[4], xv[kPC];
#pragma unroll
        for (int a = 0; a < 4; ++a) mv[a] = ms[(ty + 16 * a) * kMS + l];
#pragma unroll
        for (int c = 0; c < kPC; ++c) xv[c] = xs[l * kXS + tx + 16 * c];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < kPC; ++c)
            intra[a][c] = fmaf(mv[a], xv[c], intra[a][c]);
      }
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        float cv[4], sv[kPC];
#pragma unroll
        for (int a = 0; a < 4; ++a) cv[a] = cs[(ty + 16 * a) * kNS + n];
#pragma unroll
        for (int c = 0; c < kPC; ++c) sv[c] = st[(tx + 16 * c) * kNS + n];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < kPC; ++c)
            inter[a][c] = fmaf(cv[a], sv[c], inter[a][c]);
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = ty + 16 * a;
        if (i < Lc) {
          float* yrow = yg + (c0 + i) * p.sys;
#pragma unroll
          for (int c = 0; c < kPC; ++c)
            yrow[tx + 16 * c] = intra[a][c] + eseg[i] * inter[a][c];
        }
      }
    }
    __syncthreads();             // the readers of the old state are done

    // state[q][n] = exp(seg_last) state[q][n]
    //               + sum_l (xdt[l][q] exp(seg_last - seg_l)) B[l][n];
    // thread (ty, tx) owns rows ty + 16a, columns tx + 16c
    {
      float acc[kPC][kNC] = {};
#pragma unroll 4
      for (int l = 0; l < kL; ++l) {
        const float w = wl[l];
        float xv[kPC], bv[kNC];
#pragma unroll
        for (int a = 0; a < kPC; ++a) xv[a] = xs[l * kXS + ty + 16 * a] * w;
#pragma unroll
        for (int c = 0; c < kNC; ++c) bv[c] = bs[l * kNS + tx + 16 * c];
#pragma unroll
        for (int a = 0; a < kPC; ++a)
#pragma unroll
          for (int c = 0; c < kNC; ++c) acc[a][c] = fmaf(xv[a], bv[c], acc[a][c]);
      }
      const float decay = eseg[Lc - 1];
#pragma unroll
      for (int a = 0; a < kPC; ++a)
#pragma unroll
        for (int c = 0; c < kNC; ++c) {
          float* s = st + (ty + 16 * a) * kNS + tx + 16 * c;
          *s = decay * *s + acc[a][c];
        }
    }
  }
  __syncthreads();
  for (int e = tid; e < P * N; e += kThreads)
    p.hf[so + e] = st[(e / N) * kNS + e % N];
}

template <typename T, typename TD, int P, int N>
int launch(const Params& p, int64_t B, int64_t H, cudaStream_t stream) {
  const int smem = smem_floats<P, N>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_fwd<T, TD, P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)H, (unsigned)B);
  ssd_fwd<T, TD, P, N><<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T, typename TD>
int dispatch_pn(int P, int N, const Params& p, int64_t B, int64_t H,
                cudaStream_t s) {
  if (P == 64 && N == 64) return launch<T, TD, 64, 64>(p, B, H, s);
  if (P == 64 && N == 16) return launch<T, TD, 64, 16>(p, B, H, s);
  if (P == 32 && N == 64) return launch<T, TD, 32, 64>(p, B, H, s);
  if (P == 32 && N == 16) return launch<T, TD, 32, 16>(p, B, H, s);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int dispatch_dt(int dt_dtype, int P, int N, const Params& p, int64_t B,
                int64_t H, cudaStream_t s) {
  if (dt_dtype == 0) return dispatch_pn<T, float>(P, N, p, B, H, s);
  if (dt_dtype == 1) return dispatch_pn<T, __nv_bfloat16>(P, N, p, B, H, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype (x, B, C) and dt_dtype: 0 = float32, 1 = bfloat16.  strides: 15
// element strides, (batch, head, seq) of x, dt and y and (batch, group,
// seq) of B and C, in the order x, dt, B, C, y.  h0 may be null (zeros);
// hf is (B, H, P, N) contiguous.  Returns cudaGetLastError() after the
// launch (0 = cudaSuccess).  The caller handles S == 0 without a launch.
extern "C" int ssm_scan_fwd(int dtype, int dt_dtype, int P, int N,
                            const void* x, const void* dt, const float* A,
                            const void* bm, const void* cm, const float* h0,
                            float* y, float* hf, const int64_t* strides,
                            int64_t B, int64_t H, int64_t G, int64_t S,
                            void* stream) {
  if (B <= 0 || H <= 0 || G <= 0 || S <= 0 || H % G || B > 65535 ||
      H > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.x = x;
  p.dt = dt;
  p.A = A;
  p.bm = bm;
  p.cm = cm;
  p.h0 = h0;
  p.y = y;
  p.hf = hf;
  p.sxb = strides[0]; p.sxh = strides[1]; p.sxs = strides[2];
  p.sdb = strides[3]; p.sdh = strides[4]; p.sds = strides[5];
  p.sbb = strides[6]; p.sbg = strides[7]; p.sbs = strides[8];
  p.scb = strides[9]; p.scg = strides[10]; p.scs = strides[11];
  p.syb = strides[12]; p.syh = strides[13]; p.sys = strides[14];
  p.S = S;
  p.H = (int)H;
  p.rep = (int)(H / G);
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return dispatch_dt<float>(dt_dtype, P, N, p, B, H, s);
  if (dtype == 1)
    return dispatch_dt<__nv_bfloat16>(dt_dtype, P, N, p, B, H, s);
  return (int)cudaErrorInvalidValue;
}
