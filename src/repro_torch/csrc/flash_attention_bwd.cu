/*
 * flash_attention_bwd — the gradient of fp32 and bf16 flash attention for
 * Hopper (sm_90a), SIMT fp32 arithmetic for both.
 *
 *     S = scale * Q K^T (masked),  P = exp(S - lse),  O = P V
 *     dV = P^T dO,  dP = dO V^T,  dS = P o (dP - delta),
 *     dQ = scale * dS K,  dK = scale * dS^T Q,
 *     delta[i] = sum_d dO[i, d] * O[i, d]
 *
 *     q, o, dO, dq: (B, Hq, Sq, D); k, v, dk, dv: (B, Hkv, Sk, D), each a
 *     strided view whose last axis is contiguous; lse and delta: (B, Hq,
 *     Sq) fp32, contiguous; G = Hq / Hkv; D in {32, 64, 80, 128, 192};
 *     q, k, v, o, dO, dq, dk and dv all fp32 or all bf16.
 *
 * The JAX package has no backward kernel: its model trains through plain
 * JAX attention (repro/models/transformer.py, attn_impl "chunked") and
 * autodiff.  The port's model runs the hand-written forward kernel
 * (csrc/flash_attention.cu, flash_fwd_simt, the replacement of the TPU
 * kernel repro/kernels/flash_attention/kernel.py:69
 * flash_attention_pallas), so its gradient comes from this kernel: it
 * computes what autodiff of repro_torch's attention_ref computes for the
 * same fp32 inputs.  lse is the forward's per-row log-sum-exp of the
 * scaled, masked scores, which flash_fwd_simt (fp32) and flash_fwd_wgmma
 * (bf16) write beside o, in the same natural-log units.
 *
 * bf16 (the training path of a bf16 model): every bf16 input is widened
 * to fp32 as it is loaded (exact) into the same fp32 shared-memory tiles,
 * and everything after is the fp32 kernel's arithmetic, instruction for
 * instruction; dq, dk and dv are rounded to bf16 once, from their fp32
 * accumulators, as they are stored (a GQA group's dK and dV are summed in
 * fp32 inside one block first).  delta cannot come from o there: the
 * forward keeps o in bf16 only, and dO . bf16(o) moved dq and dk by
 * ~2e-3 of their max |g| (float64 mirror on the CPU, zamba2's training
 * shape), 20x the gate.  So bf16 takes delta[i] = sum_j P_ij dP_ij, the
 * same number for the exact o, from P and dP recomputed in fp32: a
 * first walk of flash_bwd_dq (S and dP again, two more of the products
 * below) in place of flash_bwd_delta.  So it computes the fp32 gradient
 * of the fp32 attention of the bf16 values, the most accurate gradient
 * the card gives for bf16 inputs.  A tensor-core backward (P and dS in
 * bf16) is later work, to be held against this one.
 *
 * Masks work on absolute positions qp = q_offset + i and kp, as the
 * forward's: causal keeps kp <= qp, a window W keeps kp > qp - W; a
 * masked pair, a key past Sk and a query row past Sq have P = 0.  The
 * plain version gives a row that sees no key the mean of V over every
 * key; this kernel does not: the wrapper refuses such calls (they do not
 * occur in training, where every row sees at least its own key).
 *
 * Three kernels for fp32, two for bf16, each on the current stream, in
 * this order:
 *
 * flash_bwd_delta (fp32 only): delta = rowsum(dO o), one warp a row.
 *
 * flash_bwd_dq<D>: one block owns one (batch, query head, 64-row query
 * tile) and walks the key tiles the forward walks (the same bounds),
 * K and V transposed in shared memory, the scaled Q tile and the dO tile
 * as rows: S and dP (4 rows x 4 keys a thread), dS = P o (dP - delta)
 * into shared memory, dQ += dS K (4 rows x D/16 columns a thread),
 * scaled once at the end.  For bf16 a first walk over the same tiles
 * forms delta = rowsum(P dP) (S and dP, 4 rows x 4 keys a thread, a
 * row's 16 partial sums by a fixed shuffle tree) and writes it for
 * flash_bwd_dkdv, which therefore runs after this kernel.
 *
 * flash_bwd_dkdv<D>: one block of 256 threads owns one (batch, kv head,
 * 64-key tile).  It keeps K and V of its tile in shared memory and walks
 * the G query heads of its group and, for each, the 64-row query tiles
 * that can see its keys (the rest skipped by the causal and window
 * bounds): the scaled Q tile and the dO tile transposed ([D][68]), lse
 * and delta staged; P^T (keys x queries) recomputed from S^T = K (scale
 * Q)^T, then dV += P^T dO, dP^T = V dO^T, dS^T = P^T o (dP^T - delta),
 * dK += dS^T (scale Q).  Thread (ty, tx) of a 16 x 16 grid owns 4 keys x
 * 4 queries of S^T and 4 keys x D/16 columns of dK and dV, which stay in
 * registers across the whole walk.  Summing the group inside the block
 * means no two blocks write one row of dk or dv: no atomics.
 *
 * Every product is fp32 SIMT FMAs (no TF32): the gates are fp32.  Every
 * sum runs in an order fixed by the shapes, so two launches give
 * bit-identical gradients.  Shared memory: four D x 64 tiles and a 64 x
 * 68 one, 220,672 bytes at D 192.  Reads of shared memory are float4
 * along the contracted axis: broadcast across the 16 threads that share
 * a row, or 8 consecutive threads on 8 rows of stride 68, which covers
 * the 32 banks once.
 *
 * What bounds it.  The five products over the visible (query, key)
 * pairs are 10 * pairs * D flops (S and dP recomputed, dV, dK, dQ, with
 * S again in the dq pass: 12 * pairs * D done); at 67 TFLOP/s of fp32
 * the 100m training shape (B 32, Hq 12 / Hkv 4, S 128, D 64, causal) is
 * bound at 30.3 us by operations against 20.1 us for its 67.3 MB of
 * bytes at 3.35 TB/s (computed).  A SIMT
 * kernel reaches a fraction of the fp32 rate.  In bf16 the same work is
 * bound by the tensor cores at 989 TFLOP/s, which this kernel does not
 * use: wgmma and TMA are later work (ROADMAP Queue B, the flash backward
 * on tensor cores).
 */
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBT = 64;          // query rows of a query tile, keys of a key tile
constexpr int kTS = kBT + 4;     // row stride of the transposed tiles

struct BwdParams {
  const void* q;                 // q, k, v, o, dout, dq, dk, dv: T
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;
  float* delta;
  void* dq;
  void* dk;
  void* dv;
  // element strides (batch, head, seq) of q, k, v, o, dout, dq, dk, dv
  int64_t st[8][3];
  int64_t Hq, Sq, Sk, q_offset;
  int64_t window;                // <= 0: no window
  int D;
  int group;                     // Hq / Hkv
  int causal;
  int n_qtiles;
  float scale;
};

enum { kQ = 0, kK, kV, kO, kDO, kDQ, kDK, kDV };

__host__ __device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}
__host__ __device__ __forceinline__ int64_t max64(int64_t a, int64_t b) {
  return a > b ? a : b;
}

// four consecutive elements, widened to fp32 (bf16 -> fp32 is exact)
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}
// a gradient's one rounding, from its fp32 accumulator
__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}
__device__ __forceinline__ float lane(const float4& x, int j) {
  return j == 0 ? x.x : j == 1 ? x.y : j == 2 ? x.z : x.w;
}
__device__ __forceinline__ float4 scale4(float4 x, float s) {
  return make_float4(x.x * s, x.y * s, x.z * s, x.w * s);
}

__device__ __forceinline__ bool visible(const BwdParams& p, int64_t qp,
                                        int64_t kp) {
  bool ok = true;
  if (p.causal) ok = ok && kp <= qp;
  if (p.window > 0) ok = ok && kp > qp - p.window;
  return ok;
}

// Rows [r0, r0 + 64) of a (seq, D) matrix at base g (row stride rs) into
// shared memory transposed, t[d * kTS + r], rows past n zero, each
// element times s.  32 consecutive indices cover 8 rows x 4 groups of 4
// elements: a warp reads runs of 16 elements and its transposed stores
// are at most 2-way bank-conflicted.
template <int D, typename T>
__device__ __forceinline__ void load_transposed(float* t, const T* g,
                                                int64_t rs, int64_t r0,
                                                int64_t n, float s) {
  constexpr int kV4 = D / 4;
  for (int idx = threadIdx.x; idx < kBT * kV4; idx += kThreads) {
    const int w = idx >> 5;
    const int ln = idx & 31;
    const int c = (w & 7) * 8 + (ln & 7);
    const int d4 = ((w >> 3) * 4 + (ln >> 3)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + c < n) x = scale4(load4(g + (r0 + c) * rs + d4), s);
    t[(d4 + 0) * kTS + c] = x.x;
    t[(d4 + 1) * kTS + c] = x.y;
    t[(d4 + 2) * kTS + c] = x.z;
    t[(d4 + 3) * kTS + c] = x.w;
  }
}

// The same rows as rows, r[row * D + d]
template <int D, typename T>
__device__ __forceinline__ void load_rows(float* r, const T* g,
                                          int64_t rs, int64_t r0, int64_t n,
                                          float s) {
  constexpr int kV4 = D / 4;
  for (int idx = threadIdx.x; idx < kBT * kV4; idx += kThreads) {
    const int c = idx / kV4;
    const int d4 = (idx % kV4) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + c < n) x = scale4(load4(g + (r0 + c) * rs + d4), s);
    *reinterpret_cast<float4*>(r + c * D + d4) = x;
  }
}

// acc[i][j] += sum_d a[(r + i) * D + d] * bt[d * kTS + c + j] for this
// thread's rows r = ty * 4 and columns c = tx * 4: a as rows, b
// transposed
template <int D>
__device__ __forceinline__ void rows_times_cols(float (&acc)[4][4],
                                                const float* a,
                                                const float* bt, int ty,
                                                int tx) {
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      av[i] = *reinterpret_cast<const float4*>(a + (ty * 4 + i) * D + d);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      bv[e] = *reinterpret_cast<const float4*>(bt + (d + e) * kTS + tx * 4);
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[i][j] = fmaf(lane(av[i], e), lane(bv[e], j), acc[i][j]);
  }
}

// acc[i][c] += sum_n m[(ty * 4 + i) * kTS + n] * bt[(tx + 16 c) * kTS + n]
// over the 64 columns n of m (a 64 x 64 tile in shared memory) and a
// transposed D x 64 operand bt
template <int D>
__device__ __forceinline__ void tile_times_rows(float (&acc)[4][D / 16],
                                                const float* m,
                                                const float* bt, int ty,
                                                int tx) {
  constexpr int kCols = D / 16;
#pragma unroll 2
  for (int n = 0; n < kBT; n += 4) {
    float4 mv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      mv[i] = *reinterpret_cast<const float4*>(m + (ty * 4 + i) * kTS + n);
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const float4 bv =
          *reinterpret_cast<const float4*>(bt + (tx + 16 * c) * kTS + n);
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          acc[i][c] = fmaf(lane(mv[i], e), lane(bv, e), acc[i][c]);
    }
  }
}

// fp32: delta[i] = dO_i . o_i, one warp a row
__global__ void __launch_bounds__(kThreads) flash_bwd_delta(const BwdParams p) {
  const int warp = threadIdx.x >> 5;
  const int ln = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * (kThreads / 32) + warp;
  const int64_t h = blockIdx.y;
  const int64_t b = blockIdx.z;
  if (row >= p.Sq) return;
  const float* o = static_cast<const float*>(p.o) + b * p.st[kO][0] +
                   h * p.st[kO][1] + row * p.st[kO][2];
  const float* d = static_cast<const float*>(p.dout) + b * p.st[kDO][0] +
                   h * p.st[kDO][1] + row * p.st[kDO][2];
  float acc = 0.f;
  for (int c = ln; c < p.D; c += 32) acc = fmaf(d[c], o[c], acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (ln == 0) p.delta[(b * p.Hq + h) * p.Sq + row] = acc;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkdv(const BwdParams p) {
  static_assert(D % 16 == 0 && D <= 192, "D a multiple of 16, at most 192");
  constexpr int kCols = D / 16;
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);  // [kBT][D] K rows
  float* vs = ks + kBT * D;                     // [kBT][D] V rows
  float* qt = vs + kBT * D;                     // [D][kTS] scale Q, transposed
  float* dot = qt + D * kTS;                    // [D][kTS] dO, transposed
  float* pt = dot + D * kTS;                    // [kBT][kTS] P^T, then dS^T
  float* lse_s = pt + kBT * kTS;                // [kBT]
  float* dl_s = lse_s + kBT;                    // [kBT]

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int64_t k0 = (int64_t)blockIdx.x * kBT;
  const int64_t hk = blockIdx.y;
  const int64_t b = blockIdx.z;

  load_rows<D>(ks, static_cast<const T*>(p.k) + b * p.st[kK][0] +
                       hk * p.st[kK][1],
               p.st[kK][2], k0, p.Sk, 1.f);
  load_rows<D>(vs, static_cast<const T*>(p.v) + b * p.st[kV][0] +
                       hk * p.st[kV][1],
               p.st[kV][2], k0, p.Sk, 1.f);

  float dk[4][kCols], dv[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) dk[i][c] = dv[i][c] = 0.f;

  // the query rows that see some key of this tile
  const int64_t k_last = min64(k0 + kBT, p.Sk) - 1;
  int64_t i_lo = 0, i_hi = p.Sq - 1;
  if (p.causal) i_lo = max64(i_lo, k0 - p.q_offset);
  if (p.window > 0) i_hi = min64(i_hi, k_last + p.window - 1 - p.q_offset);

  if (i_lo <= i_hi) {
    for (int g = 0; g < p.group; ++g) {
      const int64_t h = hk * p.group + g;
      const T* qg = static_cast<const T*>(p.q) + b * p.st[kQ][0] +
                    h * p.st[kQ][1];
      const T* dg = static_cast<const T*>(p.dout) + b * p.st[kDO][0] +
                    h * p.st[kDO][1];
      const int64_t row_base = (b * p.Hq + h) * p.Sq;
      for (int64_t t = i_lo / kBT; t <= i_hi / kBT; ++t) {
        const int64_t q0 = t * kBT;
        __syncthreads();  // the previous tile's qt, dot and pt are read
        load_transposed<D>(qt, qg, p.st[kQ][2], q0, p.Sq, p.scale);
        load_transposed<D>(dot, dg, p.st[kDO][2], q0, p.Sq, 1.f);
        if (tid < kBT) {
          const int64_t row = q0 + tid;
          lse_s[tid] = row < p.Sq ? p.lse[row_base + row] : 0.f;
          dl_s[tid] = row < p.Sq ? p.delta[row_base + row] : 0.f;
        }
        __syncthreads();

        // S^T over this thread's 4 keys x 4 queries, then P^T
        float s[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
        rows_times_cols<D>(s, ks, qt, ty, tx);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int64_t kp = k0 + ty * 4 + i;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int64_t row = q0 + tx * 4 + j;
            const bool ok = kp < p.Sk && row < p.Sq &&
                            visible(p, p.q_offset + row, kp);
            s[i][j] = ok ? expf(s[i][j] - lse_s[tx * 4 + j]) : 0.f;
          }
          *reinterpret_cast<float4*>(pt + (ty * 4 + i) * kTS + tx * 4) =
              make_float4(s[i][0], s[i][1], s[i][2], s[i][3]);
        }
        // dP^T = V dO^T
        float dp[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) dp[i][j] = 0.f;
        rows_times_cols<D>(dp, vs, dot, ty, tx);
        __syncthreads();  // P^T is written

        tile_times_rows<D>(dv, pt, dot, ty, tx);    // dV += P^T dO
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            s[i][j] = s[i][j] * (dp[i][j] - dl_s[tx * 4 + j]);
        __syncthreads();  // every thread is done with P^T
#pragma unroll
        for (int i = 0; i < 4; ++i)
          *reinterpret_cast<float4*>(pt + (ty * 4 + i) * kTS + tx * 4) =
              make_float4(s[i][0], s[i][1], s[i][2], s[i][3]);
        __syncthreads();
        tile_times_rows<D>(dk, pt, qt, ty, tx);     // dK += dS^T (scale Q)
      }
    }
  }

  // the group's dK and dV, summed in fp32 above, rounded once to T
  T* dkg = static_cast<T*>(p.dk) + b * p.st[kDK][0] + hk * p.st[kDK][1];
  T* dvg = static_cast<T*>(p.dv) + b * p.st[kDV][0] + hk * p.st[kDV][1];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t kp = k0 + ty * 4 + i;
    if (kp < p.Sk) {
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        store1(dkg + kp * p.st[kDK][2] + tx + 16 * c, dk[i][c]);
        store1(dvg + kp * p.st[kDV][2] + tx + 16 * c, dv[i][c]);
      }
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq(const BwdParams p) {
  static_assert(D % 16 == 0 && D <= 192, "D a multiple of 16, at most 192");
  constexpr int kCols = D / 16;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [kBT][D] scale Q rows
  float* dos = qs + kBT * D;                    // [kBT][D] dO rows
  float* kt = dos + kBT * D;                    // [D][kTS] K, transposed
  float* vt = kt + D * kTS;                     // [D][kTS] V, transposed
  float* ds = vt + D * kTS;                     // [kBT][kTS] dS
  float* lse_s = ds + kBT * kTS;                // [kBT]
  float* dl_s = lse_s + kBT;                    // [kBT]

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  // causal: the longest tiles (the last query rows) first
  const int64_t q0 = (int64_t)(p.n_qtiles - 1 - (int64_t)blockIdx.x) * kBT;
  const int64_t h = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int64_t hk = h / p.group;
  const T* kg = static_cast<const T*>(p.k) + b * p.st[kK][0] +
                hk * p.st[kK][1];
  const T* vg = static_cast<const T*>(p.v) + b * p.st[kV][0] +
                hk * p.st[kV][1];

  load_rows<D>(qs, static_cast<const T*>(p.q) + b * p.st[kQ][0] +
                       h * p.st[kQ][1],
               p.st[kQ][2], q0, p.Sq, p.scale);
  load_rows<D>(dos, static_cast<const T*>(p.dout) + b * p.st[kDO][0] +
                        h * p.st[kDO][1],
               p.st[kDO][2], q0, p.Sq, 1.f);
  const int64_t row_base = (b * p.Hq + h) * p.Sq;
  if (tid < kBT) {
    const int64_t row = q0 + tid;
    lse_s[tid] = row < p.Sq ? p.lse[row_base + row] : 0.f;
    if constexpr (sizeof(T) == 4)
      dl_s[tid] = row < p.Sq ? p.delta[row_base + row] : 0.f;
  }

  // the forward's kv tiles (the wrapper refuses rows with no visible key)
  const int64_t qlo = p.q_offset + q0;
  const int64_t qhi = qlo + min64(kBT, p.Sq - q0) - 1;
  int64_t kt_first = 0;
  int64_t kt_last = (p.Sk - 1) / kBT;
  if (p.window > 0) kt_first = max64(0, qlo - p.window + 1) / kBT;
  if (p.causal) kt_last = min64(p.Sk - 1, qhi) / kBT;

  if constexpr (sizeof(T) == 2) {
    // bf16: delta[i] = sum_j P_ij dP_ij first, a walk over the same key
    // tiles (S and dP only), into dl_s and into p.delta for dK/dV; a
    // row's sum over its 16 threads by a fixed shuffle tree
    float part[4] = {0.f, 0.f, 0.f, 0.f};
    for (int64_t t = kt_first; t <= kt_last; ++t) {
      const int64_t k0 = t * kBT;
      __syncthreads();  // lse_s is written; the previous kt and vt read
      load_transposed<D>(kt, kg, p.st[kK][2], k0, p.Sk, 1.f);
      load_transposed<D>(vt, vg, p.st[kV][2], k0, p.Sk, 1.f);
      __syncthreads();
      float s[4][4] = {}, dp[4][4] = {};
      rows_times_cols<D>(s, qs, kt, ty, tx);
      rows_times_cols<D>(dp, dos, vt, ty, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int64_t row = q0 + ty * 4 + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int64_t kp = k0 + tx * 4 + j;
          if (kp < p.Sk && row < p.Sq && visible(p, p.q_offset + row, kp))
            part[i] = fmaf(expf(s[i][j] - lse_s[ty * 4 + i]), dp[i][j],
                           part[i]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        part[i] += __shfl_xor_sync(0xffffffffu, part[i], off);
      const int64_t row = q0 + ty * 4 + i;
      if (tx == 0) {
        dl_s[ty * 4 + i] = part[i];
        if (row < p.Sq) p.delta[row_base + row] = part[i];
      }
    }
  }

  float acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;

  for (int64_t t = kt_first; t <= kt_last; ++t) {
    const int64_t k0 = t * kBT;
    __syncthreads();  // the previous tile's kt, vt and ds are read
    load_transposed<D>(kt, kg, p.st[kK][2], k0, p.Sk, 1.f);
    load_transposed<D>(vt, vg, p.st[kV][2], k0, p.Sk, 1.f);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    rows_times_cols<D>(s, qs, kt, ty, tx);    // S = (scale Q) K^T
    rows_times_cols<D>(dp, dos, vt, ty, tx);  // dP = dO V^T
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int64_t row = q0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int64_t kp = k0 + tx * 4 + j;
        const bool ok = kp < p.Sk && row < p.Sq &&
                        visible(p, p.q_offset + row, kp);
        const float pr = ok ? expf(s[i][j] - lse_s[ty * 4 + i]) : 0.f;
        s[i][j] = pr * (dp[i][j] - dl_s[ty * 4 + i]);
      }
      *reinterpret_cast<float4*>(ds + (ty * 4 + i) * kTS + tx * 4) =
          make_float4(s[i][0], s[i][1], s[i][2], s[i][3]);
    }
    __syncthreads();
    tile_times_rows<D>(acc, ds, kt, ty, tx);  // dQ += dS K
  }

  T* dqg = static_cast<T*>(p.dq) + b * p.st[kDQ][0] + h * p.st[kDQ][1];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t row = q0 + ty * 4 + i;
    if (row < p.Sq) {
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        store1(dqg + row * p.st[kDQ][2] + tx + 16 * c, acc[i][c] * p.scale);
    }
  }
}

template <typename T, int D>
int launch_d(const BwdParams& p, int64_t B, int64_t Hkv,
             cudaStream_t stream) {
  const int smem =
      (2 * kBT * D + 2 * D * kTS + kBT * kTS + 2 * kBT) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        flash_bwd_dq<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
  if (err != cudaSuccess) return (int)err;
  // dq first: for bf16 it also writes the delta that dK/dV reads
  const dim3 gq((unsigned)p.n_qtiles, (unsigned)p.Hq, (unsigned)B);
  flash_bwd_dq<T, D><<<gq, kThreads, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 gkv((unsigned)((p.Sk + kBT - 1) / kBT), (unsigned)Hkv,
                 (unsigned)B);
  flash_bwd_dkdv<T, D><<<gkv, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_t(const BwdParams& p, int64_t B, int64_t Hq, int64_t Hkv,
             cudaStream_t s) {
  if constexpr (sizeof(T) == 4) {  // fp32: delta from o
    const int rows_per_block = kThreads / 32;
    const dim3 gd((unsigned)((p.Sq + rows_per_block - 1) / rows_per_block),
                  (unsigned)Hq, (unsigned)B);
    flash_bwd_delta<<<gd, kThreads, 0, s>>>(p);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  switch (p.D) {
    case 32: return launch_d<T, 32>(p, B, Hkv, s);
    case 64: return launch_d<T, 64>(p, B, Hkv, s);
    case 80: return launch_d<T, 80>(p, B, Hkv, s);
    case 128: return launch_d<T, 128>(p, B, Hkv, s);
    case 192: return launch_d<T, 192>(p, B, Hkv, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, the type of q, k, v, o, dout and of
// dq, dk and dv (each rounded once from its fp32 accumulator); lse and
// delta are fp32 either way.  strides: 24 element strides, (batch, head, seq) of q, k, v,
// o, dout, dq, dk and dv in that order; the last axis of each is
// contiguous and every other stride and base is 4-element aligned.  lse
// and delta are contiguous (B, Hq, Sq) fp32: lse from the forward
// (flash_attention_fwd's lse output), delta scratch that this call
// writes.  window <= 0 means none.  Every query row must see at least one
// key.  Returns 0 on success or a CUDA runtime error code.  The caller
// handles Sq == 0 and Sk == 0 without a launch.
extern "C" int flash_attention_bwd(int dtype, int D, const void* q,
                                   const void* k, const void* v,
                                   const void* o, const void* dout,
                                   const float* lse, float* delta, void* dq,
                                   void* dk, void* dv,
                                   const int64_t* strides,
                                   int64_t B, int64_t Hq, int64_t Hkv,
                                   int64_t Sq, int64_t Sk, int64_t q_offset,
                                   int64_t window, int causal, float scale,
                                   void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Sq <= 0 || Sk <= 0 || Hq % Hkv ||
      B > 65535 || Hq > 65535 || Sq > 0x7fffffffLL || Sk > 0x7fffffffLL ||
      (D != 32 && D != 64 && D != 80 && D != 128 && D != 192))
    return (int)cudaErrorInvalidValue;
  BwdParams p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.dout = dout;
  p.lse = lse;
  p.delta = delta;
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  for (int i = 0; i < 8; ++i)
    for (int j = 0; j < 3; ++j) p.st[i][j] = strides[i * 3 + j];
  p.Hq = Hq;
  p.Sq = Sq;
  p.Sk = Sk;
  p.q_offset = q_offset;
  p.window = window;
  p.D = D;
  p.group = (int)(Hq / Hkv);
  p.causal = causal;
  p.n_qtiles = (int)((Sq + kBT - 1) / kBT);
  p.scale = scale;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return launch_t<float>(p, B, Hq, Hkv, s);
  if (dtype == 1) return launch_t<__nv_bfloat16>(p, B, Hq, Hkv, s);
  return (int)cudaErrorInvalidValue;
}
