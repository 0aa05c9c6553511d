/*
 * flash_attention_bwd — the gradient of fp32 and bf16 flash attention for
 * Hopper (sm_90a).
 *
 *     S = scale * Q K^T (masked),  P = exp(S - lse),  O = P V
 *     dV = P^T dO,  dP = dO V^T,  dS = P o (dP - delta),
 *     dQ = scale * dS K,  dK = scale * dS^T Q,
 *     delta[i] = sum_d dO[i, d] * O[i, d] = sum_j P[i, j] dP[i, j]
 *
 *     q, o, dO, dq: (B, Hq, Sq, D); k, v, dk, dv: (B, Hkv, Sk, D), each a
 *     strided view whose last axis is contiguous; lse and delta: (B, Hq,
 *     Sq) fp32, contiguous; G = Hq / Hkv; D in {32, 64, 80, 128, 192};
 *     q, k, v, o, dO, dq, dk and dv all fp32 or all bf16.
 *
 * The gradient of the TPU kernel repro/kernels/flash_attention/kernel.py:69
 * flash_attention_pallas, which has no backward: the JAX package trains
 * through plain JAX attention (repro/models/transformer.py, attn_impl
 * "chunked") and autodiff.  The port's model runs the hand-written
 * forward (csrc/flash_attention.cu: flash_fwd_simt for fp32,
 * flash_fwd_wgmma for bf16, both writing lse, each row's log-sum-exp of
 * the scaled, masked scores in natural-log units), so its gradient comes
 * from here: what autodiff of repro_torch's attention_ref computes in
 * fp32 for the same inputs, each gradient rounded to the input dtype once.
 *
 * Masks work on absolute positions qp = q_offset + i and kp, as the
 * forward's: causal keeps kp <= qp, a window W keeps kp > qp - W; a
 * masked pair, a key past Sk and a query row past Sq have P = 0.  The
 * plain version gives a row that sees no key the mean of V over every
 * key; these kernels do not: the wrapper refuses such calls (they do not
 * occur in training, where every row sees at least its own key).  Every
 * sum runs in an order fixed by the shapes and there are no atomics, so
 * two launches give bit-identical gradients.
 *
 * Three variants, chosen by the wrapper (kernel.py, flash_attention_bwd_cuda):
 *
 * SIMT (only where asked for by name, "simt" on fp32 and "simt_bf16" on
 * bf16, the yardsticks of the tensor-core variants).  Three kernels for
 * fp32, two for bf16:
 *   flash_bwd_delta (fp32 only): delta = rowsum(dO o), one warp a row.
 *   flash_bwd_dq<T, D>: one block of 256 threads owns one (batch, query
 *   head, 64-row query tile) and walks the key tiles the forward walks,
 *   K and V transposed in shared memory, the scaled Q tile and the dO
 *   tile as rows: S and dP (4 rows x 4 keys a thread), dS into shared
 *   memory, dQ += dS K (4 rows x D/16 columns a thread).  For bf16 a
 *   first walk over the same tiles forms delta = rowsum(P dP) and writes
 *   it for the dk/dv kernel, which therefore runs after this one.
 *   flash_bwd_dkdv<T, D>: one block owns one (batch, kv head, 64-key
 *   tile), keeps K and V in shared memory and walks the G query heads of
 *   its group and their query tiles that see its keys: P^T from S^T, dV
 *   += P^T dO, dP^T, dS^T, dK += dS^T (scale Q); dK and dV stay in
 *   registers for the whole walk (4 keys x D/16 columns a thread).
 *   bf16 values are widened to fp32 as they load (exact); every product
 *   is fp32 SIMT FMAs.  Shared memory: four D x 64 tiles and a 64 x 68
 *   one, 220,672 bytes at D 192.
 *
 * flash_bwd_wgmma (bf16, "wgmma_bf16", every bf16 training path): the
 * products on the tensor cores, wgmma.mma_async m64nNk16 bf16 -> fp32,
 * tiles by TMA (csrc/wgmma.cuh, shared with the forward), 384 threads a
 * block: warpgroup 2 the producer (setmaxnreg 24; one thread issues every
 * copy into a ring of 3 stages with full and empty mbarriers), warpgroups
 * 0 and 1 the consumers (setmaxnreg 240).
 *   flash_bwd_wgmma_dq<D>: a block owns one (batch, query head, 128-row
 *   query tile), longest first; a consumer 64 rows.  The Q and dO tiles
 *   come once, the forward's K and V tiles twice.  Walk 1: S = Q K^T and
 *   dP = dO V^T (SS, from shared memory), P = exp2(S scale log2 e - lse
 *   log2 e), delta = rowsum(P dP), written for dk/dv.  Walk 2: S and dP
 *   of tile n and dQ += dS_{n-1} K_{n-1} (RS: dS from registers, where
 *   the accumulator layout of S is the A-operand layout) go to the tensor
 *   cores together, and dS_n = P (dP - delta) is formed while the latter
 *   runs.  dq = scale dQ, rounded once.
 *   flash_bwd_wgmma_dkdv<D>: a block owns one (batch, kv head, 64-key
 *   tile), K and V resident, and streams the Q and dO tiles (64 rows) of
 *   every query head of the group that can see its keys.  At D <= 128
 *   consumer w takes queries 32w..32w+31 of each tile: S^T = K Q^T and
 *   dP^T = V dO^T (SS, N 32), P^T and dS^T, dV += P^T dO and dK += dS^T Q
 *   (RS), both 64 x D accumulators in its registers; warpgroup 1 hands
 *   its sums to warpgroup 0 through shared memory at the end, which adds
 *   them, its own first.  At D 192, where two 64 x 192 accumulators do
 *   not fit one warpgroup's registers, consumer 0 forms dV and consumer
 *   1 dK over tiles of 32 queries, each forming S^T and dP^T (the role
 *   is data, not a branch: ptxas serialises wgmma across such a branch).
 *   GQA at small batch: where G > 1 and B Hkv ceil(Sk / 64) < 264 (two
 *   waves of 132 SMs), a block owns one query head instead of the whole
 *   group and writes fp32 dK and dV of that head to a workspace, which
 *   the wrapper sums over the group (torch.sum, a fixed order) and
 *   rounds once.  Otherwise the block sums the group in its registers.
 *   Head dims: D in boxes of 64 bf16 columns (TMA zero-fills past D);
 *   the products over D take ceil(D / 16) k-steps, the products over keys
 *   or queries N = D padded to whole boxes, but 80 at D 80.
 *   Numerics: P and dS go to the tensor cores as two bf16 terms, hi =
 *   bf16(x) and lo = bf16(x - hi), hi + lo within 2^-17 of x.  One term
 *   fails the bf16 gate by 6e-4 to 1.8e-3 of max |g| (a float64 mirror
 *   of these rounding points on the CPU, ref.py's
 *   attention_bwd_wgmma_mirror; the gate's own-max part is 1e-3); two
 *   pass it with 1e-6 of max |g| to spare.  delta cannot come from o:
 *   the forward keeps o in bf16 only, and dO . bf16(o) moved dq and dk by
 *   ~2e-3 of their max |g| (float64 mirror, zamba2's training shape), 20x
 *   the gate; so delta = sum_j P_ij dP_ij from walk 1, the same number for
 *   the exact o.
 *
 * flash_bwd_f32 (fp32, "wgmma_f32", every fp32 training path): the same
 * tensor-core design on fp32 inputs, every factor of every product in
 * three bf16 terms, t0 = bf16(x), t1 = bf16(x - t0), t2 = bf16(x - t0 -
 * t1), and the term products with i + j <= 2 (six a product) summed into
 * the fp32 accumulators.
 *   flash_bwd_split3: q, k, v and dO into three bf16 planes each, a
 *   workspace of 6 bytes an element that the wrapper allocates, read by
 *   TMA as (3 B, H, S, D) tensors; P and dS are split in registers.
 *   flash_bwd_f32_dq<D>: as flash_bwd_wgmma_dq, but walk 1 also takes
 *   each row's l = sum_j e and u = sum_j e dP of e = exp(S scale - lse),
 *   and writes r = 1 / l and delta = u r; walk 2 and dk/dv use P = e r.
 *   The forward's lse comes from the SIMT forward's own fp32 scores, so
 *   exp(S - lse) of these scores does not sum to 1 to fp32 accuracy, and
 *   delta = dO . o would not match their P: in a float64 mirror
 *   (ref.py's attention_bwd_f32_mirror) that put dq up to 2.4x as far
 *   from float64 as the plain fp32 attention.  Each tile's products run
 *   one after another (S and dP, then dQ += dS K), with no overlap
 *   inside a warpgroup: three stages of three terms do not fit.
 *   flash_bwd_f32_dkdv<D>: as flash_bwd_wgmma_dkdv, P^T = e r; a GQA
 *   group a block unless that gives under one wave of blocks (the
 *   wrapper's per_head_blocks).
 *   Tiles in three terms are three times the bf16 ones: at D <= 64 dq
 *   keeps 128 query rows (two consumer warpgroups) and streams 64 keys
 *   in 2 stages, dk/dv streams 64 queries in 3; above D 64 dq keeps 64
 *   rows (one consumer), both stream 32 rows, 2 stages at D 80 and 128
 *   and 1 at D 192 (about 217 KB a block); dk/dv splits the roles above
 *   D 64 as the bf16 kernel does at 192.  exp is expf, 1 / l rcp.approx
 *   with a Newton step.
 *   Numerics: the tensor cores truncate each wgmma's fp32 sum, so no
 *   accumulator runs through more than one tile (wgmma_ss3, below): with
 *   dQ, dK and dV each chained through one accumulator they lay 2.3-5.9x
 *   as far from float64 as plain fp32 on an H100, growing with S; with a
 *   partial a tile 0.11-0.74x (chip_smoke.py's flash_f64_distances).  In
 *   the float64 mirror, which models that truncation, two bf16 terms put
 *   dq, dk or dv 7-60x as far from float64 as plain fp32 and three
 *   0.2-1.1x: three it is.  3xTF32 would need Q, K and dO transposed in
 *   shared memory (wgmma takes tf32 only K-major).
 *
 * What bounds it.  The five products over the visible (query, key)
 * pairs are 10 * pairs * D flops; in bf16 at 989 TFLOP/s the Qwen2-7B
 * heads (B 1, Hq 28 / Hkv 4, S 2048, D 128, causal) are bound at 76.0 us
 * by operations against 15.7 us for their bytes at 3.35 TB/s, Danube's
 * (B 1, 32 / 8, S 6144, D 80, window 4096) at 434 us; zamba2-1.2b's
 * training shape (B 32, 32 / 32, S 128, D 64) is bound by its 118 MB of
 * bytes, 35.2 us (chip_smoke.py computes each from its inputs).  In
 * fp32 the counted work reads against the 67 TFLOP/s of fp32 FMAs (1.924
 * ms at 100m S 2048, 1.29e11 flops), and its tensor-core floor is 989 /
 * 6 = 165 TFLOP/s of fp32-accurate products (0.78 ms there), which is
 * the fp32 variant's bound: it reads q, k, v, dO and lse and writes dq,
 * dk and dv, and reads no o (the SIMT kernels do, for delta).  The fp32
 * variant does 9 products of the tile where the count has 5 (S and dP
 * in both walks of dq and again in dk/dv), six term products each.  The
 * wgmma variant does about 2.4x the counted work (S and dP formed in
 * both walks of dq and again in dk/dv; dQ, dK and dV in two terms).
 * What the SIMT bf16 variant lost to, and what this design does about
 * it: (1) no tensor cores, every product SIMT FMAs on values widened in
 * shared memory: here every product is wgmma, and tiles arrive by TMA
 * while the previous tile computes; (2) GQA at small batch ran a
 * group's heads one after another in a block of (kv head, key tile),
 * 128 blocks at Qwen2's heads: here a block takes one head and the group
 * is summed after.  tools/flash_bwd_probe.py reads cycles by phase:
 * forming P and dS in registers (exp2 on the SFU, the masks, the split
 * into bf16 terms) takes about as long as the tensor-core work of a
 * tile, and at zamba2's shape each block's few tiles are latency (one
 * block an SM: 384 threads at 168 registers).
 *
 * Lines "// @probe <name>" mark where tools/flash_bwd_probe.py inserts
 * clock reads, or drops the low term, in a copy of this source (the
 * "f32-" ones in the fp32 kernels, read with --fp32); they are comments
 * and compile to nothing.
 */
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

using namespace hopper;

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

// ---------------------------------------------------------------------------
// flash_bwd_wgmma: bf16 inputs on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kWgThreads = 384;  // consumer warpgroups 0, 1; producer 2
constexpr float kLog2e = 1.4426950408889634f;

struct WgParams {
  const float* lse;              // (B, Hq, Sq), the forward's
  float* delta;                  // (B, Hq, Sq): dq writes, dk/dv reads
  void* dq;                      // bf16, strided
  void* dk;                      // bf16, strided (whole groups)
  void* dv;
  float* dk_part;                // (B, Hq, Sk, D) fp32 (one head a block)
  float* dv_part;
  int64_t sdq[3], sdk[3], sdv[3];  // element strides (batch, head, seq)
  int64_t Hq, Sq, Sk, q_offset;
  int64_t window;                // <= 0: no window
  int group;                     // Hq / Hkv
  int causal;
  int per_head;                  // dk/dv blocks own one query head each
  float scale;
  // the fp32 variant only: each row's 1 / sum_j P_ij (dq writes, dk/dv
  // reads) and B (the term planes are (3 B, H, S, D))
  float* rinv;
  int64_t batch;
};

// Tile sizes of both kernels at head dim D: D in boxes of 64 bf16
// columns (zero-filled past D by TMA), KS k-steps of 16 over D (the zero
// columns past D are not multiplied), 64 keys (dq) or 64 queries (dk/dv)
// a streamed tile, 32 at D 192 where the 64 x 192 accumulator takes 96
// registers a thread
template <int D>
struct Bw {
  static constexpr int NB = (D + kBox - 1) / kBox;
  static constexpr int DP = NB * kBox;
  // the N of the products over keys or queries (the accumulators' width):
  // D padded to whole boxes, but 80 itself (m64n80k16: 40% less work
  // than 128)
  static constexpr int NR = D == 80 ? 80 : DP;
  static constexpr int KS = (D + 15) / 16;
  static constexpr int BT = NB == 3 ? 32 : 64;   // rows of a streamed tile
  static constexpr int STAGES = 3;
  static constexpr int ROW_BOX = 128 * 128;      // a 128-row box (dq's Q, dO)
  static constexpr int KEY_BOX = 64 * 128;       // a 64-row box (dk/dv's K, V)
  static constexpr int T_BOX = BT * 128;         // a streamed box
  static constexpr int T_BYTES = NB * T_BOX;     // one streamed tile
  static constexpr int STAGE_BYTES = 2 * T_BYTES;
  static constexpr int SMEM_DQ =
      1024 + 2 * NB * ROW_BOX + STAGES * STAGE_BYTES + 8 * (2 * STAGES + 1);
  static constexpr int SMEM_DKDV =
      1024 + 2 * NB * KEY_BOX + STAGES * STAGE_BYTES + 8 * (2 * STAGES + 1);
};

// acc = A B^T over D, A (64 rows) and B (N rows) K-major in 64-column
// boxes a_box and b_box bytes apart, KS k-steps of 16 columns, four in a
// box; issued, not committed
template <int N, int KS>
__device__ __forceinline__ void issue_ss(float (&acc)[N / 2], uint32_t a_addr,
                                         int a_box, uint32_t b_addr,
                                         int b_box) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const uint32_t off = (kk & 3) * 32;
    mma_ss<N>(acc, desc_sw128(a_addr + (kk >> 2) * a_box + off, 16, 1024),
              desc_sw128(b_addr + (kk >> 2) * b_box + off, 16, 1024), kk > 0);
  }
}

// acc += (hi + lo) B, the A operand from registers in its two bf16 terms
// (K columns), B (K rows x N) MN-major, its 64-column boxes b_box bytes
// apart; issued, not committed
template <int K, int N>
__device__ __forceinline__ void issue_rs(float (&acc)[N / 2],
                                         const uint32_t (&hi)[K / 16][4],
                                         const uint32_t (&lo)[K / 16][4],
                                         uint32_t b_addr, int b_box) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    const uint64_t db = desc_sw128(b_addr + kk * 16 * 128, b_box, 1024);
    mma_rs<N>(acc, hi[kk], db);
    // @probe lo-term (the next line)
    mma_rs<N>(acc, lo[kk], db);
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) r[i] = 0.f;
}

// bar.sync on barrier id among count threads (the consumer warpgroups)
__device__ __forceinline__ void named_barrier(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(count) : "memory");
}

// The columns lo..hi of a tile of n that one of a thread's rows sees
// (none where lo > hi), found once a tile in 64 bits so that the test of
// each element is two 32-bit compares.  key_cols: the keys k0 + c that
// query position qp sees (causal c <= qp - k0, a window c > qp - W - k0,
// and c < Sk - k0); query_cols: the queries qlo + c that see key kp.
struct Cols {
  int lo, hi;
};

__device__ __forceinline__ Cols key_cols(const WgParams& p, int64_t qp,
                                         int64_t k0, int n) {
  int64_t hi = min64(n - 1, p.Sk - 1 - k0);
  if (p.causal) hi = min64(hi, qp - k0);
  const int64_t lo = p.window > 0 ? max64(0, qp - p.window + 1 - k0) : 0;
  return {(int)min64(lo, n), (int)max64(hi, -1)};
}

__device__ __forceinline__ Cols query_cols(const WgParams& p, int64_t kp,
                                           int64_t qlo, int n) {
  const int64_t lo = p.causal ? max64(0, kp - qlo) : 0;
  const int64_t hi =
      p.window > 0 ? min64(n - 1, kp + p.window - 1 - qlo) : n - 1;
  return {(int)min64(lo, n), (int)max64(hi, -1)};
}

// The dq kernel.  One block of 384 threads owns one (batch, query head,
// 128-row query tile), longest first; warpgroup w < 2 owns rows 64w..64w+63
// and warpgroup 2 is the producer (one thread issues every TMA copy: Q
// and dO once, then the forward's K and V tiles twice, through a ring of
// STAGES).  Walk 1: delta = rowsum(P o dP) from S and dP (SS).  Walk 2:
// S and dP of tile n and dQ += dS_{n-1} K_{n-1} (RS, dS as hi + lo) go to
// the tensor cores together; dS_n is formed while the latter runs.
template <int D>
__global__ void __maxnreg__(168)
flash_bwd_wgmma_dq(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   const __grid_constant__ CUtensorMap tdo,
                   const WgParams p) {
  using W = Bw<D>;
  constexpr int BK = W::BT;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* qs = smem;                              // [NB][128][128 B]
  uint8_t* dos = qs + W::NB * W::ROW_BOX;          // [NB][128][128 B]
  uint8_t* kvs = dos + W::NB * W::ROW_BOX;         // [STAGES][K, V][NB][BK][128 B]
  uint64_t* full = reinterpret_cast<uint64_t*>(
      kvs + W::STAGES * W::STAGE_BYTES);
  uint64_t* empty = full + W::STAGES;
  uint64_t* qbar = empty + W::STAGES;

  const int tid = threadIdx.x;
  const int64_t h = blockIdx.x;
  const int64_t q0 = ((int64_t)gridDim.y - 1 - blockIdx.y) * 128;
  const int64_t b = blockIdx.z;
  const int64_t hk = h / p.group;

  // the forward's key tiles (the wrapper refuses rows that see no key)
  const int64_t qlo = p.q_offset + q0;
  const int64_t qhi = qlo + min64(128, p.Sq - q0) - 1;
  int64_t kt_first = 0;
  int64_t kt_last = (p.Sk - 1) / BK;
  if (p.window > 0) kt_first = max64(0, qlo - p.window + 1) / BK;
  if (p.causal) kt_last = min64(p.Sk - 1, qhi) / BK;
  const int n_tiles = (int)(kt_last - kt_first + 1);

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < W::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // from lane 0, so that ptxas knows it uniform across the warp
  const int wgi = __shfl_sync(0xffffffffu, tid / 128, 0);
  if (wgi == 2) {
    // ---------------- producer warpgroup ----------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (tid == 2 * 128) {
      const int cb = (int)b, ch = (int)h, chk = (int)hk;
      mbar_expect_tx(qbar, 2 * W::NB * W::ROW_BOX);
#pragma unroll
      for (int x = 0; x < W::NB; ++x) {
        tma_load(qs + x * W::ROW_BOX, &tq, qbar, x * kBox, (int)q0, ch, cb);
        tma_load(dos + x * W::ROW_BOX, &tdo, qbar, x * kBox, (int)q0, ch,
                 cb);
      }
      for (int i = 0; i < 2 * n_tiles; ++i) {
        const int s = i % W::STAGES;
        mbar_wait(&empty[s], ((i / W::STAGES) & 1) ^ 1);
        mbar_expect_tx(&full[s], W::STAGE_BYTES);
        const int k0 = (int)((kt_first + i % n_tiles) * BK);
        uint8_t* ks = kvs + s * W::STAGE_BYTES;
#pragma unroll
        for (int x = 0; x < W::NB; ++x) {
          tma_load(ks + x * W::T_BOX, &tk, &full[s], x * kBox, k0, chk, cb);
          tma_load(ks + W::T_BYTES + x * W::T_BOX, &tv, &full[s], x * kBox,
                   k0, chk, cb);
        }
      }
    }
    return;
  }
  // ---------------- consumer warpgroups ----------------
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  // @probe dq-start
  const int t = tid & 127;
  const int qd = t & 3;
  const int r = wgi * 64 + (t >> 5) * 16 + ((t & 31) >> 2);  // rows r, r+8
  const float sl2 = p.scale * kLog2e;
  const int64_t row_base = (b * p.Hq + h) * p.Sq;
  int64_t qp[2];
  float lse2[2];   // log2 units; +inf past Sq, where P is then 0
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int64_t row = q0 + r + 8 * hh;
    qp[hh] = p.q_offset + row;
    lse2[hh] = row < p.Sq ? p.lse[row_base + row] * kLog2e : INFINITY;
  }
  const uint32_t q_addr = smem_u32(qs) + wgi * 64 * 128;
  const uint32_t do_addr = smem_u32(dos) + wgi * 64 * 128;
  auto edge_tile = [&](int64_t k0) {
    return k0 + BK > p.Sk || (p.causal && k0 + BK - 1 > qlo) ||
           (p.window > 0 && k0 <= qhi - p.window);
  };
  // sc = P of the tile at key k0, from S in sc; masked only on a tile
  // that crosses the diagonal, the window's edge or Sk
  auto probabilities = [&](float (&sc)[BK / 2], int64_t k0) {
    if (edge_tile(k0)) {
      const Cols cols[2] = {key_cols(p, qp[0], k0, BK),
                            key_cols(p, qp[1], k0, BK)};
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = sc[4 * j + 2 * hh + e];
            const int col = 8 * j + 2 * qd + e;
            x = col < cols[hh].lo || col > cols[hh].hi
                    ? 0.f : fast_exp2(fmaf(x, sl2, -lse2[hh]));
          }
    } else {
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = sc[4 * j + 2 * hh + e];
            x = fast_exp2(fmaf(x, sl2, -lse2[hh]));
          }
    }
  };
  float sc[BK / 2], dp[BK / 2];

  mbar_wait(qbar, 0);
  // @probe dq-loaded
  // walk 1: delta[i] = sum_j P_ij dP_ij
  float part[2] = {0.f, 0.f};
  for (int n = 0; n < n_tiles; ++n) {
    const int s = n % W::STAGES;
    const uint32_t k_addr = smem_u32(kvs + s * W::STAGE_BYTES);
    mbar_wait(&full[s], (n / W::STAGES) & 1);
    zero(sc);
    zero(dp);
    fence_regs(sc);
    fence_regs(dp);
    wgmma_fence();
    issue_ss<BK, W::KS>(sc, q_addr, W::ROW_BOX, k_addr, W::T_BOX);
    issue_ss<BK, W::KS>(dp, do_addr, W::ROW_BOX, k_addr + W::T_BYTES,
                        W::T_BOX);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    fence_regs(dp);
    if (t == 0) mbar_arrive(&empty[s]);
    probabilities(sc, (kt_first + n) * BK);
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          part[hh] = fmaf(sc[4 * j + 2 * hh + e], dp[4 * j + 2 * hh + e],
                          part[hh]);
  }
  float delta[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float d = part[hh];
    d += __shfl_xor_sync(0xffffffffu, d, 1);
    d += __shfl_xor_sync(0xffffffffu, d, 2);
    delta[hh] = d;
    const int64_t row = q0 + r + 8 * hh;
    if (qd == 0 && row < p.Sq) p.delta[row_base + row] = d;
  }
  // @probe dq-walk1

  // walk 2: dQ += dS K, dS = P o (dP - delta)
  float acc[W::NR / 2];
  zero(acc);
  uint32_t hi[BK / 16][4], lo[BK / 16][4];
  for (int n = 0; n < n_tiles; ++n) {
    const int i = n_tiles + n;
    const int s = i % W::STAGES;
    const uint32_t k_addr = smem_u32(kvs + s * W::STAGE_BYTES);
    const int sp = (i - 1) % W::STAGES;
    mbar_wait(&full[s], (i / W::STAGES) & 1);
    zero(sc);
    zero(dp);
    fence_regs(sc);
    fence_regs(dp);
    fence_regs(acc);
    wgmma_fence();
    issue_ss<BK, W::KS>(sc, q_addr, W::ROW_BOX, k_addr, W::T_BOX);
    issue_ss<BK, W::KS>(dp, do_addr, W::ROW_BOX, k_addr + W::T_BYTES,
                        W::T_BOX);
    wgmma_commit();
    if (n > 0) {
      issue_rs<BK, W::NR>(acc, hi, lo, smem_u32(kvs + sp * W::STAGE_BYTES),
                       W::T_BOX);
      wgmma_commit();
      wgmma_wait<1>();                  // S_n and dP_n are done
    } else {
      wgmma_wait<0>();
    }
    fence_regs(sc);
    fence_regs(dp);
    probabilities(sc, (kt_first + n) * BK);
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 4 * j + 2 * hh + e;
          sc[c] = sc[c] * (dp[c] - delta[hh]);
        }
    if (n > 0) {
      wgmma_wait<0>();                  // dQ += dS_{n-1} K_{n-1} is done
      fence_regs(acc);
      if (t == 0) mbar_arrive(&empty[sp]);
    }
    fence_regs(sc);
    pack_p<BK>(sc, hi, lo);
  }
  if (n_tiles > 0) {
    fence_regs(acc);
    wgmma_fence();
    issue_rs<BK, W::NR>(
        acc, hi, lo,
        smem_u32(kvs + ((2 * n_tiles - 1) % W::STAGES) * W::STAGE_BYTES),
        W::T_BOX);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
  }
  // @probe dq-walk2

  // dq = scale dQ, rounded once to bf16
  __nv_bfloat16* dqg = static_cast<__nv_bfloat16*>(p.dq) + b * p.sdq[0] +
                       h * p.sdq[1];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int64_t row = q0 + r + 8 * hh;
    if (row < p.Sq) {
      __nv_bfloat16* drow = dqg + row * p.sdq[2] + 2 * qd;
#pragma unroll
      for (int j = 0; j < W::NR / 8; ++j)
        if (8 * j < D)
          *reinterpret_cast<__nv_bfloat162*>(drow + 8 * j) =
              __floats2bfloat162_rn(acc[4 * j + 2 * hh] * p.scale,
                                    acc[4 * j + 2 * hh + 1] * p.scale);
    }
  }
  // @probe dq-end
}

// One consumer warpgroup of flash_bwd_wgmma_dkdv at D 192, where two
// 64 x 192 accumulators do not fit one warpgroup's registers: S^T and
// dP^T (SS) in both, then dk forms dK += dS^T Q, else dV += P^T dO (RS),
// each over the whole tile of 32 queries, its accumulator in registers
// for the whole walk, the product of tile i - 1 running while P^T or
// dS^T of tile i is formed.  The role
// is data (the operand's address, a factor of 0 or 1 on dP^T - delta),
// not a branch: ptxas serialises wgmma on either side of a branch that
// the two roles take apart, which costs more than the dP^T product that
// the dV warpgroup computes for nothing
template <int D>
__device__ __forceinline__ void dkdv_consumer(
    const WgParams& p, uint8_t* ks, uint8_t* vs, uint8_t* qds,
    uint64_t* full, uint64_t* empty, uint64_t* kbar, int64_t k0, int64_t b,
    int64_t hk, int64_t h_first, int64_t t_first, int n_t, int n_iter,
    bool dk) {
  using W = Bw<D>;
  constexpr int BQ = W::BT;
  const int t = threadIdx.x & 127;
  const int qd = t & 3;
  const int r = (t >> 5) * 16 + ((t & 31) >> 2);   // keys k0 + r, + r + 8
  const float sl2 = p.scale * kLog2e;
  const uint32_t k_addr = smem_u32(ks);
  const uint32_t v_addr = smem_u32(vs);
  int64_t kp[2] = {k0 + r, k0 + r + 8};
  // dS^T = P^T (sel (dP^T - delta) + 1 - sel): dS^T for dK, P^T for dV
  const float sel = dk ? 1.f : 0.f;

  float acc[W::NR / 2];                 // dV (warpgroup 0) or dK (1)
  zero(acc);
  float sc[BQ / 2], dp[BQ / 2];
  float lse2[BQ / 4], dl[BQ / 4];    // by column: 2j + e
  uint32_t hi[BQ / 16][4], lo[BQ / 16][4];

  mbar_wait(kbar, 0);
  for (int i = 0; i < n_iter; ++i) {
    const int s = i % W::STAGES;
    const int sp = (i - 1 + W::STAGES) % W::STAGES;
    const int64_t h = h_first + i / n_t;
    const int64_t q0 = (t_first + i % n_t) * BQ;
    const int64_t row_base = (b * p.Hq + h) * p.Sq;
    // this thread's columns (queries q0 + 8j + 2qd + e): lse in log2
    // units, +inf past Sq (P = 0 there), and delta
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int64_t row = q0 + 8 * j + 2 * qd + e;
        const bool in = row < p.Sq;
        lse2[2 * j + e] = in ? p.lse[row_base + row] * kLog2e : INFINITY;
        dl[2 * j + e] = in ? p.delta[row_base + row] : 0.f;
      }
    const uint32_t q_addr = smem_u32(qds + s * W::STAGE_BYTES);
    const uint32_t do_addr = q_addr + W::T_BYTES;
    mbar_wait(&full[s], (i / W::STAGES) & 1);
    zero(sc);
    fence_regs(sc);
    zero(dp);
    fence_regs(dp);
    fence_regs(acc);
    wgmma_fence();
    issue_ss<BQ, W::KS>(sc, k_addr, W::KEY_BOX, q_addr, W::T_BOX);
    issue_ss<BQ, W::KS>(dp, v_addr, W::KEY_BOX, do_addr, W::T_BOX);
    wgmma_commit();
    if (i > 0) {
      // the previous tile's dV += P^T dO or dK += dS^T Q
      const uint32_t prev = smem_u32(qds + sp * W::STAGE_BYTES) +
                            (dk ? 0 : W::T_BYTES);
      issue_rs<BQ, W::NR>(acc, hi, lo, prev, W::T_BOX);
      wgmma_commit();
      wgmma_wait<1>();
    } else {
      wgmma_wait<0>();
    }
    fence_regs(sc);
    fence_regs(dp);
    // P^T, masked on the tiles that cross the diagonal or the window
    const int64_t qlo = p.q_offset + q0;
    const bool edge = (p.causal && k0 + 63 > qlo) ||
                      (p.window > 0 && k0 <= qlo + BQ - 1 - p.window);
    Cols cols[2] = {{0, BQ - 1}, {0, BQ - 1}};
    if (edge)
      for (int hh = 0; hh < 2; ++hh) cols[hh] = query_cols(p, kp[hh], qlo, BQ);
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 4 * j + 2 * hh + e;
          const int col = 8 * j + 2 * qd + e;
          float x = fast_exp2(fmaf(sc[c], sl2, -lse2[2 * j + e]));
          if (col < cols[hh].lo || col > cols[hh].hi) x = 0.f;
          sc[c] = x * fmaf(sel, dp[c] - dl[2 * j + e], 1.f - sel);
        }
    if (i > 0) {
      wgmma_wait<0>();
      fence_regs(acc);
      if (t == 0) mbar_arrive(&empty[sp]);
    }
    fence_regs(sc);
    pack_p<BQ>(sc, hi, lo);
  }
  if (n_iter > 0) {
    fence_regs(acc);
    wgmma_fence();
    const uint32_t last = smem_u32(qds + ((n_iter - 1) % W::STAGES) *
                                             W::STAGE_BYTES) +
                          (dk ? 0 : W::T_BYTES);
    issue_rs<BQ, W::NR>(acc, hi, lo, last, W::T_BOX);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
  }

  // dK = scale dS^T Q, dV = P^T dO: the whole group's, rounded once to
  // bf16, or this query head's in fp32 for the wrapper's sum
  const float f = dk ? p.scale : 1.f;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    if (kp[hh] >= p.Sk) continue;
    if (p.per_head) {
      float* prow = (dk ? p.dk_part : p.dv_part) +
                    ((b * p.Hq + h_first) * p.Sk + kp[hh]) * D + 2 * qd;
#pragma unroll
      for (int j = 0; j < W::NR / 8; ++j)
        if (8 * j < D)
          *reinterpret_cast<float2*>(prow + 8 * j) =
              make_float2(acc[4 * j + 2 * hh] * f,
                          acc[4 * j + 2 * hh + 1] * f);
    } else {
      const int64_t s0 = dk ? p.sdk[0] : p.sdv[0];
      const int64_t s1 = dk ? p.sdk[1] : p.sdv[1];
      const int64_t s2 = dk ? p.sdk[2] : p.sdv[2];
      __nv_bfloat16* grow = static_cast<__nv_bfloat16*>(dk ? p.dk : p.dv) +
                            b * s0 + hk * s1 + kp[hh] * s2 + 2 * qd;
#pragma unroll
      for (int j = 0; j < W::NR / 8; ++j)
        if (8 * j < D)
          *reinterpret_cast<__nv_bfloat162*>(grow + 8 * j) =
              __floats2bfloat162_rn(acc[4 * j + 2 * hh] * f,
                                    acc[4 * j + 2 * hh + 1] * f);
    }
  }
}

// One consumer warpgroup w of flash_bwd_wgmma_dkdv at D <= 128: it owns
// queries 32w..32w+31 of every streamed tile of 64 and forms S^T and dP^T
// over them (SS, N 32), P^T and dS^T, then dV += P^T dO and dK += dS^T Q
// (RS, K 32), each 64 x D accumulator in its registers; the products of
// tile i - 1 run while P^T and dS^T of tile i are formed.  At the end
// warpgroup 1 hands its dK and dV to warpgroup 0 through shared memory
// (the stages, no longer read), which adds them, its own first, and
// stores.  No S^T or P^T is formed twice.
template <int D>
__device__ __forceinline__ void dkdv_consumer_split(
    const WgParams& p, uint8_t* ks, uint8_t* vs, uint8_t* qds,
    uint64_t* full, uint64_t* empty, uint64_t* kbar, int64_t k0, int64_t b,
    int64_t hk, int64_t h_first, int64_t t_first, int n_t, int n_iter,
    int wgi) {
  using W = Bw<D>;
  constexpr int BQ = W::BT;
  constexpr int BH = BQ / 2;          // queries of a warpgroup
  constexpr int NR = W::NR;
  static_assert(BQ == 64, "the split walk takes streamed tiles of 64");
  const int t = threadIdx.x & 127;
  const int qd = t & 3;
  const int r = (t >> 5) * 16 + ((t & 31) >> 2);   // keys k0 + r, + r + 8
  const float sl2 = p.scale * kLog2e;
  const uint32_t k_addr = smem_u32(ks);
  const uint32_t v_addr = smem_u32(vs);
  const int64_t kp[2] = {k0 + r, k0 + r + 8};
  const int wq = wgi * BH;             // this warpgroup's first query

  float acc_k[NR / 2], acc_v[NR / 2];
  zero(acc_k);
  zero(acc_v);
  float sc[BH / 2], dp[BH / 2];
  float lse2[BH / 4], dl[BH / 4];      // by column: 2j + e
  uint32_t ph[BH / 16][4], pl[BH / 16][4], sh[BH / 16][4], sl[BH / 16][4];

  // @probe kv-start
  mbar_wait(kbar, 0);
  // @probe kv-loaded
  for (int i = 0; i < n_iter; ++i) {
    const int s = i % W::STAGES;
    const int sp = (i - 1 + W::STAGES) % W::STAGES;
    const int64_t h = h_first + i / n_t;
    const int64_t q0 = (t_first + i % n_t) * BQ;
    const int64_t row_base = (b * p.Hq + h) * p.Sq;
    // this thread's columns, queries q0 + wq + 8j + 2qd + e: lse in log2
    // units, +inf past Sq (P = 0 there), and delta
#pragma unroll
    for (int j = 0; j < BH / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int64_t row = q0 + wq + 8 * j + 2 * qd + e;
        const bool in = row < p.Sq;
        lse2[2 * j + e] = in ? p.lse[row_base + row] * kLog2e : INFINITY;
        dl[2 * j + e] = in ? p.delta[row_base + row] : 0.f;
      }
    const uint32_t q_addr = smem_u32(qds + s * W::STAGE_BYTES) + wq * 128;
    const uint32_t do_addr = q_addr + W::T_BYTES;
    // @probe kv-tile-wait
    mbar_wait(&full[s], (i / W::STAGES) & 1);
    // @probe kv-tile-ready
    zero(sc);
    zero(dp);
    fence_regs(sc);
    fence_regs(dp);
    fence_regs(acc_k);
    fence_regs(acc_v);
    wgmma_fence();
    issue_ss<BH, W::KS>(sc, k_addr, W::KEY_BOX, q_addr, W::T_BOX);
    issue_ss<BH, W::KS>(dp, v_addr, W::KEY_BOX, do_addr, W::T_BOX);
    wgmma_commit();
    if (i > 0) {
      // the previous tile's dV += P^T dO and dK += dS^T Q
      const uint32_t prev = smem_u32(qds + sp * W::STAGE_BYTES) + wq * 128;
      issue_rs<BH, NR>(acc_v, ph, pl, prev + W::T_BYTES, W::T_BOX);
      issue_rs<BH, NR>(acc_k, sh, sl, prev, W::T_BOX);
      wgmma_commit();
      wgmma_wait<1>();
    } else {
      wgmma_wait<0>();
    }
    // @probe kv-scores
    fence_regs(sc);
    fence_regs(dp);
    // P^T into sc, dS^T into dp; masked on the tiles that cross the
    // diagonal or the window
    const int64_t qlo = p.q_offset + q0;
    const bool edge = (p.causal && k0 + 63 > qlo) ||
                      (p.window > 0 && k0 <= qlo + BQ - 1 - p.window);
    Cols cols[2] = {{0, BQ - 1}, {0, BQ - 1}};
    if (edge)
      for (int hh = 0; hh < 2; ++hh) cols[hh] = query_cols(p, kp[hh], qlo, BQ);
#pragma unroll
    for (int j = 0; j < BH / 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 4 * j + 2 * hh + e;
          const int col = wq + 8 * j + 2 * qd + e;
          float x = fast_exp2(fmaf(sc[c], sl2, -lse2[2 * j + e]));
          if (col < cols[hh].lo || col > cols[hh].hi) x = 0.f;
          sc[c] = x;
          dp[c] = x * (dp[c] - dl[2 * j + e]);
        }
    // @probe kv-rs-wait
    if (i > 0) {
      wgmma_wait<0>();
      fence_regs(acc_k);
      fence_regs(acc_v);
      if (t == 0) mbar_arrive(&empty[sp]);
    }
    // @probe kv-rs-done
    fence_regs(sc);
    fence_regs(dp);
    pack_p<BH>(sc, ph, pl);
    pack_p<BH>(dp, sh, sl);
    // @probe kv-packed
  }
  if (n_iter > 0) {
    fence_regs(acc_k);
    fence_regs(acc_v);
    wgmma_fence();
    const uint32_t last =
        smem_u32(qds + ((n_iter - 1) % W::STAGES) * W::STAGE_BYTES) + wq * 128;
    issue_rs<BH, NR>(acc_v, ph, pl, last + W::T_BYTES, W::T_BOX);
    issue_rs<BH, NR>(acc_k, sh, sl, last, W::T_BOX);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc_k);
    fence_regs(acc_v);
  }
  // @probe kv-loop-end

  // warpgroup 1's sums to warpgroup 0, register by register ([reg][t]:
  // the two warpgroups' accumulator layouts are the same), once both are
  // done reading the stages
  float* xfer = reinterpret_cast<float*>(qds);
  named_barrier(1, 256);
  if (wgi == 1) {
#pragma unroll
    for (int c = 0; c < NR / 2; ++c) {
      xfer[c * 128 + t] = acc_k[c];
      xfer[(NR / 2 + c) * 128 + t] = acc_v[c];
    }
  }
  named_barrier(2, 256);
  if (wgi == 1) return;
#pragma unroll
  for (int c = 0; c < NR / 2; ++c) {
    acc_k[c] += xfer[c * 128 + t];
    acc_v[c] += xfer[(NR / 2 + c) * 128 + t];
  }

  // dK = scale dS^T Q, dV = P^T dO: the whole group's, rounded once to
  // bf16, or this query head's in fp32 for the wrapper's sum
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    if (kp[hh] >= p.Sk) continue;
    if (p.per_head) {
      const int64_t off = ((b * p.Hq + h_first) * p.Sk + kp[hh]) * D + 2 * qd;
#pragma unroll
      for (int j = 0; j < NR / 8; ++j)
        if (8 * j < D) {
          *reinterpret_cast<float2*>(p.dk_part + off + 8 * j) =
              make_float2(acc_k[4 * j + 2 * hh] * p.scale,
                          acc_k[4 * j + 2 * hh + 1] * p.scale);
          *reinterpret_cast<float2*>(p.dv_part + off + 8 * j) =
              make_float2(acc_v[4 * j + 2 * hh], acc_v[4 * j + 2 * hh + 1]);
        }
    } else {
      __nv_bfloat16* krow = static_cast<__nv_bfloat16*>(p.dk) +
                            b * p.sdk[0] + hk * p.sdk[1] +
                            kp[hh] * p.sdk[2] + 2 * qd;
      __nv_bfloat16* vrow = static_cast<__nv_bfloat16*>(p.dv) +
                            b * p.sdv[0] + hk * p.sdv[1] +
                            kp[hh] * p.sdv[2] + 2 * qd;
#pragma unroll
      for (int j = 0; j < NR / 8; ++j)
        if (8 * j < D) {
          *reinterpret_cast<__nv_bfloat162*>(krow + 8 * j) =
              __floats2bfloat162_rn(acc_k[4 * j + 2 * hh] * p.scale,
                                    acc_k[4 * j + 2 * hh + 1] * p.scale);
          *reinterpret_cast<__nv_bfloat162*>(vrow + 8 * j) =
              __floats2bfloat162_rn(acc_v[4 * j + 2 * hh],
                                    acc_v[4 * j + 2 * hh + 1]);
        }
    }
  }
  // @probe kv-end
}

// The dk/dv kernel.  One block of 384 threads owns one (batch, kv head
// or, with per_head, query head, 64-key tile); K and V of the tile stay
// in shared memory, and the Q and dO tiles of every query head of the
// group (or of the one head) that can see these keys stream through a
// ring of STAGES.  The consumers split each tile's queries between
// them (dkdv_consumer_split) or, at D 192, the two gradients
// (dkdv_consumer).  The sums run in an order fixed by the shapes; no two
// blocks write one row.
template <int D>
__global__ void __maxnreg__(168)
flash_bwd_wgmma_dkdv(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ CUtensorMap tdo,
                     const WgParams p) {
  using W = Bw<D>;
  constexpr int BQ = W::BT;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* ks = smem;                              // [NB][64][128 B]
  uint8_t* vs = ks + W::NB * W::KEY_BOX;           // [NB][64][128 B]
  uint8_t* qds = vs + W::NB * W::KEY_BOX;          // [STAGES][Q, dO][NB][BQ][128 B]
  uint64_t* full = reinterpret_cast<uint64_t*>(
      qds + W::STAGES * W::STAGE_BYTES);
  uint64_t* empty = full + W::STAGES;
  uint64_t* kbar = empty + W::STAGES;

  const int tid = threadIdx.x;
  const int64_t k0 = (int64_t)blockIdx.y * 64;     // causal: longest first
  const int64_t b = blockIdx.z;
  const int64_t hk = p.per_head ? blockIdx.x / p.group : blockIdx.x;
  const int64_t h_first = p.per_head ? blockIdx.x : hk * p.group;
  const int n_heads = p.per_head ? 1 : p.group;

  // the query rows that see some key of this tile, in tiles of BQ
  const int64_t k_last = min64(k0 + 64, p.Sk) - 1;
  int64_t i_lo = 0, i_hi = p.Sq - 1;
  if (p.causal) i_lo = max64(i_lo, k0 - p.q_offset);
  if (p.window > 0) i_hi = min64(i_hi, k_last + p.window - 1 - p.q_offset);
  const int64_t t_first = i_lo <= i_hi ? i_lo / BQ : 0;
  const int n_t = i_lo <= i_hi ? (int)(i_hi / BQ - i_lo / BQ + 1) : 0;
  const int n_iter = n_heads * n_t;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < W::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);
    }
    mbar_init(kbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // from lane 0, so that ptxas knows it uniform across the warp
  const int wgi = __shfl_sync(0xffffffffu, tid / 128, 0);
  if (wgi == 2) {
    // ---------------- producer warpgroup ----------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (tid == 2 * 128) {
      const int cb = (int)b, chk = (int)hk;
      mbar_expect_tx(kbar, 2 * W::NB * W::KEY_BOX);
#pragma unroll
      for (int x = 0; x < W::NB; ++x) {
        tma_load(ks + x * W::KEY_BOX, &tk, kbar, x * kBox, (int)k0, chk, cb);
        tma_load(vs + x * W::KEY_BOX, &tv, kbar, x * kBox, (int)k0, chk, cb);
      }
      for (int i = 0; i < n_iter; ++i) {
        const int s = i % W::STAGES;
        mbar_wait(&empty[s], ((i / W::STAGES) & 1) ^ 1);
        mbar_expect_tx(&full[s], W::STAGE_BYTES);
        const int ch = (int)(h_first + i / n_t);
        const int q0 = (int)((t_first + i % n_t) * BQ);
        uint8_t* st = qds + s * W::STAGE_BYTES;
#pragma unroll
        for (int x = 0; x < W::NB; ++x) {
          tma_load(st + x * W::T_BOX, &tq, &full[s], x * kBox, q0, ch, cb);
          tma_load(st + W::T_BYTES + x * W::T_BOX, &tdo, &full[s], x * kBox,
                   q0, ch, cb);
        }
      }
    }
    return;
  }
  // ---------------- consumer warpgroups ----------------
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  if constexpr (D == 192)
    dkdv_consumer<D>(p, ks, vs, qds, full, empty, kbar, k0, b, hk, h_first,
                     t_first, n_t, n_iter, wgi == 1);
  else
    dkdv_consumer_split<D>(p, ks, vs, qds, full, empty, kbar, k0, b, hk,
                           h_first, t_first, n_t, n_iter, wgi);
}

template <int D>
int launch_wgmma_d(const void* q, const void* k, const void* v,
                   const void* dout, const int64_t* st, WgParams p,
                   int64_t B, int64_t Hkv, cudaStream_t stream) {
  using W = Bw<D>;
  // st: (batch, head, seq) of q, k, v, dout
  CUtensorMap mq, mk, mv, mdo;
  auto maps = [&](int q_rows, int k_rows) {
    int err = encode_map(&mq, q, D, p.Sq, p.Hq, B, st[2], st[1], st[0],
                         q_rows);
    if (!err) err = encode_map(&mdo, dout, D, p.Sq, p.Hq, B, st[11], st[10],
                               st[9], q_rows);
    if (!err) err = encode_map(&mk, k, D, p.Sk, Hkv, B, st[5], st[4], st[3],
                               k_rows);
    if (!err) err = encode_map(&mv, v, D, p.Sk, Hkv, B, st[8], st[7], st[6],
                               k_rows);
    return err;
  };
  cudaError_t cerr = cudaFuncSetAttribute(
      flash_bwd_wgmma_dq<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      W::SMEM_DQ);
  if (cerr == cudaSuccess)
    cerr = cudaFuncSetAttribute(flash_bwd_wgmma_dkdv<D>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                W::SMEM_DKDV);
  if (cerr != cudaSuccess) return (int)cerr;
  // dq first: it writes the delta that dk/dv reads
  int err = maps(128, W::BT);
  if (err) return err;
  const dim3 gq((unsigned)p.Hq, (unsigned)((p.Sq + 127) / 128), (unsigned)B);
  flash_bwd_wgmma_dq<D><<<gq, kWgThreads, W::SMEM_DQ, stream>>>(mq, mk, mv,
                                                                 mdo, p);
  cerr = cudaGetLastError();
  if (cerr != cudaSuccess) return (int)cerr;
  err = maps(W::BT, 64);
  if (err) return err;
  const dim3 gkv((unsigned)(p.per_head ? p.Hq : Hkv),
                 (unsigned)((p.Sk + 63) / 64), (unsigned)B);
  flash_bwd_wgmma_dkdv<D><<<gkv, kWgThreads, W::SMEM_DKDV, stream>>>(
      mq, mk, mv, mdo, p);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// flash_bwd_wgmma on fp32 inputs ("wgmma_f32"): every factor in three bf16
// terms
// ---------------------------------------------------------------------------

constexpr int kTerms = 3;

// fp32 q, k, v and dO as three bf16 planes each, t0 = bf16(x), t1 =
// bf16(x - t0), t2 = bf16(x - t0 - t1) (each remainder exact in fp32),
// into (3, B, H, S, D) contiguous buffers that TMA reads as (3 B, H, S,
// D).  Memory-bound (4 bytes an element in, 6 out): a lane takes four
// columns of a row at a time (a float4 in, three 8-byte stores out), the
// warps walk the four tensors' rows
struct SplitParams {
  const float* src[4];           // q, k, v, dout: strided, last axis contiguous
  __nv_bfloat16* dst[4];
  int64_t st[4][3];              // element strides (batch, head, seq)
  int64_t H[4], S[4], rows[4];   // rows = B H S
  int D;
};

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

__global__ void __launch_bounds__(kThreads) flash_bwd_split3(const SplitParams p) {
  // a warp takes 32 / (D / 4) rows at once where that divides (D 32, 64,
  // 128), else one row at a time, a lane a float4 of a row
  const int q4 = p.D / 4;
  const int lane = threadIdx.x & 31;
  const int per = 32 % q4 == 0 ? 32 / q4 : 1;
  const int c0 = per > 1 ? lane % q4 : lane;
  const int64_t warps = (int64_t)gridDim.x * (kThreads / 32) * per;
  const int64_t first = ((int64_t)blockIdx.x * (kThreads / 32) +
                         threadIdx.x / 32) * per + (per > 1 ? lane / q4 : 0);
  for (int x = 0; x < 4; ++x) {
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

// Tiles of the fp32 variant at head dim D.  A tile holds its three terms
// one after another ([term][box][rows][128 B]), so it is three times the
// bf16 variant's: dq keeps 128 query rows (two consumer warpgroups) only
// at D <= 64 and 64 (one) above; the streamed tiles are 64 rows at D <=
// 64 and 32 above, in 3, 2 or 1 stages as 227 KB allows
template <int D>
struct Bf {
  static constexpr int NB = (D + kBox - 1) / kBox;
  static constexpr int NR = D == 80 ? 80 : NB * kBox;
  static constexpr int KS = (D + 15) / 16;
  static constexpr int WG = NB == 1 ? 2 : 1;          // dq's consumers
  static constexpr int ROWS = 64 * WG;                // query rows of a dq block
  static constexpr int BT = NB == 1 ? 64 : 32;        // rows of a streamed tile
  static constexpr int DQ_STAGES = NB == 3 ? 1 : 2;
  static constexpr int KV_STAGES = NB == 1 ? 3 : NB == 2 ? 2 : 1;
  static constexpr int ROW_BOX = ROWS * 128;          // dq's Q, dO
  static constexpr int KEY_BOX = 64 * 128;            // dk/dv's K, V
  static constexpr int T_BOX = BT * 128;              // a streamed box
  static constexpr int ROW_PLANE = NB * ROW_BOX;      // one term of a tile
  static constexpr int KEY_PLANE = NB * KEY_BOX;
  static constexpr int T_PLANE = NB * T_BOX;
  static constexpr int T_BYTES = kTerms * T_PLANE;    // a streamed tile
  static constexpr int STAGE_BYTES = 2 * T_BYTES;
  static constexpr int SMEM_DQ = 1024 + 2 * kTerms * ROW_PLANE +
                                 DQ_STAGES * STAGE_BYTES + 8 * (2 * DQ_STAGES + 1);
  static constexpr int SMEM_DKDV = 1024 + 2 * kTerms * KEY_PLANE +
                                   KV_STAGES * STAGE_BYTES + 8 * (2 * KV_STAGES + 1);
  static_assert(SMEM_DQ <= 232448 && SMEM_DKDV <= 232448, "227 KB a block");
};

// The tensor cores' fp32 sum is not fp32's: a wgmma adds its products to
// the accumulator and truncates, so a sum that runs through hundreds of
// wgmma drifts toward zero (a float64 model of truncation after each
// k-step puts dq, dk and dv 4-19x as far from float64 as plain fp32; an
// H100 read 2.3-5.9x, growing with S, before the next two rules).  So
// (1) the small term products (i + j >= 1, 2^-8 of the main one and
// below) go first, while the accumulator is small, and the main one t0
// t0 last; (2) no accumulator runs through more than one tile: each
// tile's dQ, dK or dV lands in a zeroed partial that is added to the
// gradient's fp32 sum in registers (round to nearest).

// acc = A B^T over D from the terms of both factors (A_i B_j, i + j <= 2,
// the main pair last), into the zeroed accumulator; A and B K-major,
// their boxes a_box / b_box and their term planes a_plane / b_plane
// bytes apart; launched, not committed
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

// acc += the tile's partial dQ, dK or dV (RS), in fp32 registers: part is
// zeroed, the product launched, committed and waited for, then added
template <int K, int N>
__device__ __forceinline__ void add_tile_rs3(float (&acc)[N / 2],
                                             float (&part)[N / 2],
                                             const uint32_t (&a)[kTerms][K / 16][4],
                                             uint32_t b_addr, int b_box,
                                             int b_plane) {
  zero(part);
  fence_regs(part);
  wgmma_fence();
  wgmma_rs3<K, N>(part, a, b_addr, b_box, b_plane);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(part);
#pragma unroll
  for (int c = 0; c < N / 2; ++c) acc[c] += part[c];
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

// 1 / x to within an ulp: rcp.approx and one Newton step, so that no
// division's slow path (a call) sits in a kernel that runs wgmma
__device__ __forceinline__ float recip(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return fmaf(y, fmaf(-x, y, 1.f), y);
}

// The fp32 dq kernel.  One block owns one (batch, query head, ROWS-row
// query tile), longest first: warpgroups w < WG own rows 64w..64w+63 and
// warpgroup WG is the producer (Q and dO once, the K and V tiles twice).
// Walk 1: S = Q K^T and dP = dO V^T (SS), e = exp(S scale - lse) and each
// row's l = sum_j e and u = sum_j e dP, then r = 1 / l and delta = u r,
// written for dk/dv.  Walk 2: S and dP again, P = e r, dS = P (dP -
// delta), dQ += dS K (RS), one tile after another.  dq = scale dQ.
template <int D>
__global__ void __maxnreg__(168)
flash_bwd_f32_dq(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv,
                 const __grid_constant__ CUtensorMap tdo,
                 const WgParams p) {
  using W = Bf<D>;
  constexpr int BK = W::BT;
  constexpr int ST = W::DQ_STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* qs = smem;                              // [3][NB][ROWS][128 B]
  uint8_t* dos = qs + kTerms * W::ROW_PLANE;       // [3][NB][ROWS][128 B]
  uint8_t* kvs = dos + kTerms * W::ROW_PLANE;      // [ST][K, V][3][NB][BK][128 B]
  uint64_t* full = reinterpret_cast<uint64_t*>(kvs + ST * W::STAGE_BYTES);
  uint64_t* empty = full + ST;
  uint64_t* qbar = empty + ST;

  const int tid = threadIdx.x;
  const int64_t h = blockIdx.x;
  const int64_t q0 = ((int64_t)gridDim.y - 1 - blockIdx.y) * W::ROWS;
  const int64_t b = blockIdx.z;
  const int64_t hk = h / p.group;

  const int64_t qlo = p.q_offset + q0;
  const int64_t qhi = qlo + min64(W::ROWS, p.Sq - q0) - 1;
  int64_t kt_first = 0;
  int64_t kt_last = (p.Sk - 1) / BK;
  if (p.window > 0) kt_first = max64(0, qlo - p.window + 1) / BK;
  if (p.causal) kt_last = min64(p.Sk - 1, qhi) / BK;
  const int n_tiles = (int)(kt_last - kt_first + 1);

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], W::WG);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wgi = __shfl_sync(0xffffffffu, tid / 128, 0);
  if (wgi == W::WG) {
    // ---------------- producer warpgroup ----------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (tid == W::WG * 128) {
      const int cb = (int)b, ch = (int)h, chk = (int)hk, nb = (int)p.batch;
      mbar_expect_tx(qbar, 2 * kTerms * W::ROW_PLANE);
#pragma unroll
      for (int u = 0; u < kTerms; ++u)
#pragma unroll
        for (int x = 0; x < W::NB; ++x) {
          const int off = u * W::ROW_PLANE + x * W::ROW_BOX;
          tma_load(qs + off, &tq, qbar, x * kBox, (int)q0, ch, u * nb + cb);
          tma_load(dos + off, &tdo, qbar, x * kBox, (int)q0, ch, u * nb + cb);
        }
      for (int i = 0; i < 2 * n_tiles; ++i) {
        const int s = i % ST;
        mbar_wait(&empty[s], ((i / ST) & 1) ^ 1);
        mbar_expect_tx(&full[s], W::STAGE_BYTES);
        const int k0 = (int)((kt_first + i % n_tiles) * BK);
        uint8_t* ks = kvs + s * W::STAGE_BYTES;
#pragma unroll
        for (int u = 0; u < kTerms; ++u)
#pragma unroll
          for (int x = 0; x < W::NB; ++x) {
            const int off = u * W::T_PLANE + x * W::T_BOX;
            tma_load(ks + off, &tk, &full[s], x * kBox, k0, chk, u * nb + cb);
            tma_load(ks + W::T_BYTES + off, &tv, &full[s], x * kBox, k0, chk,
                     u * nb + cb);
          }
      }
    }
    return;
  }
  // ---------------- consumer warpgroups ----------------
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  // @probe f32-dq-start
  const int t = tid & 127;
  const int qd = t & 3;
  const int r = wgi * 64 + (t >> 5) * 16 + ((t & 31) >> 2);  // rows r, r+8
  const int64_t row_base = (b * p.Hq + h) * p.Sq;
  int64_t qp[2];
  float lse[2];    // +inf past Sq, where e is then 0
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int64_t row = q0 + r + 8 * hh;
    qp[hh] = p.q_offset + row;
    lse[hh] = row < p.Sq ? p.lse[row_base + row] : INFINITY;
  }
  const uint32_t q_addr = smem_u32(qs) + wgi * 64 * 128;
  const uint32_t do_addr = smem_u32(dos) + wgi * 64 * 128;
  auto edge_tile = [&](int64_t k0) {
    return k0 + BK > p.Sk || (p.causal && k0 + BK - 1 > qlo) ||
           (p.window > 0 && k0 <= qhi - p.window);
  };
  // sc = e of the tile at key k0, from S in sc; masked only on a tile
  // that crosses the diagonal, the window's edge or Sk
  auto exps = [&](float (&sc)[BK / 2], int64_t k0) {
    if (edge_tile(k0)) {
      const Cols cols[2] = {key_cols(p, qp[0], k0, BK),
                            key_cols(p, qp[1], k0, BK)};
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = sc[4 * j + 2 * hh + e];
            const int col = 8 * j + 2 * qd + e;
            x = col < cols[hh].lo || col > cols[hh].hi
                    ? 0.f : expf(fmaf(x, p.scale, -lse[hh]));
          }
    } else {
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = sc[4 * j + 2 * hh + e];
            x = expf(fmaf(x, p.scale, -lse[hh]));
          }
    }
  };
  // S and dP of the tile in stage s into sc and dp, waited for
  auto scores = [&](float (&sc)[BK / 2], float (&dp)[BK / 2], uint32_t k_addr) {
    zero(sc);
    zero(dp);
    fence_regs(sc);
    fence_regs(dp);
    wgmma_fence();
    wgmma_ss3<BK, W::KS>(sc, q_addr, W::ROW_BOX, W::ROW_PLANE, k_addr,
                         W::T_BOX, W::T_PLANE);
    wgmma_ss3<BK, W::KS>(dp, do_addr, W::ROW_BOX, W::ROW_PLANE,
                         k_addr + W::T_BYTES, W::T_BOX, W::T_PLANE);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    fence_regs(dp);
  };
  float sc[BK / 2], dp[BK / 2];

  mbar_wait(qbar, 0);
  // @probe f32-dq-loaded
  // walk 1: l = sum_j e, u = sum_j e dP
  float lsum[2] = {0.f, 0.f}, usum[2] = {0.f, 0.f};
  for (int n = 0; n < n_tiles; ++n) {
    const int s = n % ST;
    mbar_wait(&full[s], (n / ST) & 1);
    scores(sc, dp, smem_u32(kvs + s * W::STAGE_BYTES));
    if (t == 0) mbar_arrive(&empty[s]);
    exps(sc, (kt_first + n) * BK);
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 4 * j + 2 * hh + e;
          lsum[hh] += sc[c];
          usum[hh] = fmaf(sc[c], dp[c], usum[hh]);
        }
  }
  float rr[2], delta[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float l = lsum[hh], u = usum[hh];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    u += __shfl_xor_sync(0xffffffffu, u, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    u += __shfl_xor_sync(0xffffffffu, u, 2);
    const int64_t row = q0 + r + 8 * hh;
    rr[hh] = row < p.Sq ? recip(l) : 0.f;
    delta[hh] = u * rr[hh];
    if (qd == 0 && row < p.Sq) {
      p.rinv[row_base + row] = rr[hh];
      p.delta[row_base + row] = delta[hh];
    }
  }
  // @probe f32-dq-walk1

  // walk 2: dQ += dS K, dS = P (dP - delta), P = e r
  float acc[W::NR / 2], part[W::NR / 2];
  zero(acc);
  uint32_t a3[kTerms][BK / 16][4];
  for (int n = 0; n < n_tiles; ++n) {
    const int i = n_tiles + n;
    const int s = i % ST;
    const uint32_t k_addr = smem_u32(kvs + s * W::STAGE_BYTES);
    mbar_wait(&full[s], (i / ST) & 1);
    scores(sc, dp, k_addr);
    exps(sc, (kt_first + n) * BK);
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 4 * j + 2 * hh + e;
          sc[c] = (sc[c] * rr[hh]) * (dp[c] - delta[hh]);
        }
    fence_regs(sc);
    pack3<BK>(sc, a3);
    add_tile_rs3<BK, W::NR>(acc, part, a3, k_addr, W::T_BOX, W::T_PLANE);
    if (t == 0) mbar_arrive(&empty[s]);
  }
  // @probe f32-dq-walk2

  float* dqg = static_cast<float*>(p.dq) + b * p.sdq[0] + h * p.sdq[1];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int64_t row = q0 + r + 8 * hh;
    if (row < p.Sq) {
      float* drow = dqg + row * p.sdq[2] + 2 * qd;
#pragma unroll
      for (int j = 0; j < W::NR / 8; ++j)
        if (8 * j < D)
          *reinterpret_cast<float2*>(drow + 8 * j) =
              make_float2(acc[4 * j + 2 * hh] * p.scale,
                          acc[4 * j + 2 * hh + 1] * p.scale);
    }
  }
  // @probe f32-dq-end
}

// The per-column values of a dk/dv consumer for the queries q0 + c0 + 8j
// + 2qd + e (column 2j + e): lse (+inf past Sq), r and delta (0 past Sq)
template <int NQ>
__device__ __forceinline__ void column_rows(const WgParams& p, int64_t row_base,
                                            int64_t first, int qd,
                                            float (&lse)[NQ / 4],
                                            float (&rr)[NQ / 4],
                                            float (&dl)[NQ / 4]) {
#pragma unroll
  for (int j = 0; j < NQ / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int64_t row = first + 8 * j + 2 * qd + e;
      const bool in = row < p.Sq;
      lse[2 * j + e] = in ? p.lse[row_base + row] : INFINITY;
      rr[2 * j + e] = in ? p.rinv[row_base + row] : 0.f;
      dl[2 * j + e] = in ? p.delta[row_base + row] : 0.f;
    }
}

// One (key row, gradient) sum of a dk/dv consumer to global memory: the
// whole group's in fp32 to dk or dv, or this query head's to the
// partials; f = scale for dK, 1 for dV
template <int D, int NR>
__device__ __forceinline__ void store_f32_rows(const WgParams& p,
                                               const float (&acc)[NR / 2],
                                               bool dk, float f, int64_t b,
                                               int64_t hk, int64_t h_first,
                                               const int64_t (&kp)[2], int qd) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    if (kp[hh] >= p.Sk) continue;
    float* grow;
    if (p.per_head) {
      grow = (dk ? p.dk_part : p.dv_part) +
             ((b * p.Hq + h_first) * p.Sk + kp[hh]) * D;
    } else {
      const int64_t* st = dk ? p.sdk : p.sdv;
      grow = static_cast<float*>(dk ? p.dk : p.dv) + b * st[0] + hk * st[1] +
             kp[hh] * st[2];
    }
#pragma unroll
    for (int j = 0; j < NR / 8; ++j)
      if (8 * j < D)
        *reinterpret_cast<float2*>(grow + 8 * j + 2 * qd) =
            make_float2(acc[4 * j + 2 * hh] * f, acc[4 * j + 2 * hh + 1] * f);
  }
}

// One consumer warpgroup w of flash_bwd_f32_dkdv at D <= 64: it owns
// queries 32w..32w+31 of every streamed tile of 64, forms S^T and dP^T
// over them (SS, N 32), P^T = e r and dS^T, then dV += P^T dO and dK +=
// dS^T Q (RS), both accumulators in its registers, one tile after
// another.  At the end warpgroup 1 hands its sums to warpgroup 0 through
// shared memory, which adds them, its own first, and stores.
template <int D>
__device__ __forceinline__ void f32_dkdv_split(
    const WgParams& p, uint8_t* ks, uint8_t* vs, uint8_t* qds,
    uint64_t* full, uint64_t* empty, uint64_t* kbar, int64_t k0, int64_t b,
    int64_t hk, int64_t h_first, int64_t t_first, int n_t, int n_iter,
    int wgi) {
  using W = Bf<D>;
  constexpr int BQ = W::BT;
  constexpr int BH = BQ / 2;           // queries of a warpgroup
  constexpr int NR = W::NR;
  constexpr int ST = W::KV_STAGES;
  static_assert(BQ == 64, "the split walk takes streamed tiles of 64");
  const int t = threadIdx.x & 127;
  const int qd = t & 3;
  const int r = (t >> 5) * 16 + ((t & 31) >> 2);   // keys k0 + r, + r + 8
  const uint32_t k_addr = smem_u32(ks);
  const uint32_t v_addr = smem_u32(vs);
  const int64_t kp[2] = {k0 + r, k0 + r + 8};
  const int wq = wgi * BH;             // this warpgroup's first query

  float acc_k[NR / 2], acc_v[NR / 2], part[NR / 2];
  zero(acc_k);
  zero(acc_v);
  float sc[BH / 2], dp[BH / 2];
  float lse[BH / 4], rr[BH / 4], dl[BH / 4];   // by column: 2j + e
  uint32_t pa[kTerms][BH / 16][4], sa[kTerms][BH / 16][4];

  // @probe f32-kv-start
  mbar_wait(kbar, 0);
  // @probe f32-kv-loaded
  for (int i = 0; i < n_iter; ++i) {
    const int s = i % ST;
    const int64_t h = h_first + i / n_t;
    const int64_t q0 = (t_first + i % n_t) * BQ;
    column_rows<BH>(p, (b * p.Hq + h) * p.Sq, q0 + wq, qd, lse, rr, dl);
    const uint32_t q_addr = smem_u32(qds + s * W::STAGE_BYTES) + wq * 128;
    const uint32_t do_addr = q_addr + W::T_BYTES;
    // @probe f32-kv-tile-wait
    mbar_wait(&full[s], (i / ST) & 1);
    // @probe f32-kv-tile-ready
    zero(sc);
    zero(dp);
    fence_regs(sc);
    fence_regs(dp);
    wgmma_fence();
    wgmma_ss3<BH, W::KS>(sc, k_addr, W::KEY_BOX, W::KEY_PLANE, q_addr,
                         W::T_BOX, W::T_PLANE);
    wgmma_ss3<BH, W::KS>(dp, v_addr, W::KEY_BOX, W::KEY_PLANE, do_addr,
                         W::T_BOX, W::T_PLANE);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    fence_regs(dp);
    // @probe f32-kv-scores
    // P^T into sc, dS^T into dp; masked on the tiles that cross the
    // diagonal or the window
    const int64_t qlo = p.q_offset + q0;
    const bool edge = (p.causal && k0 + 63 > qlo) ||
                      (p.window > 0 && k0 <= qlo + BQ - 1 - p.window);
    Cols cols[2] = {{0, BQ - 1}, {0, BQ - 1}};
    if (edge)
      for (int hh = 0; hh < 2; ++hh) cols[hh] = query_cols(p, kp[hh], qlo, BQ);
#pragma unroll
    for (int j = 0; j < BH / 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 4 * j + 2 * hh + e;
          const int col = wq + 8 * j + 2 * qd + e;
          float x = expf(fmaf(sc[c], p.scale, -lse[2 * j + e])) * rr[2 * j + e];
          if (col < cols[hh].lo || col > cols[hh].hi) x = 0.f;
          sc[c] = x;
          dp[c] = x * (dp[c] - dl[2 * j + e]);
        }
    // @probe f32-kv-formed
    fence_regs(sc);
    fence_regs(dp);
    pack3<BH>(sc, pa);
    pack3<BH>(dp, sa);
    // @probe f32-kv-packed
    add_tile_rs3<BH, NR>(acc_v, part, pa, do_addr, W::T_BOX, W::T_PLANE);
    add_tile_rs3<BH, NR>(acc_k, part, sa, q_addr, W::T_BOX, W::T_PLANE);
    // @probe f32-kv-products
    if (t == 0) mbar_arrive(&empty[s]);
  }
  // @probe f32-kv-loop-end

  // warpgroup 1's sums to warpgroup 0 ([reg][t]), once both are done
  // reading the stages
  float* xfer = reinterpret_cast<float*>(qds);
  named_barrier(1, 256);
  if (wgi == 1) {
#pragma unroll
    for (int c = 0; c < NR / 2; ++c) {
      xfer[c * 128 + t] = acc_k[c];
      xfer[(NR / 2 + c) * 128 + t] = acc_v[c];
    }
  }
  named_barrier(2, 256);
  if (wgi == 1) return;
#pragma unroll
  for (int c = 0; c < NR / 2; ++c) {
    acc_k[c] += xfer[c * 128 + t];
    acc_v[c] += xfer[(NR / 2 + c) * 128 + t];
  }
  store_f32_rows<D, NR>(p, acc_k, true, p.scale, b, hk, h_first, kp, qd);
  store_f32_rows<D, NR>(p, acc_v, false, 1.f, b, hk, h_first, kp, qd);
  // @probe f32-kv-end
}

// One consumer warpgroup of flash_bwd_f32_dkdv at D > 64, where two 64 x D
// accumulators do not fit one warpgroup's registers: S^T and dP^T (SS)
// over the whole tile of 32 queries in both, then warpgroup 1 forms dK +=
// dS^T Q and warpgroup 0 dV += P^T dO (RS).  The role is data (an
// operand's address, a factor of 0 or 1 on dP^T - delta), not a branch,
// as in dkdv_consumer.
template <int D>
__device__ __forceinline__ void f32_dkdv_role(
    const WgParams& p, uint8_t* ks, uint8_t* vs, uint8_t* qds,
    uint64_t* full, uint64_t* empty, uint64_t* kbar, int64_t k0, int64_t b,
    int64_t hk, int64_t h_first, int64_t t_first, int n_t, int n_iter,
    bool dk) {
  using W = Bf<D>;
  constexpr int BQ = W::BT;
  constexpr int NR = W::NR;
  constexpr int ST = W::KV_STAGES;
  const int t = threadIdx.x & 127;
  const int qd = t & 3;
  const int r = (t >> 5) * 16 + ((t & 31) >> 2);   // keys k0 + r, + r + 8
  const uint32_t k_addr = smem_u32(ks);
  const uint32_t v_addr = smem_u32(vs);
  const int64_t kp[2] = {k0 + r, k0 + r + 8};
  // dS^T = P^T (sel (dP^T - delta) + 1 - sel): dS^T for dK, P^T for dV
  const float sel = dk ? 1.f : 0.f;

  float acc[NR / 2], part[NR / 2];
  zero(acc);
  float sc[BQ / 2], dp[BQ / 2];
  float lse[BQ / 4], rr[BQ / 4], dl[BQ / 4];
  uint32_t a3[kTerms][BQ / 16][4];

  mbar_wait(kbar, 0);
  for (int i = 0; i < n_iter; ++i) {
    const int s = i % ST;
    const int64_t h = h_first + i / n_t;
    const int64_t q0 = (t_first + i % n_t) * BQ;
    column_rows<BQ>(p, (b * p.Hq + h) * p.Sq, q0, qd, lse, rr, dl);
    const uint32_t q_addr = smem_u32(qds + s * W::STAGE_BYTES);
    const uint32_t do_addr = q_addr + W::T_BYTES;
    mbar_wait(&full[s], (i / ST) & 1);
    zero(sc);
    zero(dp);
    fence_regs(sc);
    fence_regs(dp);
    wgmma_fence();
    wgmma_ss3<BQ, W::KS>(sc, k_addr, W::KEY_BOX, W::KEY_PLANE, q_addr,
                         W::T_BOX, W::T_PLANE);
    wgmma_ss3<BQ, W::KS>(dp, v_addr, W::KEY_BOX, W::KEY_PLANE, do_addr,
                         W::T_BOX, W::T_PLANE);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    fence_regs(dp);
    const int64_t qlo = p.q_offset + q0;
    const bool edge = (p.causal && k0 + 63 > qlo) ||
                      (p.window > 0 && k0 <= qlo + BQ - 1 - p.window);
    Cols cols[2] = {{0, BQ - 1}, {0, BQ - 1}};
    if (edge)
      for (int hh = 0; hh < 2; ++hh) cols[hh] = query_cols(p, kp[hh], qlo, BQ);
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 4 * j + 2 * hh + e;
          const int col = 8 * j + 2 * qd + e;
          float x = expf(fmaf(sc[c], p.scale, -lse[2 * j + e])) * rr[2 * j + e];
          if (col < cols[hh].lo || col > cols[hh].hi) x = 0.f;
          sc[c] = x * fmaf(sel, dp[c] - dl[2 * j + e], 1.f - sel);
        }
    fence_regs(sc);
    pack3<BQ>(sc, a3);
    add_tile_rs3<BQ, NR>(acc, part, a3, dk ? q_addr : do_addr, W::T_BOX,
                         W::T_PLANE);
    if (t == 0) mbar_arrive(&empty[s]);
  }
  store_f32_rows<D, NR>(p, acc, dk, dk ? p.scale : 1.f, b, hk, h_first, kp,
                        qd);
}

// The fp32 dk/dv kernel: one block of 384 threads owns one (batch, kv
// head or, with per_head, query head, 64-key tile); K and V of the tile,
// in their three terms, stay in shared memory, and the Q and dO tiles of
// every query head of the group (or of the one head) that can see these
// keys stream through a ring of KV_STAGES.  dP^T, P^T and dS^T take lse,
// r and delta from the dq kernel's walk 1.
template <int D>
__global__ void __maxnreg__(168)
flash_bwd_f32_dkdv(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   const __grid_constant__ CUtensorMap tdo,
                   const WgParams p) {
  using W = Bf<D>;
  constexpr int BQ = W::BT;
  constexpr int ST = W::KV_STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* ks = smem;                              // [3][NB][64][128 B]
  uint8_t* vs = ks + kTerms * W::KEY_PLANE;        // [3][NB][64][128 B]
  uint8_t* qds = vs + kTerms * W::KEY_PLANE;       // [ST][Q, dO][3][NB][BQ][128 B]
  uint64_t* full = reinterpret_cast<uint64_t*>(qds + ST * W::STAGE_BYTES);
  uint64_t* empty = full + ST;
  uint64_t* kbar = empty + ST;

  const int tid = threadIdx.x;
  const int64_t k0 = (int64_t)blockIdx.y * 64;
  const int64_t b = blockIdx.z;
  const int64_t hk = p.per_head ? blockIdx.x / p.group : blockIdx.x;
  const int64_t h_first = p.per_head ? blockIdx.x : hk * p.group;
  const int n_heads = p.per_head ? 1 : p.group;

  // the query rows that see some key of this tile, in tiles of BQ
  const int64_t k_last = min64(k0 + 64, p.Sk) - 1;
  int64_t i_lo = 0, i_hi = p.Sq - 1;
  if (p.causal) i_lo = max64(i_lo, k0 - p.q_offset);
  if (p.window > 0) i_hi = min64(i_hi, k_last + p.window - 1 - p.q_offset);
  const int64_t t_first = i_lo <= i_hi ? i_lo / BQ : 0;
  const int n_t = i_lo <= i_hi ? (int)(i_hi / BQ - i_lo / BQ + 1) : 0;
  const int n_iter = n_heads * n_t;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);
    }
    mbar_init(kbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wgi = __shfl_sync(0xffffffffu, tid / 128, 0);
  if (wgi == 2) {
    // ---------------- producer warpgroup ----------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (tid == 2 * 128) {
      const int cb = (int)b, chk = (int)hk, nb = (int)p.batch;
      mbar_expect_tx(kbar, 2 * kTerms * W::KEY_PLANE);
#pragma unroll
      for (int u = 0; u < kTerms; ++u)
#pragma unroll
        for (int x = 0; x < W::NB; ++x) {
          const int off = u * W::KEY_PLANE + x * W::KEY_BOX;
          tma_load(ks + off, &tk, kbar, x * kBox, (int)k0, chk, u * nb + cb);
          tma_load(vs + off, &tv, kbar, x * kBox, (int)k0, chk, u * nb + cb);
        }
      for (int i = 0; i < n_iter; ++i) {
        const int s = i % ST;
        mbar_wait(&empty[s], ((i / ST) & 1) ^ 1);
        mbar_expect_tx(&full[s], W::STAGE_BYTES);
        const int ch = (int)(h_first + i / n_t);
        const int q0 = (int)((t_first + i % n_t) * BQ);
        uint8_t* st = qds + s * W::STAGE_BYTES;
#pragma unroll
        for (int u = 0; u < kTerms; ++u)
#pragma unroll
          for (int x = 0; x < W::NB; ++x) {
            const int off = u * W::T_PLANE + x * W::T_BOX;
            tma_load(st + off, &tq, &full[s], x * kBox, q0, ch, u * nb + cb);
            tma_load(st + W::T_BYTES + off, &tdo, &full[s], x * kBox, q0, ch,
                     u * nb + cb);
          }
      }
    }
    return;
  }
  // ---------------- consumer warpgroups ----------------
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  if constexpr (W::NB == 1)
    f32_dkdv_split<D>(p, ks, vs, qds, full, empty, kbar, k0, b, hk, h_first,
                      t_first, n_t, n_iter, wgi);
  else
    f32_dkdv_role<D>(p, ks, vs, qds, full, empty, kbar, k0, b, hk, h_first,
                     t_first, n_t, n_iter, wgi == 1);
}

// planes: the (3 B, H, S, D) bf16 term planes of q, k, v and dout
template <int D>
int launch_f32_d(void* const (&planes)[4], const WgParams& p, int64_t B,
                 int64_t Hkv, cudaStream_t stream) {
  using W = Bf<D>;
  CUtensorMap mq, mk, mv, mdo;
  auto maps = [&](int q_rows, int k_rows) {
    const int64_t nq = p.Sq * D, nk = p.Sk * D;
    int err = encode_map(&mq, planes[0], D, p.Sq, p.Hq, 3 * B, D, nq,
                         p.Hq * nq, q_rows);
    if (!err) err = encode_map(&mdo, planes[3], D, p.Sq, p.Hq, 3 * B, D, nq,
                               p.Hq * nq, q_rows);
    if (!err) err = encode_map(&mk, planes[1], D, p.Sk, Hkv, 3 * B, D, nk,
                               Hkv * nk, k_rows);
    if (!err) err = encode_map(&mv, planes[2], D, p.Sk, Hkv, 3 * B, D, nk,
                               Hkv * nk, k_rows);
    return err;
  };
  cudaError_t cerr = cudaFuncSetAttribute(
      flash_bwd_f32_dq<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      W::SMEM_DQ);
  if (cerr == cudaSuccess)
    cerr = cudaFuncSetAttribute(flash_bwd_f32_dkdv<D>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                W::SMEM_DKDV);
  if (cerr != cudaSuccess) return (int)cerr;
  // dq first: it writes the r and delta that dk/dv read
  int err = maps(W::ROWS, W::BT);
  if (err) return err;
  const dim3 gq((unsigned)p.Hq, (unsigned)((p.Sq + W::ROWS - 1) / W::ROWS),
                (unsigned)B);
  flash_bwd_f32_dq<D><<<gq, 128 * (W::WG + 1), W::SMEM_DQ, stream>>>(
      mq, mk, mv, mdo, p);
  cerr = cudaGetLastError();
  if (cerr != cudaSuccess) return (int)cerr;
  err = maps(W::BT, 64);
  if (err) return err;
  const dim3 gkv((unsigned)(p.per_head ? p.Hq : Hkv),
                 (unsigned)((p.Sk + 63) / 64), (unsigned)B);
  flash_bwd_f32_dkdv<D><<<gkv, kWgThreads, W::SMEM_DKDV, stream>>>(
      mq, mk, mv, mdo, p);
  return (int)cudaGetLastError();
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

// The bf16 backward on the tensor cores (flash_bwd_wgmma_dq, then
// flash_bwd_wgmma_dkdv).  strides: 21 element strides, (batch, head,
// seq) of q, k, v, dout, dq, dk and dv in that order; the last axis of
// each is contiguous; q, k, v and dout are read by TMA (every stride of
// an axis longer than 1 a multiple of 8 elements, 16-byte-aligned
// bases).  lse: the forward's, delta: scratch, both contiguous (B, Hq,
// Sq) fp32.  per_head: the dk/dv blocks own one query head each and
// write fp32 dK and dV of that head to dk_part and dv_part, contiguous
// (B, Hq, Sk, D), for the caller to sum over each group (dk and dv are
// then not written); else dk and dv get each group's sum, rounded once.
// window <= 0 means none.  Every query row must see at least one key.
// Returns 0, a CUDA runtime error code, or 10000 / 20000 + a CUresult
// (no tensor-map encoder / a tensor map refused).  The caller handles
// Sq == 0 and Sk == 0 without a launch.
extern "C" int flash_attention_bwd_wgmma(
    int D, const void* q, const void* k, const void* v, const void* dout,
    const float* lse, float* delta, void* dq, void* dk, void* dv,
    float* dk_part, float* dv_part, const int64_t* strides, int64_t B,
    int64_t Hq, int64_t Hkv, int64_t Sq, int64_t Sk, int64_t q_offset,
    int64_t window, int causal, float scale, int per_head, void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Sq <= 0 || Sk <= 0 || Hq % Hkv ||
      B > 65535 || Sq > 0x7fffffffLL || Sk > 0x7fffffffLL ||
      (Sq + 127) / 128 > 65535 || (Sk + 63) / 64 > 65535 ||
      (per_head && (dk_part == nullptr || dv_part == nullptr)))
    return (int)cudaErrorInvalidValue;
  WgParams p;
  p.lse = lse;
  p.delta = delta;
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.dk_part = dk_part;
  p.dv_part = dv_part;
  for (int j = 0; j < 3; ++j) {
    p.sdq[j] = strides[12 + j];
    p.sdk[j] = strides[15 + j];
    p.sdv[j] = strides[18 + j];
  }
  p.Hq = Hq;
  p.Sq = Sq;
  p.Sk = Sk;
  p.q_offset = q_offset;
  p.window = window;
  p.group = (int)(Hq / Hkv);
  p.causal = causal;
  p.per_head = per_head;
  p.scale = scale;
  cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
    case 32: return launch_wgmma_d<32>(q, k, v, dout, strides, p, B, Hkv, s);
    case 64: return launch_wgmma_d<64>(q, k, v, dout, strides, p, B, Hkv, s);
    case 80: return launch_wgmma_d<80>(q, k, v, dout, strides, p, B, Hkv, s);
    case 128: return launch_wgmma_d<128>(q, k, v, dout, strides, p, B, Hkv, s);
    case 192: return launch_wgmma_d<192>(q, k, v, dout, strides, p, B, Hkv, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The fp32 backward on the tensor cores: flash_bwd_split3 (q, k, v and
// dout into three bf16 term planes each, q3, k3, v3 and do3: (3, B, H,
// S, D) contiguous bf16 workspaces), then flash_bwd_f32_dq and
// flash_bwd_f32_dkdv.  strides: 21 element strides, (batch, head, seq)
// of q, k, v, dout, dq, dk and dv in that order; the last axis of each is
// contiguous and every other stride and base is 4-element aligned.  lse:
// the forward's; rinv and delta: scratch that the dq kernel writes; all
// three contiguous (B, Hq, Sq) fp32.  per_head, dk_part and dv_part as in
// flash_attention_bwd_wgmma (fp32 dk and dv get each group's sum
// otherwise).  window <= 0 means none.  Every query row must see at
// least one key.  Returns 0, a CUDA runtime error code, or 10000 / 20000
// + a CUresult.  The caller handles Sq == 0 and Sk == 0 without a launch.
extern "C" int flash_attention_bwd_f32(
    int D, const void* q, const void* k, const void* v, const void* dout,
    void* q3, void* k3, void* v3, void* do3, const float* lse, float* rinv,
    float* delta, void* dq, void* dk, void* dv, float* dk_part,
    float* dv_part, const int64_t* strides, int64_t B, int64_t Hq,
    int64_t Hkv, int64_t Sq, int64_t Sk, int64_t q_offset, int64_t window,
    int causal, float scale, int per_head, void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Sq <= 0 || Sk <= 0 || Hq % Hkv ||
      B > 65535 || Sq > 0x7fffffffLL || Sk > 0x7fffffffLL ||
      (Sq + 63) / 64 > 65535 || (Sk + 63) / 64 > 65535 ||
      (per_head && (dk_part == nullptr || dv_part == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  SplitParams sp;
  const void* src[4] = {q, k, v, dout};
  void* const planes[4] = {q3, k3, v3, do3};
  for (int x = 0; x < 4; ++x) {
    const bool kv = x == 1 || x == 2;
    sp.src[x] = static_cast<const float*>(src[x]);
    sp.dst[x] = static_cast<__nv_bfloat16*>(planes[x]);
    for (int j = 0; j < 3; ++j) sp.st[x][j] = strides[3 * x + j];
    sp.H[x] = kv ? Hkv : Hq;
    sp.S[x] = kv ? Sk : Sq;
    sp.rows[x] = B * sp.H[x] * sp.S[x];
  }
  sp.D = D;
  // 8 blocks of 256 an SM of the H100's 132, each thread 16 bytes at a time
  flash_bwd_split3<<<132 * 8, kThreads, 0, s>>>(sp);
  const cudaError_t cerr = cudaGetLastError();
  if (cerr != cudaSuccess) return (int)cerr;
  WgParams p;
  p.lse = lse;
  p.delta = delta;
  p.rinv = rinv;
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.dk_part = dk_part;
  p.dv_part = dv_part;
  for (int j = 0; j < 3; ++j) {
    p.sdq[j] = strides[12 + j];
    p.sdk[j] = strides[15 + j];
    p.sdv[j] = strides[18 + j];
  }
  p.Hq = Hq;
  p.Sq = Sq;
  p.Sk = Sk;
  p.q_offset = q_offset;
  p.window = window;
  p.group = (int)(Hq / Hkv);
  p.causal = causal;
  p.per_head = per_head;
  p.scale = scale;
  p.batch = B;
  switch (D) {
    case 32: return launch_f32_d<32>(planes, p, B, Hkv, s);
    case 64: return launch_f32_d<64>(planes, p, B, Hkv, s);
    case 80: return launch_f32_d<80>(planes, p, B, Hkv, s);
    case 128: return launch_f32_d<128>(planes, p, B, Hkv, s);
    case 192: return launch_f32_d<192>(planes, p, B, Hkv, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
