/*
 * flash_attention — online-softmax attention for Hopper (sm_90a).
 *
 *     o[b, h, i, :] = sum_k softmax_k(scale * q[b, h, i, :] . k[b, h / G, k, :])
 *                     * v[b, h / G, k, :]
 *
 *     q: (B, Hq, Sq, D), k/v: (B, Hkv, Sk, D), o: (B, Hq, Sq, D), each a
 *     strided view whose last axis is contiguous; G = Hq / Hkv; fp32 or
 *     bf16 in, the output in q's dtype; D in {32, 64, 80, 128, 192}, the
 *     head dims of the dense configs the port serves.
 *
 * Replaces the TPU kernel repro/kernels/flash_attention/kernel.py:69
 * flash_attention_pallas (body _flash_kernel).  Masks work on absolute
 * positions qp = q_offset + i and kp: causal keeps kp <= qp, a window W
 * keeps kp > qp - W, and a masked score is the finite NEG_INF = -1e30, so
 * a row that sees no key averages V over all Sk keys, as the reference's
 * attention_ref does.  Keys at kp >= Sk (the ragged end of the last tile)
 * take no part at all: where the Pallas wrapper pads K and V with zeros
 * and relies on the causal mask to hide them, this kernel masks them.
 *
 * Two variants, chosen by the input dtype with no fallback between them:
 *
 * flash_fwd_simt<D>, fp32 inputs.  The Pallas kernel's arithmetic step
 * for step: q is scaled in fp32, scores, the running max m, the running
 * sum l, p and the accumulator are fp32, and l is clamped at 1e-30
 * before the division.  One block of 256 threads owns one (batch, query
 * head, 64-row query tile) and walks the kv tiles in a loop, (m, l, acc)
 * in registers; the scaled Q tile (64 x D), K transposed (D x 68) and V
 * (64 x D) in shared memory, P reusing K's space; thread (ty, tx) of a
 * 16 x 16 grid owns 4 rows x 4 keys of the scores and 4 rows x D/16
 * output columns, a row's max and sum reduced over its 16 threads with
 * xor shuffles.  SIMT fp32 FMAs: bound by the 67 TFLOP/s fp32 rate.
 *
 * flash_fwd_wgmma<D>, bf16 inputs (the serve path).  Warp-specialised:
 * one block of 384 threads owns one (batch, query head, 128-row query
 * tile).  Warpgroup 2 is the producer: after setmaxnreg hands its
 * registers to the consumers (24 against 240), one thread issues every
 * copy by TMA — the Q tile once, then K and V tiles of 64 keys (128 at
 * D <= 64, 32 at D 192) into a ring of 3 shared-memory stages with a
 * full and an empty mbarrier each, 128-byte swizzled.  Warpgroups 0
 * and 1 are consumers of 64 query rows each; per kv tile n:
 *   1. S_n = Q K_n^T by wgmma.mma_async m64nBKk16, bf16 -> fp32, Q and K
 *      both K-major from shared memory, issued together with the
 *      previous tile's O += P_{n-1} V_{n-1}, so the tensor cores run that
 *      product while the warpgroup does the softmax of S_n;
 *   2. the masks on S in registers, on absolute positions (a masked
 *      score -1e30, a key past Sk -inf), only on tiles that cross the
 *      diagonal, the window's edge or Sk;
 *   3. online softmax in the log2 domain: S is scaled in fp32 by
 *      scale * log2(e) and exponentiated by ex2.approx (the same function
 *      as scale then exp, within 2 ulp).  A row's max is reduced over the
 *      4 threads that share it in the accumulator layout; l is kept per
 *      thread and reduced once at the end;
 *   4. P stays in registers, where the accumulator layout of S is already
 *      the A-operand layout of the next product, as two bf16 terms, hi =
 *      bf16(P) and lo = bf16(P - hi), so hi + lo is P within 2^-17; O +=
 *      hi V + lo V by wgmma m64nDk16 with A from registers and V from
 *      shared memory as an MN-major B operand (imm-trans-b);
 *   5. O, m and l stay in registers; a stage goes back to the producer
 *      once the P V that reads its V is done.
 * Epilogue: O / max(l, 1e-30), stored as bf16 pairs straight into the
 * strided output, rows past Sq and padded columns not stored; where lse
 * is asked for (the training forward), each row's log-sum-exp of the
 * scaled scores in natural-log units, m ln 2 + log(l), as the SIMT
 * variant writes it (l is summed from the fp32 P, before P is split into
 * its bf16 terms).
 * Head dims: a 128-byte-swizzled box is 64 bf16 columns, so D is cut
 * into ceil(D / 64) boxes and padded to a multiple of 64 by TMA's zero
 * fill (D 32 -> 64, D 80 -> 128, D 192 = three boxes): zero columns of Q
 * and K add nothing to S, zero columns of V give output columns that are
 * not stored.  The same padding as the Pallas wrapper's D -> 128.
 * Numerics: P in one bf16 term (bf16(P) V, as first built) moved the
 * bf16 Qwen2-7B prefill's logits by up to 0.098 against the plain path's
 * fp32 P and flipped the first token of a request whose top two logits
 * were one bf16 ulp apart; two terms keep P to fp32's precision class at
 * the cost of a second P V product (1.5x the tensor-core work).  What
 * differs from the Pallas kernel's fp32 arithmetic: P carries 16
 * significant bits, scale multiplies S rather than Q, and the sums run
 * in the tensor cores' order.  So it is held to the fp32-P plain
 * version, attention_ref on the same bf16 inputs in fp32: each output
 * within one bf16 ulp plus 2^-12 of its row's largest |o|, a gate that
 * the one-term kernel fails (chip_smoke.py, tools/flash_probe.py).
 *
 * Shared by both: GQA is an index (kv head = q head / G, query heads
 * ordered hk * G + g as repro's flash_attention_model_layout orders
 * them); kv tiles wholly above the causal diagonal or wholly left of the
 * window are skipped (exact: a masked key adds exp(-1e30 - m) = 0 once a
 * row has seen a visible key, and its p = 1 before that is cancelled by
 * alpha = 0 when the first visible key comes), except that a query tile
 * holding a row with no visible key walks every tile, so that row
 * averages V over all keys as the reference does; causal query tiles
 * are scheduled longest first; ragged Sq and Sk are masked, never padded
 * in device memory (TMA fills out-of-bounds rows and columns with zeros,
 * which the masks then decide on); offsets are 64-bit; there are no
 * atomics, and every sum runs in an order fixed by the shapes, so two
 * launches give bit-identical output.
 *
 * What bounds it.  At the Qwen2-7B prefill shape (B 4, Hq 28, Hkv 4,
 * S 2048, D 128, bf16, causal) the work is 4 * B * Hq * D * S(S+1)/2 =
 * 1.203e11 flops against 134,217,728 bytes of q, k, v and o: on bf16
 * tensor cores (989 TFLOP/s) the bound is 121.6 us, the bytes take 40.1
 * us at 3.35 TB/s; at fp32's 67 TFLOP/s, the SIMT variant's rate, 1.796
 * ms.  Danube's (B 2, Hq 32, Hkv 8, S 6144, D 80, window 4096) and
 * zamba2's (B 4, Hq = Hkv = 32, S 4096, D 64, causal) are also bound by
 * the tensor cores: 347.3 and 277.9 us.  The wgmma variant does 1.5x
 * the tensor-core work of those bounds (two P V products), and 1.6x more
 * at Danube's D 80 padded to 128; what holds it back on an H100 is the
 * softmax of each tile, which overlaps only its own warpgroup's P V (the
 * two consumer warpgroups are not yet scheduled in turn): at the Qwen2
 * shape a warpgroup spends ~1150 cycles a tile in the softmax against
 * ~770 waiting for S (tools/flash_probe.py).
 *
 * The tensor maps need the driver's cuTensorMapEncodeTiled; it is
 * fetched through cudaGetDriverEntryPoint, so the library links only the
 * CUDA runtime.  They are encoded on the host at every call (a few us)
 * and passed by value as __grid_constant__ parameters.  The TMA, mbarrier
 * and wgmma helpers and split_bf16 live in csrc/wgmma.cuh, shared with
 * the bf16 backward (csrc/flash_attention_bwd.cu).
 *
 * Lines "// @probe <name>" mark where tools/flash_probe.py inserts clock
 * reads, or its deliberate faults, into a copy of this source; they are
 * comments and compile to nothing.
 */
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

using namespace hopper;

constexpr float kNegInf = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;                    // (B, Hq, Sq) fp32 or null
  int64_t sqb, sqh, sqs;         // strides in elements: batch, head, seq
  int64_t skb, skh, sks;
  int64_t svb, svh, svs;
  int64_t sob, soh, sos;
  int64_t Sq, Sk, q_offset;
  int64_t window;                // <= 0: no window
  int group;                     // Hq / Hkv
  int causal;
  int n_qtiles;
  float scale;
};

__host__ __device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}
__host__ __device__ __forceinline__ int64_t max64(int64_t a, int64_t b) {
  return a > b ? a : b;
}

// ---------------------------------------------------------------------------
// flash_fwd_simt: fp32 inputs
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;
constexpr int kBQ = 64;          // query rows of a block
constexpr int kBK = 64;          // keys of a kv tile
constexpr int kKS = kBK + 4;     // row stride of the K^T and P tiles

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void store1(float* p, float x) { *p = x; }

__device__ __forceinline__ float lane(const float4& x, int j) {
  return j == 0 ? x.x : j == 1 ? x.y : j == 2 ? x.z : x.w;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_simt(const Params p) {
  // D % 16: the output columns and the K^T staging (D / 4 % 4); D <= 192
  // keeps acc in registers and the tiles within a block's shared memory
  static_assert(D % 16 == 0 && D <= 192, "D a multiple of 16, at most 192");
  constexpr int kCols = D / 16;  // output columns of a thread
  constexpr int kV4 = D / 4;     // 4-element groups in a row
  constexpr int kKRows = D > kBQ ? D : kBQ;     // K^T rows, or P's
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [kBQ][D], scaled
  float* kt = qs + kBQ * D;                     // [D][kKS], K transposed
  float* vs = kt + kKRows * kKS;                // [kBK][D]
  float* ps = kt;                               // [kBQ][kKS], after S

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int64_t qt = p.n_qtiles - 1 - (int64_t)blockIdx.x;
  const int64_t h = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int64_t hk = h / p.group;
  const int64_t q0 = qt * kBQ;

  const float* __restrict__ qg = static_cast<const float*>(p.q) + b * p.sqb +
                             h * p.sqh;
  const float* __restrict__ kg = static_cast<const float*>(p.k) + b * p.skb +
                             hk * p.skh;
  const float* __restrict__ vg = static_cast<const float*>(p.v) + b * p.svb +
                             hk * p.svh;
  float* __restrict__ og = static_cast<float*>(p.o) + b * p.sob + h * p.soh;

  for (int idx = tid; idx < kBQ * kV4; idx += kThreads) {
    const int r = idx / kV4;
    const int d4 = (idx % kV4) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < p.Sq) {
      x = load4(qg + (q0 + r) * p.sqs + d4);
      x.x *= p.scale;
      x.y *= p.scale;
      x.z *= p.scale;
      x.w *= p.scale;
    }
    *reinterpret_cast<float4*>(qs + r * D + d4) = x;
  }

  // The kv tiles this query tile visits; a row with no visible key needs
  // them all.  The barrier also publishes the Q tile.
  const int64_t n_rows = min64(kBQ, p.Sq - q0);
  const int64_t qlo = p.q_offset + q0;
  const int64_t qhi = qlo + n_rows - 1;
  int empty = 0;
  if (tid < n_rows) {
    const int64_t qp = qlo + tid;
    const int64_t lo = p.window > 0 ? max64(0, qp - p.window + 1) : 0;
    const int64_t hi = p.causal ? min64(p.Sk - 1, qp) : p.Sk - 1;
    empty = lo > hi;
  }
  const int any_empty = __syncthreads_or(empty);
  int64_t kt_first = 0;
  int64_t kt_last = (p.Sk - 1) / kBK;
  if (!any_empty) {
    if (p.window > 0) kt_first = max64(0, qlo - p.window + 1) / kBK;
    if (p.causal) kt_last = min64(p.Sk - 1, qhi) / kBK;
  }

  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;
  }

  for (int64_t t = kt_first; t <= kt_last; ++t) {
    const int64_t k0 = t * kBK;
    __syncthreads();  // the previous tile's P and V are read
    // K^T: 32 consecutive indices cover 8 keys x 4 groups of 4 elements,
    // so a warp reads runs of 16 elements and its transposed stores are
    // at most 2-way bank-conflicted
    for (int idx = tid; idx < kBK * kV4; idx += kThreads) {
      const int w = idx >> 5;
      const int ln = idx & 31;
      const int c = (w & 7) * 8 + (ln & 7);
      const int d4 = ((w >> 3) * 4 + (ln >> 3)) * 4;
      float4 kx = make_float4(0.f, 0.f, 0.f, 0.f);
      if (k0 + c < p.Sk) kx = load4(kg + (k0 + c) * p.sks + d4);
      kt[(d4 + 0) * kKS + c] = kx.x;
      kt[(d4 + 1) * kKS + c] = kx.y;
      kt[(d4 + 2) * kKS + c] = kx.z;
      kt[(d4 + 3) * kKS + c] = kx.w;
    }
    for (int idx = tid; idx < kBK * kV4; idx += kThreads) {
      const int c = idx / kV4;
      const int d4 = (idx % kV4) * 4;
      float4 vx = make_float4(0.f, 0.f, 0.f, 0.f);
      if (k0 + c < p.Sk) vx = load4(vg + (k0 + c) * p.svs + d4);
      *reinterpret_cast<float4*>(vs + c * D + d4) = vx;
    }
    __syncthreads();

    // S = (scale q) k^T over this thread's 4 rows x 4 keys
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(qs + (ty * 4 + i) * D + d);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        kv[e] = *reinterpret_cast<const float4*>(kt + (d + e) * kKS + tx * 4);
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            s[i][j] = fmaf(lane(qv[i], e), lane(kv[e], j), s[i][j]);
    }

    // mask, then the online-softmax update of each row; s becomes p
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int64_t qp = qlo + ty * 4 + i;
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int64_t kp = k0 + tx * 4 + j;
        bool ok = true;
        if (p.causal) ok = ok && kp <= qp;
        if (p.window > 0) ok = ok && kp > qp - p.window;
        if (!ok) s[i][j] = kNegInf;
        if (kp < p.Sk) mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float alpha = expf(m[i] - mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int64_t kp = k0 + tx * 4 + j;
        s[i][j] = kp < p.Sk ? expf(s[i][j] - mx) : 0.f;
        sum += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[i][j] *= alpha;
      m[i] = mx;
    }

    __syncthreads();  // every thread is done with K^T, which P overwrites
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<float4*>(ps + (ty * 4 + i) * kKS + tx * 4) =
          make_float4(s[i][0], s[i][1], s[i][2], s[i][3]);
    __syncthreads();

    // acc += P V over this thread's 4 rows x D/16 columns
#pragma unroll 2
    for (int c = 0; c < kBK; c += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(ps + (ty * 4 + i) * kKS + c);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float vv[kCols];
#pragma unroll
        for (int j = 0; j < kCols; ++j) vv[j] = vs[(c + e) * D + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < kCols; ++j)
            acc[i][j] = fmaf(lane(pv[i], e), vv[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t row = q0 + ty * 4 + i;
    if (row < p.Sq) {
      const float li = fmaxf(l[i], 1e-30f);
      float* orow = og + row * p.sos;
#pragma unroll
      for (int j = 0; j < kCols; ++j) store1(orow + tx + 16 * j, acc[i][j] / li);
      // the row's log-sum-exp of the scaled, masked scores, for the
      // backward kernel (csrc/flash_attention_bwd.cu): P = exp(S - lse)
      if (p.lse != nullptr && tx == 0)
        p.lse[(b * gridDim.y + h) * p.Sq + row] = m[i] + logf(li);
    }
  }
}

// ---------------------------------------------------------------------------
// flash_fwd_wgmma: bf16 inputs
// ---------------------------------------------------------------------------

constexpr int kWgRows = 128;     // query rows of a block: two warpgroups
constexpr int kWgThreads = 384;  // consumer warpgroups 0, 1; producer 2

template <int D>
struct Wg {
  static constexpr int NB = (D + kBox - 1) / kBox;  // boxes across D
  static constexpr int DP = NB * kBox;              // D padded
  // keys of a kv tile: 128 at D <= 64 (fewer, larger S products where O
  // is small), 32 at D 192 (O takes 96 registers a thread), else 64
  static constexpr int BK = NB == 1 ? 128 : NB == 2 ? 64 : 32;
  static constexpr int STAGES = 3;
  static constexpr int Q_BOX = kWgRows * 128;       // bytes of a Q box
  static constexpr int KV_BOX = BK * 128;           // bytes of a K/V box
  static constexpr int Q_BYTES = NB * Q_BOX;
  static constexpr int KV_BYTES = NB * KV_BOX;      // K (or V) of a stage
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;
  // 1024 bytes of slack to align the tiles to the swizzle's 1024-byte
  // period, then the tiles, then 2 * STAGES + 1 mbarriers
  static constexpr int SMEM =
      1024 + Q_BYTES + STAGES * STAGE_BYTES + 8 * (2 * STAGES + 1);
};


// S = Q K^T of one kv tile into sc: DP / 16 steps of 16 columns, four in
// each 64-column box; issued and committed, not waited for
template <int BK, int DP, int Q_BOX, int KV_BOX>
__device__ __forceinline__ void issue_qk(float (&sc)[BK / 2], uint32_t q_addr,
                                         uint32_t k_addr) {
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const uint32_t off = (kk & 3) * 32;
    mma_ss<BK>(sc, desc_sw128(q_addr + (kk >> 2) * Q_BOX + off, 16, 1024),
               desc_sw128(k_addr + (kk >> 2) * KV_BOX + off, 16, 1024),
               kk > 0);
  }
  wgmma_commit();
}

// O += P V of one kv tile, P = hi + lo from registers; V MN-major, 8 keys
// 128 bytes apart in a 1024-byte swizzle atom, the boxes across D KV_BOX
// bytes apart; issued and committed, not waited for
template <int BK, int DP, int KV_BOX>
__device__ __forceinline__ void issue_pv(float (&o)[DP / 2],
                                         const uint32_t (&hi)[BK / 16][4],
                                         const uint32_t (&lo)[BK / 16][4],
                                         uint32_t v_addr) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    const uint64_t db = desc_sw128(v_addr + kk * 16 * 128, KV_BOX, 1024);
    mma_rs<DP>(o, hi[kk], db);
    // @probe lo-term (the next line)
    mma_rs<DP>(o, lo[kk], db);
  }
  wgmma_commit();
}

// Where a tile crosses the diagonal, the window's left edge or Sk, the
// masks of one of the thread's rows, as columns of the tile (0..BK-1):
// keys past Sk are the columns above kmax, masked keys those below lo or
// above hi.  Computed once a tile in 64 bits and clamped, so the per-key
// tests are 32-bit.
struct TileMask {
  int kmax;
  int lo[2];
  int hi[2];
};

template <int BK>
__device__ __forceinline__ TileMask tile_mask(const Params& p, int64_t k0,
                                              const int64_t (&qp)[2]) {
  TileMask t;
  t.kmax = (int)max64(-1, min64(BK - 1, p.Sk - 1 - k0));
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    t.hi[hh] = p.causal ? (int)max64(-1, min64(BK - 1, qp[hh] - k0))
                        : BK - 1;
    t.lo[hh] = p.window > 0
                   ? (int)max64(0, min64(BK, qp[hh] - p.window + 1 - k0))
                   : 0;
  }
  return t;
}

// The masks and the online-softmax update of one tile's scores: sc
// becomes p = exp2(sc * sl2 - m) (log2 domain), m and l are updated and
// alpha is the factor the accumulator of each of the thread's two rows
// must be rescaled by.  Touches neither O nor the P registers, so it runs
// while the previous tile's P V is in flight.  Only tiles on an edge
// (``edge``) take the masks, in a branch of their own.
template <int BK>
__device__ __forceinline__ void online_softmax(
    float (&sc)[BK / 2], float (&m)[2], float (&l)[2], float (&alpha)[2],
    bool edge, const TileMask& mask, int qd, float sl2) {
  float mx[2] = {m[0], m[1]};
  if (edge) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * j + 2 * qd + e;
          float x = sc[4 * j + 2 * hh + e] * sl2;
          if (col < mask.lo[hh] || col > mask.hi[hh]) x = kNegInf;
          if (col > mask.kmax) x = -INFINITY;
          sc[4 * j + 2 * hh + e] = x;
          mx[hh] = fmaxf(mx[hh], x);
        }
      }
    }
  } else {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float x = sc[4 * j + 2 * hh + e] * sl2;
          sc[4 * j + 2 * hh + e] = x;
          mx[hh] = fmaxf(mx[hh], x);
        }
      }
    }
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
    mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
    alpha[hh] = fast_exp2(m[hh] - mx[hh]);
    m[hh] = mx[hh];
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float pe = fast_exp2(sc[4 * j + 2 * hh + e] - mx[hh]);
        sc[4 * j + 2 * hh + e] = pe;
        sum += pe;
      }
    }
    l[hh] = l[hh] * alpha[hh] + sum;
  }
}


// 168 registers a thread at launch (384 x 168 = 64,512 of the SM's
// 65,536); setmaxnreg then moves them from the producer warpgroup to the
// consumers: 24 + 2 x 240 per lane of each SM sub-partition
template <int D>
__global__ void __maxnreg__(168)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, const Params p) {
  using W = Wg<D>;
  constexpr int BK = W::BK;
  constexpr int DP = W::DP;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* qs = smem;                          // [NB][128 rows][128 B]
  uint8_t* kvs = smem + W::Q_BYTES;            // [STAGES][K, V][NB][BK][128 B]
  uint64_t* full = reinterpret_cast<uint64_t*>(
      kvs + W::STAGES * W::STAGE_BYTES);
  uint64_t* empty = full + W::STAGES;
  uint64_t* qbar = empty + W::STAGES;

  const int tid = threadIdx.x;
  const int64_t h = blockIdx.x;
  const int64_t qt = (int64_t)gridDim.y - 1 - blockIdx.y;  // longest first
  const int64_t b = blockIdx.z;
  const int64_t hk = h / p.group;
  const int64_t q0 = qt * kWgRows;

  // The kv tiles this query tile visits, the same in every thread.  A row
  // qp sees no key iff causal and qp < 0, or a window and qp >= Sk + W - 1;
  // such rows lie at the tile's ends, and then every tile is walked.
  const int64_t n_rows = min64(kWgRows, p.Sq - q0);
  const int64_t qlo = p.q_offset + q0;
  const int64_t qhi = qlo + n_rows - 1;
  const bool any_empty = (p.causal && qlo < 0) ||
                         (p.window > 0 && qhi >= p.Sk + p.window - 1);
  int64_t kt_first = 0;
  int64_t kt_last = (p.Sk - 1) / BK;
  if (!any_empty) {
    if (p.window > 0) kt_first = max64(0, qlo - p.window + 1) / BK;
    if (p.causal) kt_last = min64(p.Sk - 1, qhi) / BK;
  }
  const int n_tiles = (int)(kt_last - kt_first + 1);

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < W::STAGES; ++s) {
      mbar_init(&full[s], 1);          // the producer's expect_tx
      mbar_init(&empty[s], 2);         // one arrive per consumer warpgroup
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = tid / 128;
  if (wg == 2) {
    // ---------------- producer warpgroup ----------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (tid == 2 * 128) {
      const int cb = (int)b, ch = (int)h, chk = (int)hk;
      mbar_expect_tx(qbar, W::Q_BYTES);
#pragma unroll
      for (int x = 0; x < W::NB; ++x)
        tma_load(qs + x * W::Q_BOX, &tq, qbar, x * kBox, (int)q0, ch, cb);
      for (int n = 0; n < n_tiles; ++n) {
        const int s = n % W::STAGES;
        mbar_wait(&empty[s], ((n / W::STAGES) & 1) ^ 1);
        mbar_expect_tx(&full[s], W::STAGE_BYTES);
        const int k0 = (int)((kt_first + n) * BK);
        uint8_t* ks = kvs + s * W::STAGE_BYTES;
#pragma unroll
        for (int x = 0; x < W::NB; ++x)
          tma_load(ks + x * W::KV_BOX, &tk, &full[s], x * kBox, k0, chk, cb);
#pragma unroll
        for (int x = 0; x < W::NB; ++x)
          tma_load(ks + W::KV_BYTES + x * W::KV_BOX, &tv, &full[s],
                   x * kBox, k0, chk, cb);
      }
    }
  } else {
    // ---------------- consumer warpgroups ----------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int t = tid & 127;
    const int qd = t & 3;                       // column pair in an 8-chunk
    // this thread's rows: r and r + 8 of the tile's 128
    const int r = wg * 64 + (t >> 5) * 16 + ((t & 31) >> 2);
    const float sl2 = p.scale * 1.4426950408889634f;   // scale * log2(e)

    float o[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
    float m[2] = {kNegInf, kNegInf};
    float l[2] = {0.f, 0.f};
    const uint32_t q_addr = smem_u32(qs) + wg * 64 * 128;
    int64_t qp[2];
    qp[0] = qlo + r;
    qp[1] = qlo + r + 8;

    // tiles on the diagonal, the window's left edge or Sk are masked
    auto edge_tile = [&](int64_t k0) {
      return k0 + BK > p.Sk || (p.causal && k0 + BK - 1 > qlo) ||
             (p.window > 0 && k0 <= qhi - p.window);
    };
    float sc[BK / 2];
    uint32_t hi[BK / 16][4], lo[BK / 16][4];
    float alpha[2];

    // @probe start
    // tile 0: S, softmax, P
    mbar_wait(qbar, 0);
    mbar_wait(&full[0], 0);
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) sc[i] = 0.f;
    fence_regs(sc);
    wgmma_fence();
    issue_qk<BK, DP, W::Q_BOX, W::KV_BOX>(sc, q_addr, smem_u32(kvs));
    wgmma_wait<0>();
    fence_regs(sc);
    {
      const int64_t k0 = kt_first * BK;
      online_softmax<BK>(sc, m, l, alpha, edge_tile(k0),
                         tile_mask<BK>(p, k0, qp), qd, sl2);
    }
    pack_p<BK>(sc, hi, lo);

    // @probe loop
    // tile n: S_n and the previous tile's P V go to the tensor cores
    // together; the softmax of S_n runs while P V is in flight
    for (int n = 1; n < n_tiles; ++n) {
      const int s = n % W::STAGES;
      const int sp = (n - 1) % W::STAGES;
      const uint32_t k_addr = smem_u32(kvs + s * W::STAGE_BYTES);
      const uint32_t v_prev =
          smem_u32(kvs + sp * W::STAGE_BYTES) + W::KV_BYTES;
      const int64_t k0 = (kt_first + n) * BK;
      // @probe tile-wait
      mbar_wait(&full[s], (n / W::STAGES) & 1);
      // @probe tile-ready
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) sc[i] = 0.f;
      fence_regs(sc);
      fence_regs(o);
      wgmma_fence();
      issue_qk<BK, DP, W::Q_BOX, W::KV_BOX>(sc, q_addr, k_addr);
      issue_pv<BK, DP, W::KV_BOX>(o, hi, lo, v_prev);
      wgmma_wait<1>();                    // S_n is done, P V may not be
      fence_regs(sc);
      // @probe scores
      online_softmax<BK>(sc, m, l, alpha, edge_tile(k0),
                         tile_mask<BK>(p, k0, qp), qd, sl2);
      // @probe pv-wait
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(sc);                     // P is repacked after the wait
      // @probe pv-done
      if (t == 0) mbar_arrive(&empty[sp]);
      // once the rows' maxima settle, alpha is 1 and the rescale, exact
      // either way, is skipped
      if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
        for (int j = 0; j < DP / 8; ++j) {
          o[4 * j] *= alpha[0];
          o[4 * j + 1] *= alpha[0];
          o[4 * j + 2] *= alpha[1];
          o[4 * j + 3] *= alpha[1];
        }
      }
      pack_p<BK>(sc, hi, lo);
      // @probe packed
    }

    // the last tile's P V
    fence_regs(o);
    wgmma_fence();
    issue_pv<BK, DP, W::KV_BOX>(
        o, hi, lo,
        smem_u32(kvs + ((n_tiles - 1) % W::STAGES) * W::STAGE_BYTES) +
            W::KV_BYTES);
    wgmma_wait<0>();
    fence_regs(o);

    // @probe epilogue
    // epilogue: the 4 threads of a row hold parts of its l
    __nv_bfloat16* og = static_cast<__nv_bfloat16*>(p.o) + b * p.sob +
                        h * p.soh;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float lt = l[hh];
      lt += __shfl_xor_sync(0xffffffffu, lt, 1);
      lt += __shfl_xor_sync(0xffffffffu, lt, 2);
      lt = fmaxf(lt, 1e-30f);
      const int64_t row = q0 + r + 8 * hh;
      if (row < p.Sq && p.lse != nullptr && qd == 0)
        p.lse[(b * gridDim.x + h) * p.Sq + row] =
            fmaf(m[hh], 0.6931471805599453f, logf(lt));
      if (row < p.Sq) {
        __nv_bfloat16* orow = og + row * p.sos + 2 * qd;
#pragma unroll
        for (int j = 0; j < DP / 8; ++j) {
          if (8 * j < D) {
            *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
                __floats2bfloat162_rn(o[4 * j + 2 * hh] / lt,
                                      o[4 * j + 2 * hh + 1] / lt);
          }
        }
      }
    }
  }
}

template <int D>
int launch_wgmma(Params p, int64_t B, int64_t Hq, int64_t Hkv,
                 cudaStream_t stream) {
  using W = Wg<D>;
  CUtensorMap tq, tk, tv;
  int err = encode_map(&tq, p.q, D, p.Sq, Hq, B, p.sqs, p.sqh, p.sqb,
                       kWgRows);
  if (!err) err = encode_map(&tk, p.k, D, p.Sk, Hkv, B, p.sks, p.skh, p.skb,
                             W::BK);
  if (!err) err = encode_map(&tv, p.v, D, p.Sk, Hkv, B, p.svs, p.svh, p.svb,
                             W::BK);
  if (err) return err;
  cudaError_t cerr = cudaFuncSetAttribute(
      flash_fwd_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      W::SMEM);
  if (cerr != cudaSuccess) return (int)cerr;
  p.n_qtiles = (int)((p.Sq + kWgRows - 1) / kWgRows);
  const dim3 grid((unsigned)Hq, (unsigned)p.n_qtiles, (unsigned)B);
  flash_fwd_wgmma<D><<<grid, kWgThreads, W::SMEM, stream>>>(tq, tk, tv, p);
  return (int)cudaGetLastError();
}

int launch_simt(Params p, int D, int64_t B, int64_t Hq,
                cudaStream_t stream) {
  p.n_qtiles = (int)((p.Sq + kBQ - 1) / kBQ);
  const dim3 grid((unsigned)p.n_qtiles, (unsigned)Hq, (unsigned)B);
  const int smem = (kBQ * D + (D > kBQ ? D : kBQ) * kKS + kBK * D) *
                   (int)sizeof(float);
  void (*kernel)(const Params);
  switch (D) {
    case 32: kernel = flash_fwd_simt<32>; break;
    case 64: kernel = flash_fwd_simt<64>; break;
    case 80: kernel = flash_fwd_simt<80>; break;
    case 128: kernel = flash_fwd_simt<128>; break;
    case 192: kernel = flash_fwd_simt<192>; break;
    default: return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

int launch_wgmma_d(const Params& p, int D, int64_t B, int64_t Hq,
                   int64_t Hkv, cudaStream_t stream) {
  switch (D) {
    case 32: return launch_wgmma<32>(p, B, Hq, Hkv, stream);
    case 64: return launch_wgmma<64>(p, B, Hq, Hkv, stream);
    case 80: return launch_wgmma<80>(p, B, Hq, Hkv, stream);
    case 128: return launch_wgmma<128>(p, B, Hq, Hkv, stream);
    case 192: return launch_wgmma<192>(p, B, Hq, Hkv, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32 (flash_fwd_simt), 1 = bfloat16 (flash_fwd_wgmma).
// strides: 12 element strides, (batch, head, seq) of q, k, v and o in that
// order; the last axis of each is contiguous, and for bf16 every stride of
// an axis longer than 1 is a multiple of 8 elements and q, k and v start
// 16-byte aligned (TMA).  window <= 0 means none.  Returns 0 on success, a
// CUDA runtime error code, or 10000 (no tensor-map encoder in the driver)
// / 20000 + a CUresult (a tensor map was refused).  The caller handles
// Sq == 0 and Sk == 0 without a launch.  lse: null, or a contiguous
// (B, Hq, Sq) fp32 output of each row's log-sum-exp of the scaled,
// masked scores (natural log), written by either variant.
extern "C" int flash_attention_fwd(int dtype, int D, const void* q,
                                   const void* k, const void* v, void* o,
                                   float* lse, const int64_t* strides, int64_t B,
                                   int64_t Hq, int64_t Hkv, int64_t Sq,
                                   int64_t Sk, int64_t q_offset,
                                   int64_t window, int causal, float scale,
                                   void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Sq <= 0 || Sk <= 0 || Hq % Hkv ||
      B > 65535 || Hq > 65535 || Sq > 0x7fffffffLL || Sk > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.lse = lse;
  p.sqb = strides[0]; p.sqh = strides[1]; p.sqs = strides[2];
  p.skb = strides[3]; p.skh = strides[4]; p.sks = strides[5];
  p.svb = strides[6]; p.svh = strides[7]; p.svs = strides[8];
  p.sob = strides[9]; p.soh = strides[10]; p.sos = strides[11];
  p.Sq = Sq;
  p.Sk = Sk;
  p.q_offset = q_offset;
  p.window = window;
  p.group = (int)(Hq / Hkv);
  p.causal = causal;
  p.n_qtiles = 0;
  p.scale = scale;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return launch_simt(p, D, B, Hq, s);
  if (dtype == 1) {
    if ((Sq + kWgRows - 1) / kWgRows > 65535)        // grid.y
      return (int)cudaErrorInvalidValue;
    return launch_wgmma_d(p, D, B, Hq, Hkv, s);
  }
  return (int)cudaErrorInvalidValue;
}
