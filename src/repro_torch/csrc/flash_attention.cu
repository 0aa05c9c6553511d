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
 * flash_attention_pallas (body _flash_kernel).  What it computes is that
 * kernel's, step for step: q, k and v are read in their dtype and turned
 * into fp32; q is scaled in fp32; scores, the running max m, the running
 * sum l and the accumulator are fp32; p stays fp32 in the P.V product; l
 * is clamped at 1e-30 before the division.  Masks work on absolute
 * positions qp = q_offset + i and kp: causal keeps kp <= qp, a window W
 * keeps kp > qp - W, and a masked score is the finite NEG_INF = -1e30, so
 * a row that sees no key averages V over all Sk keys, as the reference's
 * attention_ref does.  Keys at kp >= Sk (the ragged end of the last tile)
 * take no part at all: where the Pallas wrapper pads K and V with zeros
 * and relies on the causal mask to hide them, this kernel masks them.
 *
 * Design.  On the TPU the kv-block axis is the innermost, sequential grid
 * axis and (m, l, acc) live in VMEM scratch across it.  Here one block of
 * 256 threads owns one (batch, query head, 64-row query tile) and walks
 * the kv tiles in a loop, so (m, l, acc) never leave registers:
 *   - the scaled Q tile (64 x D fp32) sits in shared memory for the whole
 *     loop; each kv tile of 64 keys is staged as K transposed (D x 68,
 *     so a thread reads its four keys of one d as one float4) and V (64 x
 *     D); the P tile (64 x 68) reuses K's space once the scores are done
 *     (that space holds max(D, 64) rows, so P fits at D = 32 too);
 *   - thread (ty, tx) of a 16 x 16 grid owns query rows 4ty..4ty+3: of
 *     the 64 x 64 scores it computes keys 4tx..4tx+3, of the output
 *     columns tx + 16j (j < D / 16).  A row's max and sum are reduced
 *     over its 16 threads with xor shuffles, which leave the same value in
 *     every lane, so the 16 copies of m and l agree bit for bit;
 *   - GQA is an index: kv head = q head / G, with the query heads ordered
 *     hk * G + g as repro's flash_attention_model_layout orders them;
 *   - tiles wholly above the causal diagonal or wholly left of the window
 *     are skipped (exact: a masked key adds exp(-1e30 - m) = 0 once a row
 *     has seen a visible key, and its p = 1 before that is cancelled by
 *     alpha = 0 when the first visible key comes).  A query tile holding
 *     a row with no visible key walks every tile instead, so that row
 *     averages V over all keys as the reference does;
 *   - causal query tiles are scheduled last-first, so the longest blocks
 *     start first;
 *   - ragged Sq and Sk are masked, never padded; offsets are 64-bit;
 *     there are no atomics, and every sum runs in an order fixed by the
 *     shapes, so two launches give bit-identical output.
 *
 * What bounds it.  At the Qwen2-7B prefill shape (B 4, Hq 28, Hkv 4,
 * S 2048, D 128, bf16, causal) the work is 4 * B * Hq * D * S(S+1)/2 =
 * 1.203e11 flops against 134,217,728 bytes of q, k, v and o: on bf16
 * tensor cores (989 TFLOP/s) the bound is 121.6 us, on the fp32 cores
 * this kernel uses (67 TFLOP/s) 1.796 ms; the bytes take 40.1 us at
 * 3.35 TB/s.  The kernel is bound by its fp32 FMAs and by shared-memory
 * reads (one float4 of Q and one of K per 16 FMAs, one float4 of P and
 * four scalars of V per 4 D/16-wide FMA groups); bf16 wgmma with TMA
 * tiles is the later step (ROADMAP Queue B #3).
 */
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;          // query rows of a block
constexpr int kBK = 64;          // keys of a kv tile
constexpr int kKS = kBK + 4;     // row stride of the K^T and P tiles
constexpr float kNegInf = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
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

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}
__device__ __forceinline__ int64_t max64(int64_t a, int64_t b) {
  return a > b ? a : b;
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ float lane(const float4& x, int j) {
  return j == 0 ? x.x : j == 1 ? x.y : j == 2 ? x.z : x.w;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd(const Params p) {
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

  const T* __restrict__ qg = static_cast<const T*>(p.q) + b * p.sqb +
                             h * p.sqh;
  const T* __restrict__ kg = static_cast<const T*>(p.k) + b * p.skb +
                             hk * p.skh;
  const T* __restrict__ vg = static_cast<const T*>(p.v) + b * p.svb +
                             hk * p.svh;
  T* __restrict__ og = static_cast<T*>(p.o) + b * p.sob + h * p.soh;

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
      T* orow = og + row * p.sos;
#pragma unroll
      for (int j = 0; j < kCols; ++j) store1(orow + tx + 16 * j, acc[i][j] / li);
    }
  }
}

template <typename T, int D>
int launch(const Params& p, int64_t B, int64_t Hq, cudaStream_t stream) {
  const int smem = (kBQ * D + (D > kBQ ? D : kBQ) * kKS + kBK * D) *
                   (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)p.n_qtiles, (unsigned)Hq, (unsigned)B);
  flash_fwd<T, D><<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(int D, const Params& p, int64_t B, int64_t Hq,
               cudaStream_t stream) {
  switch (D) {
    case 32: return launch<T, 32>(p, B, Hq, stream);
    case 64: return launch<T, 64>(p, B, Hq, stream);
    case 80: return launch<T, 80>(p, B, Hq, stream);
    case 128: return launch<T, 128>(p, B, Hq, stream);
    case 192: return launch<T, 192>(p, B, Hq, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  strides: 12 element strides, (batch,
// head, seq) of q, k, v and o in that order; the last axis of each is
// contiguous.  window <= 0 means none.  Returns cudaGetLastError() after
// the launch (0 = cudaSuccess).  The caller handles Sq == 0 and Sk == 0
// without a launch.
extern "C" int flash_attention_fwd(int dtype, int D, const void* q,
                                   const void* k, const void* v, void* o,
                                   const int64_t* strides, int64_t B,
                                   int64_t Hq, int64_t Hkv, int64_t Sq,
                                   int64_t Sk, int64_t q_offset,
                                   int64_t window, int causal, float scale,
                                   void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Sq <= 0 || Sk <= 0 || Hq % Hkv ||
      B > 65535 || Hq > 65535 || (Sq + kBQ - 1) / kBQ > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
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
  p.n_qtiles = (int)((Sq + kBQ - 1) / kBQ);
  p.scale = scale;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return dispatch_d<float>(D, p, B, Hq, s);
  if (dtype == 1) return dispatch_d<__nv_bfloat16>(D, p, B, Hq, s);
  return (int)cudaErrorInvalidValue;
}
