/*
 * Tensor-core and copy helpers shared by the scan kernels (ssm_scan.cu,
 * rwkv6_scan.cu): mma.sync m16n8k16 bf16 -> fp32, ldmatrix, cp.async, the
 * 16-byte-chunk swizzle of shared-memory tiles, the split of fp32 values
 * into bf16 terms and the sums of their term products, the compensated
 * (two-sum) scan of a chunk's cumsum, and the cluster barrier, mbarriers
 * and st.async by which the two blocks of a WKV cluster trade partial
 * sums.
 *
 * Fragment layouts of mma.m16n8k16 (g = lane / 4, q = lane % 4):
 *   A (16 x 16, row-major): a0 (row g, cols 2q, 2q+1), a1 (row g+8, cols
 *     2q, 2q+1), a2 (row g, cols 2q+8, 2q+9), a3 (row g+8, cols 2q+8,
 *     2q+9);
 *   B (16 x 8, "col"): b0 (rows 2q, 2q+1, col g), b1 (rows 2q+8, 2q+9,
 *     col g);
 *   C (16 x 8, fp32): c0, c1 (row g, cols 2q, 2q+1), c2, c3 (row g+8).
 * Each 32-bit register holds two bf16, the lower column (or row, for B)
 * in the low half.
 */
#pragma once
#include <cuda_bf16.h>
#include <stdint.h>

namespace mma {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// four 8 x 8 b16 matrices; lanes 8m..8m+7 give the row addresses of
// matrix m, register m holds (row g, cols 2q, 2q+1) of it
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// the same, transposed: register m holds (rows 2q, 2q+1, col g)
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// two matrices, transposed (lanes 0..15 give the addresses)
__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(addr));
}

// d += a b, bf16 operands, fp32 accumulator
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes from global to shared memory, asynchronously; src_bytes 0
// fills the 16 bytes with zeros and reads nothing
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :
               : "r"(dst), "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// 2^x by the MUFU unit (within 2 ulp; subnormal results flushed to 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Thread block clusters: the shared::cluster address of a shared-memory
// address in the block of rank `rank`, and the cluster-wide barrier
// (release / acquire: the stores before it are seen by every block of the
// cluster after it)
__device__ __forceinline__ uint32_t mapa(uint32_t addr, uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out)
               : "r"(addr), "r"(rank));
  return out;
}

// mbarriers fed by another block of the cluster: init (then a cluster
// barrier before anyone sends), the expected bytes of a phase, the wait
// for a phase by its parity, and st.async, a store into the other block's
// shared memory whose bytes count on its mbarrier (the sender does not
// wait for it)
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT_%=;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void st_async(uint32_t addr, float a, float b,
                                         uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.f32 [%0], "
      "{%1, %2}, [%3];\n" ::"r"(addr),
      "f"(a), "f"(b), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::
          : "memory");
}

// Byte offset of 16-byte chunk c of row r in a tile whose rows are W
// chunks (W in {2, 4, 8}: 32, 64 or 128 bytes).  The chunk index is XORed
// with bits of the row so that the 8 rows one ldmatrix matrix reads, at
// one logical chunk, fall in 8 different bank groups.
template <int W>
__device__ __forceinline__ int swz(int r, int c) {
  static_assert(W == 2 || W == 4 || W == 8, "rows of 2, 4 or 8 chunks");
  constexpr int s = W == 8 ? 0 : (W == 4 ? 1 : 2);
  return (r * W + (c ^ ((r >> s) & (W - 1)))) * 16;
}

// byte offset of bf16 element (r, col) of such a tile
template <int W>
__device__ __forceinline__ int swz_el(int r, int col) {
  return swz<W>(r, col >> 3) + (col & 7) * 2;
}

// cp.async of a tile of R rows of W 16-byte chunks into shared memory at
// dst, swizzled (swz<W>) or row after row: row r of the source starts at
// src + r * stride (elements), and rows at or past `valid` are zero-filled
// (read from src, at no cost).  Of T threads, thread tid copies chunk
// tid % W of rows tid / W + k T / W: each next row of a thread lies a
// whole number of swizzle periods further, so its address is one add.
template <int W, int R, int T, bool kSwz, typename E>
__device__ __forceinline__ void copy_rows(uint32_t dst, const E* src,
                                          int64_t stride, int valid,
                                          int tid) {
  constexpr int kStep = T / W;
  constexpr int kPass = (R + kStep - 1) / kStep;
  static_assert(T % W == 0 && (!kSwz || kStep % 8 == 0), "tiling");
  const int r0 = tid / W, c = tid % W;
  const E* p = src + r0 * stride + c * (16 / (int)sizeof(E));
  uint32_t d = dst + (r0 * W + c) * 16;
  if constexpr (kSwz) d = dst + swz<W>(r0, c);
#pragma unroll
  for (int k = 0; k < kPass; ++k) {
    const int r = r0 + k * kStep;
    if (kPass * kStep > R && r >= R) break;
    const bool ok = r < valid;
    cp_async16(d + k * kStep * W * 16, ok ? p + k * kStep * stride : src,
               ok ? 16 : 0);
  }
}

__device__ __forceinline__ uint32_t pack(__nv_bfloat162 h) {
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ float2 unpack(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&u));
}

// (a, b) as K bf16 pairs: t[0] = bf16(x), t[k] = bf16(x - t[0] - ... -
// t[k-1]).  Two terms hold x within 2^-18 of |x| (16 significant bits),
// three within 2^-27, below fp32's own rounding
template <int K>
__device__ __forceinline__ void split(float a, float b, uint32_t (&t)[K]) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    const float2 f = __bfloat1622float2(h);
    t[k] = pack(h);
    a -= f.x;
    b -= f.y;
  }
}

// ---- fp32 factors as three bf16 terms (ssd_fwd_mma_f32, ssd_bwd_mma_f32) ----

// d += a b over the term products of a KA-term and a KB-term factor with
// i + j < max(KA, KB), the small ones first and the main pair (0, 0) last
// (kernels/ssm_scan/ref.py's _tc_mm), for the 2 kJ n8 tiles of kJ x4 B
// loads (d[2 j], d[2 j + 1] from b[j]), the sums' products interleaved so
// that no product waits for the one before
template <int KA, int KB, int kJ, int kD>
__device__ __forceinline__ void mma_terms_xn(float (&d)[kD][4],
                                             const uint32_t (&a)[KA][4],
                                             const uint32_t (&b)[kJ][KB][4]) {
  static_assert(kD == 2 * kJ, "two n8 tiles a load");
  constexpr int kTop = (KA > KB ? KA : KB) - 1;
#pragma unroll
  for (int i = 0; i < KA; ++i)
#pragma unroll
    for (int j = 0; j < KB; ++j)
      if (i + j > 0 && i + j <= kTop) {
#pragma unroll
        for (int n = 0; n < kJ; ++n) {
          mma::mma_bf16(d[2 * n], a[i], b[n][j][0], b[n][j][1]);
          mma::mma_bf16(d[2 * n + 1], a[i], b[n][j][2], b[n][j][3]);
        }
      }
#pragma unroll
  for (int n = 0; n < kJ; ++n) {
    mma::mma_bf16(d[2 * n], a[0], b[n][0][0], b[n][0][1]);
    mma::mma_bf16(d[2 * n + 1], a[0], b[n][0][2], b[n][0][3]);
  }
}

// the same for kN n8 tiles of x2 B loads, the kN sums' products
// interleaved, so that no product waits for the one before
template <int KA, int KB, int kN>
__device__ __forceinline__ void mma_terms_n(float (&d)[kN][4],
                                            const uint32_t (&a)[KA][4],
                                            const uint32_t (&b)[kN][KB][2]) {
  constexpr int kTop = (KA > KB ? KA : KB) - 1;
#pragma unroll
  for (int i = 0; i < KA; ++i)
#pragma unroll
    for (int j = 0; j < KB; ++j)
      if (i + j > 0 && i + j <= kTop) {
#pragma unroll
        for (int n = 0; n < kN; ++n)
          mma::mma_bf16(d[n], a[i], b[n][j][0], b[n][j][1]);
      }
#pragma unroll
  for (int n = 0; n < kN; ++n) mma::mma_bf16(d[n], a[0], b[n][0][0], b[n][0][1]);
}

// ldmatrix of the K term planes of a tile, `plane` bytes apart
template <int K>
__device__ __forceinline__ void ldsm_k(uint32_t (&r)[K][4], uint32_t addr,
                                       int plane) {
#pragma unroll
  for (int k = 0; k < K; ++k) mma::ldsm_x4(r[k], addr + k * plane);
}
template <int K>
__device__ __forceinline__ void ldsm_k_t(uint32_t (&r)[K][4], uint32_t addr,
                                         int plane) {
#pragma unroll
  for (int k = 0; k < K; ++k) mma::ldsm_x4_t(r[k], addr + k * plane);
}

// the fp32 pair at (row, col), (row, col + 1) of a three-term tile of W
// chunks a row: its terms summed, (t0 + t1) + t2, which is exact
template <int W>
__device__ __forceinline__ float2 pair3(const unsigned char* tile, int plane,
                                        int row, int col) {
  const int off = mma::swz_el<W>(row, col);
  const float2 a = mma::unpack(*reinterpret_cast<const uint32_t*>(tile + off));
  const float2 b = mma::unpack(
      *reinterpret_cast<const uint32_t*>(tile + plane + off));
  const float2 c = mma::unpack(
      *reinterpret_cast<const uint32_t*>(tile + 2 * plane + off));
  return make_float2((a.x + b.x) + c.x, (a.y + b.y) + c.y);
}

// s + e = a + b exactly (Knuth's two-sum)
__device__ __forceinline__ void two_sum(float& s, float& e, float a,
                                        float b) {
  s = a + b;
  const float bb = s - a;
  e = (a - (s - bb)) + (b - bb);
}

// inclusive prefix sums of (h0, l0) at row lane and (h1, l1) at row lane +
// 32 over the 64 rows, by one warp, each an unevaluated sum hi + lo that
// keeps the bits a plain fp32 cumsum rounds away
__device__ __forceinline__ void scan64_2(float& h0, float& l0, float& h1,
                                         float& l1, int lane) {
  float s, e;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float uh0 = __shfl_up_sync(0xffffffffu, h0, o);
    const float ul0 = __shfl_up_sync(0xffffffffu, l0, o);
    const float uh1 = __shfl_up_sync(0xffffffffu, h1, o);
    const float ul1 = __shfl_up_sync(0xffffffffu, l1, o);
    if (lane >= o) {
      two_sum(s, e, h0, uh0);
      h0 = s;
      l0 += ul0 + e;
      two_sum(s, e, h1, uh1);
      h1 = s;
      l1 += ul1 + e;
    }
  }
  const float th = __shfl_sync(0xffffffffu, h0, 31);
  const float tl = __shfl_sync(0xffffffffu, l0, 31);
  two_sum(s, e, h1, th);
  h1 = s;
  l1 += tl + e;
}

// exp2 of hi + lo; of a difference of two compensated sums
__device__ __forceinline__ float exp2_2(float h, float l) {
  return mma::fast_exp2(h) * mma::fast_exp2(l);
}
__device__ __forceinline__ float exp2_d(float ha, float la, float hb,
                                        float lb) {
  return mma::fast_exp2((ha - hb) + (la - lb));
}

}  // namespace mma
