/*
 * Tensor-core and copy helpers shared by the scan kernels (ssm_scan.cu,
 * rwkv6_scan.cu): mma.sync m16n8k16 bf16 -> fp32, ldmatrix, cp.async, the
 * 16-byte-chunk swizzle of shared-memory tiles, the split of fp32 values
 * into bf16 terms, and the cluster barrier, mbarriers and st.async by
 * which the two blocks of a WKV cluster trade partial sums.
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

}  // namespace mma
