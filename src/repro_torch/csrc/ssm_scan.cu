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
 * The three variants replace the TPU kernel
 * repro/kernels/ssm_scan/kernel.py:66 ssm_scan_pallas (body _ssd_kernel)
 * and compute its chunked form: per
 * chunk, the within-chunk cumulative log-decay seg = cumsum(dt * A); the
 * intra-chunk term M = (C B^T) o exp(seg_i - seg_l) [l <= i] and
 * y = M (x dt); the inter-chunk term exp(seg_i) C_i . state; and the state
 * update state <- exp(seg_last) state + sum_l exp(seg_last - seg_l)
 * (x_l dt_l) (x) B_l.  On the TPU the chunk axis is the innermost,
 * sequential grid axis and the (P, N) state carries in VMEM scratch across
 * it; on Hopper no state carries from one block to the next, so a block
 * walks the chunks of S in a loop with the fp32 state on the SM.  fp32
 * x, B and C launch ssd_fwd_mma_f32 and bf16 ones ssd_fwd_mma, with no
 * fallback between them; ssd_fwd_simt runs only where asked for by name
 * (the yardstick of the tests and chip_smoke.py).
 *
 * What bounds the function.  At the zamba2-1.2b prefill shape (B 4, S 4096,
 * H 64, P 64, N 64, one group, bf16 x/B/C, fp32 dt, no h0) it reads and
 * writes 415,236,352 bytes: 123.9 us at 3.35 TB/s.  The chunked form at
 * chunk 64 takes 2.59e10 flops: 26 us on bf16 tensor cores, so the bytes
 * bound it, but 387 us on the fp32 cores.
 *
 * ssd_fwd_simt<T, TD, P, N>, fp32 inputs, by name only (the yardstick).
 * One block of 256 threads owns one (batch, head), the fp32 state in
 * shared memory for the whole walk:
 *   - the chunk length inside the kernel is 64, whatever chunk the plain
 *     path uses: x dt, B and C of a chunk (64 rows each), the state and
 *     the 64 x 64 masked decay matrix fit in 84,224 bytes of shared memory
 *     at P = N = 64.  Rows are padded by one float, so the 16 threads of a
 *     half-warp that read one column of 16 rows hit 16 banks;
 *   - seg is an inclusive warp scan (shuffles) of dt * A; exp(seg_i - seg_l)
 *     is taken only where l <= i.  Above the diagonal the difference is
 *     positive and its exp can overflow to inf: it is never used, so no
 *     inf * 0 can occur;
 *   - the three products (C B^T, M (x dt) with C state^T, and the state
 *     update) are register-tiled on a 16 x 16 thread grid, fp32 FMAs,
 *     each output summed in a fixed order.
 *   Bound by its SIMT FMAs and the shared-memory reads that feed them.
 *
 * ssd_fwd_mma<TD, PB, N>, bf16 x, B and C (the serve path).  The three
 * chunk products on tensor cores, mma.sync m16n8k16 bf16 -> fp32, with the
 * fp32 factors carried as two bf16 terms, hi = bf16(a) and lo = bf16(a -
 * hi) (16 significant bits; mma.cuh):
 *   - P is split over two blocks, each owning PB = P / 2 columns of x, y
 *     and the state: the state's rows are independent given C B^T and the
 *     decays, so the split is exact, and it gives 2 B H = 512 blocks of
 *     128 threads at the zamba2 shape, four on an SM (49.5 KB of shared
 *     memory, at most 128 registers a thread), where one block a (batch,
 *     head) would leave two 8-warp blocks an SM to hide every latency.
 *     Each block forms the chunk's C B^T itself: sharing it across the
 *     heads of a group (zamba2 has 64 heads on one group) would need a
 *     block to own several heads, and fewer blocks than the card has SMs;
 *     the product is 1/6 of the block's tensor-core work;
 *   - staging: x, B and C of chunk c + 1 are copied by cp.async into the
 *     second of two stage buffers while chunk c computes (dt through a
 *     register), 16-byte chunks XOR-swizzled so that ldmatrix reads hit
 *     every bank; rows past S are zero-filled by the copy itself;
 *   - warp w owns query rows 16w..16w+15 of the chunk.  Per chunk:
 *     C_i . state^T with the state as hi + lo (two products, B operand
 *     from shared memory), scaled by exp(seg_i); then for each 16-column
 *     tile l <= the warp's rows, C B^T (exact bf16 operands, one product),
 *     M' = (C B^T) o exp(seg_i - seg_l) o dt_l in registers (exp only
 *     where l <= i), and y += M' x with M' as hi + lo from the accumulator
 *     registers (x bf16-exact: dt is folded into M'); tiles above the
 *     diagonal are skipped;
 *   - the state stays in fp32 registers, warp w owning state columns
 *     16w..16w+15: state <- exp(seg_last) state + x^T (B o exp(seg_last -
 *     seg_l) dt_l), the right factor as hi + lo (two products); after the
 *     chunk's last read of the old state its hi and lo terms are written
 *     to shared memory for the next chunk's C . state^T;
 *   - seg is a warp scan of dt * A * log2(e), formed by every warp for
 *     itself, so a chunk costs two block barriers, and every decay is one
 *     ex2.approx of a difference <= 0.
 *   Tensor-core work at the zamba2 shape: 2.9e10 multiply-adds with the
 *   split terms and the duplicated C B^T, about 60 us at the dense bf16
 *   rate, so the bytes still bound it.  What holds it back
 *   (tools/scan_probe.py): the latency of each warp's walk over its
 *   column tiles of C B^T and M' x (warp 3 walks four, warp 0 one) and of
 *   the state update, with 16 warps an SM.
 *
 * ssd_fwd_mma_f32<TD, PB, N>, fp32 x, B and C (fp32 training, the fp32
 * prefill).  ssd_fwd_mma's blocks, warps and orientation, with every
 * factor of a tensor-core product as three bf16 terms, mma::split<3> (a
 * product of two such six mma: hi.hi, hi.mid, mid.hi, hi.lo, mid.mid,
 * lo.hi, the small ones first; what the dropped pairs leave is below
 * fp32's rounding): x, B, C, the state in C . state^T, M' and B o w o dt
 * in the state update.  The fewest terms with which the float64 mirror of
 * these rounding points (ref.ssm_scan_fwd_f32_mirror,
 * tests/test_torch_ssm_scan.py) keeps y and the final state within 2x of
 * ssd_fwd_simt's float64 distance at every shape; two for any one factor
 * put one of them 18-95x as far.  Three more rules, the last for speed:
 *   - the within-chunk cumsum of dt A log2 e is a compensated pair (a
 *     two-sum warp scan, mma::scan64_2), every decay exp2 of a difference
 *     of two such;
 *   - the tensor cores truncate each mma's sum, so each k-step's products
 *     (C B^T's and C . state^T's over N, M' x's a column tile, the state
 *     update's over rows) go into a zeroed partial added to its sum
 *     rounded to nearest (one partial a product: y 2.4-3x ssd_fwd_simt's
 *     distance at S 1);
 *   - speed: shared memory holds one chunk's three planes each of x, B,
 *     C and the state (74,496 bytes at P = N = 64), so three blocks fit
 *     an SM (at most 168 registers a thread; 16 bytes spill at P = N =
 *     64).  B and C, which every head of a group and both halves of P
 *     read, are split into their planes once, by ssd_split3_bc, a
 *     pre-pass over B and C into a workspace (2 x (B, G, 3, S, N) bf16),
 *     and copied to shared memory by cp.async; x's fp32 rows are read as
 *     float4 into registers and split as they land (B and C split so in
 *     every block left the load round ~1.5x as long: tools/scan_probe.py
 *     --fp32, PERF.md); warp 0 scans dt for the block in the same round.
 *   C . state^T is skipped on chunk 0 without h0 (the state is zero).
 *   What bounds it at zamba2 100m's training shape (B 32, S 128, H 24,
 *   P = N = 64, no h0): the term products the call needs, 1.22e10 flops,
 *   take 12.3 us at 989 TFLOP/s, its 65.4 MB 19.5 us at 3.35 TB/s: the
 *   bytes (chip_smoke.py's ssd_fwd_bounds).  The kernel issues 1.3x those
 *   products on mma.sync, and what holds it back (tools/scan_probe.py
 *   --fp32, cycles by phase) is the load round of each chunk, which the
 *   block does not overlap with its own products, and the triangle: warp
 *   3 walks four column tiles of C B^T and M' x, warp 0 one, and every
 *   chunk's two barriers wait for warp 3.
 *
 * Shared by all: groups are an index (head h reads B and C of group
 * h / (H / G)), not a copy; every tensor is read and written through its
 * strides, so the model's (B, S, H, P) layout needs no transpose; the
 * ragged last chunk is masked: rows past S are never loaded (they hold
 * zeros in shared memory, and dt past S is 0, so seg_last is the last
 * valid row's); no atomics, and every sum runs in an order fixed by the
 * shapes, so two launches give bit-identical output.
 *
 * Lines "// @probe <name>" (ssd_fwd_mma) and "// @probe f32 <name>"
 * (ssd_fwd_mma_f32) mark where tools/scan_probe.py inserts clock reads,
 * or its deliberate faults, into a copy of this source; they are comments
 * and compile to nothing.
 */
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

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
  // ssd_fwd_mma_f32: B's and C's three bf16 term planes, each (B, G, 3,
  // S, N) contiguous (ssd_split3_bc's output)
  __nv_bfloat16* bpl;
  __nv_bfloat16* cpl;
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
ssd_fwd_simt(const Params p) {
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

// ---------------------------------------------------------------------------
// ssd_fwd_mma: bf16 x, B and C on tensor cores
// ---------------------------------------------------------------------------

constexpr int kMmaThreads = 128;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kPSplit = 2;       // blocks per (batch, head), P / 2 columns each

// Shared memory of one block, in bytes: two stages of x [kL][PB], B and C
// [kL][N] (bf16, swizzled) and dt [kL] (fp32); the state's hi and lo
// terms [PB][N] (bf16, swizzled); each warp's seg [kL] (fp32).  The
// Python wrapper's smem_bytes mirrors this.
template <int PB, int N>
struct SsdTile {
  static constexpr int kX = kL * PB * 2;
  static constexpr int kBC = kL * N * 2;
  static constexpr int kStage = kX + 2 * kBC + kL * 4;
  static constexpr int kState = PB * N * 2;
  static constexpr int kBytes = 2 * kStage + 2 * kState + 4 * kL * 4;
};

// d0 += a b[0..1], d1 += a b[2..3]: two n8 tiles from one x4 B load
__device__ __forceinline__ void mma_x2(float (&d0)[4], float (&d1)[4],
                                       const uint32_t (&a)[4],
                                       const uint32_t (&b)[4]) {
  mma::mma_bf16(d0, a, b[0], b[1]);
  mma::mma_bf16(d1, a, b[2], b[3]);
}

template <typename TD, int PB, int N>
__global__ void __launch_bounds__(kMmaThreads, 4)
ssd_fwd_mma(const Params p) {
  static_assert((PB == 16 || PB == 32) && (N == 16 || N == 64), "tiling");
  using Tl = SsdTile<PB, N>;
  constexpr int kWX = PB / 8;    // 16-byte chunks in a row of x
  constexpr int kWN = N / 8;     // ... of B, C and the state terms
  constexpr int kYT = PB / 8;    // n8 tiles of a warp's y rows
  constexpr int kNK = N / 16;    // k-steps over N
  constexpr int kPT = PB / 16;   // m16 tiles of the state over P
  extern __shared__ __align__(128) unsigned char smem_b[];
  unsigned char* smem = smem_b;
  unsigned char* st_hi = smem + 2 * Tl::kStage;
  unsigned char* st_lo = st_hi + Tl::kState;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int q = lane & 3;
  float* segw = reinterpret_cast<float*>(st_lo + Tl::kState) + warp * kL;
  const int h = blockIdx.x / kPSplit;
  const int half = blockIdx.x % kPSplit;
  const int64_t b = blockIdx.y;
  const int64_t grp = h / p.rep;
  const float A = p.A[h] * kLog2e;   // seg in log2 units: exp = ex2
  const __nv_bfloat16* xg = static_cast<const __nv_bfloat16*>(p.x) +
                            b * p.sxb + h * p.sxh + half * PB;
  const TD* dg = static_cast<const TD*>(p.dt) + b * p.sdb + h * p.sdh;
  const __nv_bfloat16* bg =
      static_cast<const __nv_bfloat16*>(p.bm) + b * p.sbb + grp * p.sbg;
  const __nv_bfloat16* cg =
      static_cast<const __nv_bfloat16*>(p.cm) + b * p.scb + grp * p.scg;
  float* yg = p.y + b * p.syb + h * p.syh + half * PB;
  const int64_t so = ((b * p.H + h) * kPSplit + half) * (int64_t)(PB * N);

  // x, B and C of the chunk at c0 into a stage, rows past S zero-filled
  auto prefetch = [&](int64_t c0, unsigned char* s) {
    const int Lc = (int)(p.S - c0 < kL ? p.S - c0 : kL);
    const uint32_t sx = mma::smem_u32(s);
    mma::copy_rows<kWX, kL, kMmaThreads, true>(sx, xg + c0 * p.sxs, p.sxs,
                                               Lc, tid);
    mma::copy_rows<kWN, kL, kMmaThreads, true>(sx + Tl::kX, bg + c0 * p.sbs,
                                               p.sbs, Lc, tid);
    mma::copy_rows<kWN, kL, kMmaThreads, true>(
        sx + Tl::kX + Tl::kBC, cg + c0 * p.scs, p.scs, Lc, tid);
    mma::cp_async_commit();
  };
  auto load_dt = [&](int64_t c0) {
    return tid < kL && c0 + tid < p.S ? ld(dg + (c0 + tid) * p.sds) : 0.f;
  };
  auto dt_of = [&](int cur) {
    return reinterpret_cast<float*>(smem + cur * Tl::kStage + Tl::kX +
                                    2 * Tl::kBC);
  };

  // the state, fp32 in registers: warp w owns columns n in [16w, 16w + 16)
  // (n-tiles 2w and 2w + 1) of every row of the block's PB
  const bool owns = warp < N / 16;
  float st[kPT][2][4];
#pragma unroll
  for (int pt = 0; pt < kPT; ++pt)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = 16 * pt + g + 8 * (e >> 1);
        const int n = 16 * warp + 8 * j + 2 * q + (e & 1);
        st[pt][j][e] = owns && p.h0 ? p.h0[so + row * N + n] : 0.f;
      }
  // the state's hi and lo terms into shared memory, [row][n]
  auto write_state = [&]() {
    if (!owns) return;
#pragma unroll
    for (int pt = 0; pt < kPT; ++pt)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int row = 16 * pt + g + 8 * hr;
          const int n = 16 * warp + 8 * j + 2 * q;
          uint32_t t[2];
          mma::split<2>(st[pt][j][2 * hr], st[pt][j][2 * hr + 1], t);
          *reinterpret_cast<uint32_t*>(st_hi + mma::swz_el<kWN>(row, n)) =
              t[0];
          *reinterpret_cast<uint32_t*>(st_lo + mma::swz_el<kWN>(row, n)) =
              t[1];
        }
  };

  const int64_t n_chunks = (p.S + kL - 1) / kL;
  prefetch(0, smem);
  if (tid < kL) dt_of(0)[tid] = load_dt(0);
  write_state();
  // @probe start
  for (int64_t c = 0; c < n_chunks; ++c) {
    const int cur = (int)(c & 1);
    const int64_t c0 = c * kL;
    const int Lc = (int)(p.S - c0 < kL ? p.S - c0 : kL);
    mma::cp_async_wait_all();
    __syncthreads();             // chunk c, its dt and the state terms
    // @probe phase:wait
    float dt_next = 0.f;
    if (c + 1 < n_chunks) {
      prefetch(c0 + kL, smem + (cur ^ 1) * Tl::kStage);
      dt_next = load_dt(c0 + kL);
    }
    const float* dts = dt_of(cur);
    const uint32_t sx = mma::smem_u32(smem + cur * Tl::kStage);
    const uint32_t sb = sx + Tl::kX;
    const uint32_t sc = sb + Tl::kBC;

    {                            // seg: an inclusive scan of dt * A
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
      segw[lane] = a0;
      segw[lane + 32] = a1;
      __syncwarp();
    }
    const float seg_last = segw[kL - 1];
    const int i0 = 16 * warp;    // the warp's rows of the chunk
    const int ia = i0 + g, ib = ia + 8;
    const float seg_a = segw[ia], seg_b = segw[ib];

    uint32_t cf[kNK][4];         // C, the warp's 16 rows, as A operands
#pragma unroll
    for (int kk = 0; kk < kNK; ++kk)
      mma::ldsm_x4(cf[kk], sc + mma::swz<kWN>(i0 + (lane & 15),
                                              2 * kk + (lane >> 4)));

    // @probe phase:seg
    // y = exp(seg_i) C_i . state^T, the state as hi + lo
    float y[kYT][4] = {};
#pragma unroll
    for (int kk = 0; kk < kNK; ++kk)
#pragma unroll
      for (int jp = 0; jp < kYT / 2; ++jp) {
        const int off = mma::swz<kWN>(16 * jp + (lane & 7) + 8 * (lane >> 4),
                                      2 * kk + ((lane >> 3) & 1));
        uint32_t r[4];
        mma::ldsm_x4(r, mma::smem_u32(st_hi) + off);
        mma_x2(y[2 * jp], y[2 * jp + 1], cf[kk], r);
        mma::ldsm_x4(r, mma::smem_u32(st_lo) + off);
        mma_x2(y[2 * jp], y[2 * jp + 1], cf[kk], r);
      }
    {
      const float ea = mma::fast_exp2(seg_a), eb = mma::fast_exp2(seg_b);
#pragma unroll
      for (int j = 0; j < kYT; ++j) {
        y[j][0] *= ea;
        y[j][1] *= ea;
        y[j][2] *= eb;
        y[j][3] *= eb;
      }
    }

    // @probe phase:inter
    // y += M' x over the 16-column tiles jj <= warp: M' = (C B^T) o
    // exp(seg_i - seg_l) o dt_l where l <= i, else 0
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      if (jj > warp) break;
      float cb[2][4] = {};
#pragma unroll
      for (int kk = 0; kk < kNK; ++kk) {
        uint32_t r[4];
        mma::ldsm_x4(r, sb + mma::swz<kWN>(16 * jj + (lane & 7) +
                                               8 * (lane >> 4),
                                           2 * kk + ((lane >> 3) & 1)));
        mma_x2(cb[0], cb[1], cf[kk], r);
      }
      uint32_t mhi[4], mlo[4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int l0 = 16 * jj + 8 * j + 2 * q;
        const float s0 = segw[l0], s1 = segw[l0 + 1];
        const float d0 = dts[l0], d1 = dts[l0 + 1];
        float m[4];
        m[0] = l0 <= ia ? cb[j][0] * mma::fast_exp2(seg_a - s0) * d0 : 0.f;
        m[1] = l0 + 1 <= ia ? cb[j][1] * mma::fast_exp2(seg_a - s1) * d1 : 0.f;
        m[2] = l0 <= ib ? cb[j][2] * mma::fast_exp2(seg_b - s0) * d0 : 0.f;
        m[3] = l0 + 1 <= ib ? cb[j][3] * mma::fast_exp2(seg_b - s1) * d1 : 0.f;
        uint32_t t[2];
        mma::split<2>(m[0], m[1], t);      // row g: a0 (j 0), a2 (j 1)
        mhi[2 * j] = t[0];
        mlo[2 * j] = t[1];
        mma::split<2>(m[2], m[3], t);      // row g + 8: a1, a3
        mhi[2 * j + 1] = t[0];
        mlo[2 * j + 1] = t[1];
      }
#pragma unroll
      for (int jp = 0; jp < kYT / 2; ++jp) {
        uint32_t r[4];
        mma::ldsm_x4_t(r, sx + mma::swz<kWX>(16 * jj + (lane & 15),
                                             2 * jp + (lane >> 4)));
        mma_x2(y[2 * jp], y[2 * jp + 1], mhi, r);
        // @probe one_term (the next line)
        mma_x2(y[2 * jp], y[2 * jp + 1], mlo, r);
      }
    }
#pragma unroll
    for (int j = 0; j < kYT; ++j) {
      const int col = 8 * j + 2 * q;
      if (ia < Lc)
        *reinterpret_cast<float2*>(yg + (c0 + ia) * p.sys + col) =
            make_float2(y[j][0], y[j][1]);
      if (ib < Lc)
        *reinterpret_cast<float2*>(yg + (c0 + ib) * p.sys + col) =
            make_float2(y[j][2], y[j][3]);
    }

    // @probe phase:intra
    // state <- exp(seg_last) state + x^T B', B' = B o exp(seg_last - seg_l)
    // dt_l as hi + lo
    auto update_state = [&]() {
      if (!owns) return;
      const float decay = mma::fast_exp2(seg_last);
#pragma unroll
      for (int pt = 0; pt < kPT; ++pt)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) st[pt][j][e] *= decay;
#pragma unroll
      for (int kk = 0; kk < kL / 16; ++kk) {
        uint32_t r[4];
        mma::ldsm_x4_t(r, sb + mma::swz<kWN>(16 * kk + (lane & 15),
                                             2 * warp + (lane >> 4)));
        const int la = 16 * kk + 2 * q, lb = la + 8;
        const float w[4] = {mma::fast_exp2(seg_last - segw[la]) * dts[la],
                            mma::fast_exp2(seg_last - segw[la + 1]) * dts[la + 1],
                            mma::fast_exp2(seg_last - segw[lb]) * dts[lb],
                            mma::fast_exp2(seg_last - segw[lb + 1]) * dts[lb + 1]};
        uint32_t bh[4], bl[4];
#pragma unroll
        for (int m = 0; m < 4; ++m) {    // r[0], r[2]: rows la; r[1], r[3]: lb
          const float2 f = mma::unpack(r[m]);
          uint32_t t[2];
          mma::split<2>(f.x * w[2 * (m & 1)], f.y * w[2 * (m & 1) + 1], t);
          bh[m] = t[0];
          bl[m] = t[1];
        }
#pragma unroll
        for (int pt = 0; pt < kPT; ++pt) {
          uint32_t xa[4];
          mma::ldsm_x4_t(xa, sx + mma::swz<kWX>(16 * kk + (lane & 7) +
                                                    8 * (lane >> 4),
                                                2 * pt + ((lane >> 3) & 1)));
          mma_x2(st[pt][0], st[pt][1], xa, bh);
          mma_x2(st[pt][0], st[pt][1], xa, bl);
        }
      }
    };
    // @probe state-update (the next line)
    update_state();
    // @probe phase:state
    __syncthreads();             // every warp is done with the old state
    // @probe phase:barrier
    write_state();
    if (tid < kL) dt_of(cur ^ 1)[tid] = dt_next;
    // @probe phase:tail
  }
  // @probe epilogue
  if (owns)
#pragma unroll
    for (int pt = 0; pt < kPT; ++pt)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int row = 16 * pt + g + 8 * hr;
          const int n = 16 * warp + 8 * j + 2 * q;
          *reinterpret_cast<float2*>(p.hf + so + row * N + n) =
              make_float2(st[pt][j][2 * hr], st[pt][j][2 * hr + 1]);
        }
}

// ---------------------------------------------------------------------------
// ssd_fwd_mma_f32: fp32 x, B and C on tensor cores, every factor in three
// bf16 terms
// ---------------------------------------------------------------------------

constexpr int kT3 = 3;           // bf16 terms of every factor

// Shared memory of one ssd_fwd_mma_f32 block, in bytes: three bf16 term
// planes each of x [kL][PB], B and C [kL][N] and the state [PB][N] (all
// swizzled); then fp32 dt [kL] and the compensated seg, hi [kL] and lo
// [kL].  The Python wrapper's smem_bytes mirrors this.
template <int PB, int N>
struct SsdTileF32 {
  static constexpr int kX = kL * PB * 2;   // one plane of x
  static constexpr int kBC = kL * N * 2;   // ... of B or C
  static constexpr int kS = PB * N * 2;    // ... of the state
  static constexpr int oB = kT3 * kX;
  static constexpr int oC = oB + kT3 * kBC;
  static constexpr int oS = oC + kT3 * kBC;
  static constexpr int oF = oS + kT3 * kS;
  static constexpr int kBytes = oF + 3 * kL * 4;
};

// The kL rows of C fp32 columns of a chunk (x's half of P; 0 at rows
// past Lc) into registers and then, as three bf16 terms, into the planes
// of a swizzled tile (C / 8 chunks a row, `plane` bytes apart): thread
// tid loads float4 e = tid + i kMmaThreads of the tile, every load issued
// before the first split, so that their latencies overlap
template <int C>
struct RowsF32 {
  static constexpr int kC4 = C / 4;
  static constexpr int kIt = kL * kC4 / kMmaThreads;
  static_assert(kL * kC4 % kMmaThreads == 0, "tiling");
  float4 v[kIt];

  __device__ __forceinline__ void load(const float* src, int64_t rs, int Lc,
                                       int tid) {
#pragma unroll
    for (int i = 0; i < kIt; ++i) {
      const int e = tid + i * kMmaThreads, row = e / kC4, col = 4 * (e % kC4);
      v[i] = row < Lc
          ? *reinterpret_cast<const float4*>(src + row * rs + col)
          : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }

  __device__ __forceinline__ void split(unsigned char* dst, int plane,
                                        int tid) const {
#pragma unroll
    for (int i = 0; i < kIt; ++i) {
      const int e = tid + i * kMmaThreads, row = e / kC4, col = 4 * (e % kC4);
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

// B and C (fp32, read through their strides as float4) as three bf16
// term planes each, contiguous (B, G, 3, S, N): thread e of the grid
// splits float4 e of B's rows, then of C's
constexpr int kSplitThreads = 256;

template <int N>
__global__ void __launch_bounds__(kSplitThreads)
ssd_split3_bc(const Params p, int64_t rows) {
  constexpr int kC4 = N / 4;
  const int64_t total = rows * kC4;
  const int64_t e = (int64_t)blockIdx.x * kSplitThreads + threadIdx.x;
  if (e >= 2 * total) return;
  const bool is_c = e >= total;
  const int64_t f = is_c ? e - total : e;
  const int64_t row = f / kC4;               // (b, g, s), s fastest
  const int col = 4 * (int)(f % kC4);
  const int64_t s = row % p.S, bg = row / p.S;
  const int64_t G = p.H / p.rep, g = bg % G, b = bg / G;
  const float* src =
      is_c ? static_cast<const float*>(p.cm) + b * p.scb + g * p.scg +
                 s * p.scs
           : static_cast<const float*>(p.bm) + b * p.sbb + g * p.sbg +
                 s * p.sbs;
  const float4 v = *reinterpret_cast<const float4*>(src + col);
  uint32_t lo[kT3], hi[kT3];
  mma::split<kT3>(v.x, v.y, lo);
  mma::split<kT3>(v.z, v.w, hi);
  __nv_bfloat16* dst = (is_c ? p.cpl : p.bpl) + bg * kT3 * p.S * N +
                       s * N + col;
#pragma unroll
  for (int k = 0; k < kT3; ++k)
    *reinterpret_cast<uint2*>(dst + k * p.S * N) = make_uint2(lo[k], hi[k]);
}

template <typename TD, int PB, int N>
__global__ void __launch_bounds__(kMmaThreads, 3)
ssd_fwd_mma_f32(const Params p) {
  static_assert((PB == 16 || PB == 32) && (N == 16 || N == 64), "tiling");
  using Tl = SsdTileF32<PB, N>;
  constexpr int kWX = PB / 8;    // 16-byte chunks in a row of a plane of x
  constexpr int kWN = N / 8;     // ... of B, C and the state
  constexpr int kYT = PB / 8;    // n8 tiles of a warp's y rows
  constexpr int kNK = N / 16;    // k-steps over N
  constexpr int kPT = PB / 16;   // m16 tiles of the state over P
  extern __shared__ __align__(128) unsigned char smem_f[];
  unsigned char* smem = smem_f;
  const uint32_t sx = mma::smem_u32(smem);
  const uint32_t sb = sx + Tl::oB, sc = sx + Tl::oC, ss = sx + Tl::oS;
  float* dts = reinterpret_cast<float*>(smem + Tl::oF);   // [kL]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int q = lane & 3;
  float* segw = dts + kL;        // [kL] seg hi, log2 units
  float* seglw = segw + kL;      // [kL] seg lo
  const int h = blockIdx.x / kPSplit;
  const int half = blockIdx.x % kPSplit;
  const int64_t b = blockIdx.y;
  const int64_t grp = h / p.rep;
  const float A2 = p.A[h] * kLog2e;
  const float* xg = static_cast<const float*>(p.x) + b * p.sxb +
                    h * p.sxh + half * PB;
  const TD* dg = static_cast<const TD*>(p.dt) + b * p.sdb + h * p.sdh;
  // the first term plane of B and of C of (b, grp); plane k is k S N
  // elements further
  const int64_t pln = p.S * N;
  const __nv_bfloat16* bpg =
      p.bpl + (b * (p.H / p.rep) + grp) * kT3 * pln;
  const __nv_bfloat16* cpg =
      p.cpl + (b * (p.H / p.rep) + grp) * kT3 * pln;
  float* yg = p.y + b * p.syb + h * p.syh + half * PB;
  const int64_t so = ((b * p.H + h) * kPSplit + half) * (int64_t)(PB * N);

  // the state, fp32 in registers: warp w owns columns n in [16w, 16w + 16)
  // (n-tiles 2w and 2w + 1) of every row of the block's PB
  const bool owns = warp < N / 16;
  float st[kPT][2][4];
#pragma unroll
  for (int pt = 0; pt < kPT; ++pt)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = 16 * pt + g + 8 * (e >> 1);
        const int n = 16 * warp + 8 * j + 2 * q + (e & 1);
        st[pt][j][e] = owns && p.h0 ? p.h0[so + row * N + n] : 0.f;
      }
  // the state's three terms into their planes, [row][n]
  auto write_state = [&]() {
    if (!owns) return;
#pragma unroll
    for (int pt = 0; pt < kPT; ++pt)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int row = 16 * pt + g + 8 * hr;
          const int n = 16 * warp + 8 * j + 2 * q;
          uint32_t t[kT3];
          mma::split<kT3>(st[pt][j][2 * hr], st[pt][j][2 * hr + 1], t);
#pragma unroll
          for (int k = 0; k < kT3; ++k)
            *reinterpret_cast<uint32_t*>(smem + Tl::oS + k * Tl::kS +
                                         mma::swz_el<kWN>(row, n)) = t[k];
        }
  };

  const int64_t n_chunks = (p.S + kL - 1) / kL;
  // @probe f32 start
  for (int64_t c = 0; c < n_chunks; ++c) {
    const int64_t c0 = c * kL;
    const int Lc = (int)(p.S - c0 < kL ? p.S - c0 : kL);
    // the state is zero before chunk 0's update when there is no h0
    const bool inter = c > 0 || p.h0 != nullptr;
    if (c > 0) __syncthreads();  // the last chunk's readers are done
    {                            // x, B and C as three terms each, dt
#pragma unroll
      for (int k = 0; k < kT3; ++k) {    // B's and C's planes as they are
        mma::copy_rows<kWN, kL, kMmaThreads, true>(
            sb + k * Tl::kBC, bpg + k * pln + c0 * N, N, Lc, tid);
        mma::copy_rows<kWN, kL, kMmaThreads, true>(
            sc + k * Tl::kBC, cpg + k * pln + c0 * N, N, Lc, tid);
      }
      mma::cp_async_commit();
      float d0 = 0.f, d1 = 0.f;  // dt: warp 0's lanes hold rows l, l + 32
      if (warp == 0) {
        if (lane < Lc) d0 = ld(dg + (c0 + lane) * p.sds);
        if (lane + 32 < Lc) d1 = ld(dg + (c0 + lane + 32) * p.sds);
      }
      RowsF32<PB> xr;
      xr.load(xg + c0 * p.sxs, p.sxs, Lc, tid);
      if (inter) write_state();
      xr.split(smem, Tl::kX, tid);
      if (warp == 0) {           // seg: a compensated scan of dt A log2 e
        dts[lane] = d0;
        dts[lane + 32] = d1;
        float h0v = d0 * A2, h1v = d1 * A2, l0 = 0.f, l1 = 0.f;
        mma::scan64_2(h0v, l0, h1v, l1, lane);
        segw[lane] = h0v;
        segw[lane + 32] = h1v;
        seglw[lane] = l0;
        seglw[lane + 32] = l1;
      }
      mma::cp_async_wait_all();
    }
    __syncthreads();
    // @probe f32 phase:load
    const float hl = segw[kL - 1], ll = seglw[kL - 1];
    const int i0 = 16 * warp;    // the warp's rows of the chunk
    const int ia = i0 + g, ib = ia + 8;
    const float seg_a = segw[ia], sl_a = seglw[ia];
    const float seg_b = segw[ib], sl_b = seglw[ib];
    // the A operand offset of C's rows i0.. at k-step kk
    auto c_off = [&](int kk) {
      return mma::swz<kWN>(i0 + (lane & 15), 2 * kk + (lane >> 4));
    };

    // yi = C_i . state^T, each k-step's products into a zeroed partial
    float yi[kYT][4] = {};
    if (inter) {
#pragma unroll
      for (int kk = 0; kk < kNK; ++kk) {
        uint32_t cf[kT3][4];
        mma::ldsm_k(cf, sc + c_off(kk), Tl::kBC);
#pragma unroll
        for (int jp = 0; jp < kYT / 2; ++jp) {
          uint32_t r[1][kT3][4];
          mma::ldsm_k(r[0], ss + mma::swz<kWN>(16 * jp + (lane & 7) +
                                                   8 * (lane >> 4),
                                               2 * kk + ((lane >> 3) & 1)),
                      Tl::kS);
          float part[2][4] = {};
          mma::mma_terms_xn(part, cf, r);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            yi[2 * jp][e] += part[0][e];
            yi[2 * jp + 1][e] += part[1][e];
          }
        }
      }
    }

    // @probe f32 phase:inter
    // yo = M' x over the 16-column tiles jj <= warp, M' = (C B^T) o
    // exp2(seg_i - seg_l) o dt_l where l <= i, else 0; C B^T and each
    // tile's M' x into zeroed partials
    float yo[kYT][4] = {};
#pragma unroll 1
    for (int jj = 0; jj <= warp; ++jj) {
      float cb[2][4] = {};
#pragma unroll
      for (int kk = 0; kk < kNK; ++kk) {
        uint32_t cf[kT3][4], r[1][kT3][4];
        mma::ldsm_k(cf, sc + c_off(kk), Tl::kBC);
        mma::ldsm_k(r[0], sb + mma::swz<kWN>(16 * jj + (lane & 7) +
                                                 8 * (lane >> 4),
                                             2 * kk + ((lane >> 3) & 1)),
                    Tl::kBC);
        float part[2][4] = {};
        mma::mma_terms_xn(part, cf, r);
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) cb[j][e] += part[j][e];
      }
      uint32_t mt[kT3][4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int l0 = 16 * jj + 8 * j + 2 * q;
        const float s0 = segw[l0], s1 = segw[l0 + 1];
        const float z0 = seglw[l0], z1 = seglw[l0 + 1];
        const float d0 = dts[l0], d1 = dts[l0 + 1];
        float m[4];
        m[0] = l0 <= ia ? cb[j][0] * mma::exp2_d(seg_a, sl_a, s0, z0) * d0
                        : 0.f;
        m[1] = l0 + 1 <= ia
                   ? cb[j][1] * mma::exp2_d(seg_a, sl_a, s1, z1) * d1
                   : 0.f;
        m[2] = l0 <= ib ? cb[j][2] * mma::exp2_d(seg_b, sl_b, s0, z0) * d0
                        : 0.f;
        m[3] = l0 + 1 <= ib
                   ? cb[j][3] * mma::exp2_d(seg_b, sl_b, s1, z1) * d1
                   : 0.f;
        uint32_t t[kT3];
        mma::split<kT3>(m[0], m[1], t);    // row g: a0 (j 0), a2 (j 1)
#pragma unroll
        for (int k = 0; k < kT3; ++k) mt[k][2 * j] = t[k];
        mma::split<kT3>(m[2], m[3], t);    // row g + 8: a1, a3
#pragma unroll
        for (int k = 0; k < kT3; ++k) mt[k][2 * j + 1] = t[k];
      }
      // @probe f32 one_term (M''s lower terms zeroed here)
#pragma unroll
      for (int jp = 0; jp < kYT / 2; ++jp) {
        uint32_t r[1][kT3][4];
        mma::ldsm_k_t(r[0], sx + mma::swz<kWX>(16 * jj + (lane & 15),
                                               2 * jp + (lane >> 4)),
                      Tl::kX);
        float part[2][4] = {};
        mma::mma_terms_xn(part, mt, r);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          yo[2 * jp][e] += part[0][e];
          yo[2 * jp + 1][e] += part[1][e];
        }
      }
    }
    // @probe f32 phase:intra
    {                            // y = exp2(seg_i) yi + yo
      const float ea = mma::exp2_2(seg_a, sl_a);
      const float eb = mma::exp2_2(seg_b, sl_b);
#pragma unroll
      for (int j = 0; j < kYT; ++j) {
        const int col = 8 * j + 2 * q;
        if (ia < Lc)
          *reinterpret_cast<float2*>(yg + (c0 + ia) * p.sys + col) =
              make_float2(fmaf(ea, yi[j][0], yo[j][0]),
                          fmaf(ea, yi[j][1], yo[j][1]));
        if (ib < Lc)
          *reinterpret_cast<float2*>(yg + (c0 + ib) * p.sys + col) =
              make_float2(fmaf(eb, yi[j][2], yo[j][2]),
                          fmaf(eb, yi[j][3], yo[j][3]));
      }
    }

    // state <- exp2(seg_last) state + x^T B', B' = B o exp2(seg_last -
    // seg_l) dt_l (B's terms summed, scaled, split again), each k-step's
    // products into a zeroed partial
    auto update_state = [&]() {
      if (!owns) return;
      const float decay = mma::exp2_2(hl, ll);
#pragma unroll
      for (int pt = 0; pt < kPT; ++pt)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) st[pt][j][e] *= decay;
#pragma unroll 1
      for (int kk = 0; kk < kL / 16; ++kk) {
        uint32_t r[kT3][4];
        mma::ldsm_k_t(r, sb + mma::swz<kWN>(16 * kk + (lane & 15),
                                            2 * warp + (lane >> 4)),
                      Tl::kBC);
        const int la = 16 * kk + 2 * q, lb = la + 8;
        const float w[4] = {
            mma::exp2_d(hl, ll, segw[la], seglw[la]) * dts[la],
            mma::exp2_d(hl, ll, segw[la + 1], seglw[la + 1]) * dts[la + 1],
            mma::exp2_d(hl, ll, segw[lb], seglw[lb]) * dts[lb],
            mma::exp2_d(hl, ll, segw[lb + 1], seglw[lb + 1]) * dts[lb + 1]};
        uint32_t bw[1][kT3][4];
#pragma unroll
        for (int m = 0; m < 4; ++m) {    // r[.][0], [2]: rows la; [1], [3]: lb
          const float2 f0 = mma::unpack(r[0][m]);
          const float2 f1 = mma::unpack(r[1][m]);
          const float2 f2 = mma::unpack(r[2][m]);
          uint32_t t[kT3];
          mma::split<kT3>(((f0.x + f1.x) + f2.x) * w[2 * (m & 1)],
                          ((f0.y + f1.y) + f2.y) * w[2 * (m & 1) + 1], t);
#pragma unroll
          for (int k = 0; k < kT3; ++k) bw[0][k][m] = t[k];
        }
#pragma unroll
        for (int pt = 0; pt < kPT; ++pt) {
          uint32_t xa[kT3][4];
          mma::ldsm_k_t(xa, sx + mma::swz<kWX>(16 * kk + (lane & 7) +
                                                   8 * (lane >> 4),
                                               2 * pt + ((lane >> 3) & 1)),
                        Tl::kX);
          float part[2][4] = {};
          mma::mma_terms_xn(part, xa, bw);
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) st[pt][j][e] += part[j][e];
        }
      }
    };
    // @probe f32 state-update (the next line)
    update_state();
    // @probe f32 phase:state
  }
  // @probe f32 epilogue
  if (owns)
#pragma unroll
    for (int pt = 0; pt < kPT; ++pt)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int row = 16 * pt + g + 8 * hr;
          const int n = 16 * warp + 8 * j + 2 * q;
          *reinterpret_cast<float2*>(p.hf + so + row * N + n) =
              make_float2(st[pt][j][2 * hr], st[pt][j][2 * hr + 1]);
        }
}

template <typename TD, int P, int N>
int launch_simt(const Params& p, int64_t B, int64_t H, cudaStream_t stream) {
  const int smem = smem_floats<P, N>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_fwd_simt<float, TD, P, N>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)H, (unsigned)B);
  ssd_fwd_simt<float, TD, P, N><<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename TD, int P, int N>
int launch_mma(const Params& p, int64_t B, int64_t H, cudaStream_t stream) {
  constexpr int PB = P / kPSplit;
  const int smem = SsdTile<PB, N>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_fwd_mma<TD, PB, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(H * kPSplit), (unsigned)B);
  ssd_fwd_mma<TD, PB, N><<<grid, kMmaThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// three blocks an SM at P = N = 64 (76,032 bytes each): the carveout is
// asked for all the shared memory the SM has
template <typename TD, int P, int N>
int launch_mma_f32(const Params& p, int64_t B, int64_t H,
                   cudaStream_t stream) {
  constexpr int PB = P / kPSplit;
  const int smem = SsdTileF32<PB, N>::kBytes;
  const int64_t rows = B * (H / p.rep) * p.S;
  const int64_t split_blocks =
      (2 * rows * (N / 4) + kSplitThreads - 1) / kSplitThreads;
  ssd_split3_bc<N><<<(unsigned)split_blocks, kSplitThreads, 0, stream>>>(
      p, rows);
  cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_fwd_mma_f32<TD, PB, N>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_fwd_mma_f32<TD, PB, N>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(H * kPSplit), (unsigned)B);
  ssd_fwd_mma_f32<TD, PB, N><<<grid, kMmaThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// variant 0: ssd_fwd_simt (fp32 x, B, C), 1: ssd_fwd_mma (bf16), 2:
// ssd_fwd_mma_f32 (fp32)
template <typename TD, int P, int N>
int launch(int variant, const Params& p, int64_t B, int64_t H,
           cudaStream_t s) {
  if (variant == 0) return launch_simt<TD, P, N>(p, B, H, s);
  if (variant == 1) return launch_mma<TD, P, N>(p, B, H, s);
  if (variant == 2) return launch_mma_f32<TD, P, N>(p, B, H, s);
  return (int)cudaErrorInvalidValue;
}

template <typename TD>
int dispatch_pn(int variant, int P, int N, const Params& p, int64_t B,
                int64_t H, cudaStream_t s) {
  if (P == 64 && N == 64) return launch<TD, 64, 64>(variant, p, B, H, s);
  if (P == 64 && N == 16) return launch<TD, 64, 16>(variant, p, B, H, s);
  if (P == 32 && N == 64) return launch<TD, 32, 64>(variant, p, B, H, s);
  if (P == 32 && N == 16) return launch<TD, 32, 16>(variant, p, B, H, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// variant: 0 = ssd_fwd_simt and 2 = ssd_fwd_mma_f32 on fp32 x, B and C,
// 1 = ssd_fwd_mma on bf16 ones (both tensor-core variants want the rows
// of x, B and C at 16-byte-aligned addresses: every stride but the last
// a multiple of 16 bytes and 16-byte-aligned bases); dt_dtype: 0 =
// float32, 1 = bfloat16.  strides: 15 element strides, (batch, head,
// seq) of x, dt and y and (batch, group, seq) of B and C, in the order x,
// dt, B, C, y.  h0 may be null (zeros); hf is (B, H, P, N) contiguous;
// ws, for variant 2 only (else null), holds B's and C's three bf16 term
// planes, 2 x (B, G, 3, S, N) bf16 (ssd_split3_bc writes it first).
// Returns cudaGetLastError() after the launch (0 = cudaSuccess).  The
// caller handles S == 0 without a launch.
extern "C" int ssm_scan_fwd(int variant, int dt_dtype, int P, int N,
                            const void* x, const void* dt, const float* A,
                            const void* bm, const void* cm, const float* h0,
                            float* y, float* hf, void* ws,
                            const int64_t* strides, int64_t B, int64_t H,
                            int64_t G, int64_t S, void* stream) {
  if (B <= 0 || H <= 0 || G <= 0 || S <= 0 || H % G || B > 65535 ||
      H > 0x3fffffffLL)
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
  p.bpl = static_cast<__nv_bfloat16*>(ws);
  p.cpl = p.bpl ? p.bpl + 3 * B * G * S * N : nullptr;
  if (variant == 2 && !ws) return (int)cudaErrorInvalidValue;
  p.sxb = strides[0]; p.sxh = strides[1]; p.sxs = strides[2];
  p.sdb = strides[3]; p.sdh = strides[4]; p.sds = strides[5];
  p.sbb = strides[6]; p.sbg = strides[7]; p.sbs = strides[8];
  p.scb = strides[9]; p.scg = strides[10]; p.scs = strides[11];
  p.syb = strides[12]; p.syh = strides[13]; p.sys = strides[14];
  p.S = S;
  p.H = (int)H;
  p.rep = (int)(H / G);
  cudaStream_t s = (cudaStream_t)stream;
  if (dt_dtype == 0) return dispatch_pn<float>(variant, P, N, p, B, H, s);
  if (dt_dtype == 1)
    return dispatch_pn<__nv_bfloat16>(variant, P, N, p, B, H, s);
  return (int)cudaErrorInvalidValue;
}
