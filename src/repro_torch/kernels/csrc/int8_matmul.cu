// INT8 x INT8 -> INT32 GEMM with fused bias and requant, for NVIDIA Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/int8_matmul.py int8_matmul
// (body _kernel): the paper's Linear module (Matrix-Multiply + Bias Addition
// + Quant).  out = A (M,K) int8 @ B (K,N) int8, accumulated in int32, plus
// an optional int32 bias (N,) at scale sa*sb; with requant the epilogue is
//   ratio = (sa * sb) / so            (float32, in that order)
//   x = float(acc) * ratio
//   q = sign(x) * floor(|x| + 0.5)    (round half away, not roundf)
//   out = int8(clip(q, -127, 127))
// and without it the int32 accumulator is stored.  Bit-exact against
// kernels/ref.py int8_matmul.
//
// What bounds it: at the I-BERT encoder's shapes (M = B*S = 128, K and N in
// {768, 3072}) it moves 0.8-4.0 MB, 0.24-1.2 us at 3.35 TB/s, and does
// 2*M*N*K = 0.15-0.6 G int8 ops, 0.08-0.3 us at the tensor cores' 1,979
// TOPS: bound by bytes, and both far below what one launch and the first
// tile's load cost.  So the design is about latency: enough blocks to
// fill the SMs at M = 128, short serial K loops, and loads that overlap
// the tensor cores.
//
// Design:
//   * The int8 tensor cores through mma.sync.m16n8k32.s32.s8.s8.s32, fed
//     by ldmatrix.  The problem is latency-bound at these shapes, so
//     wgmma's higher throughput buys nothing here, and mma.sync keeps the
//     warps independent (no descriptors, no warpgroup barriers).  No
//     .satfinite: it would clamp where the plain version wraps (the
//     encoder's sums stay far inside int32: |acc| <= K * 127^2).
//   * Both operands K-major, as 8-bit mma operands must be (sm_90 has no
//     8-bit ldmatrix .trans): A is (M, K) row-major, and B arrives as its
//     transpose Bt (N, K) row-major, which is the (K, N) weight stored
//     column-major (models/ibert.py keeps its weights so; ops.int8_matmul
//     transposes a row-major B with one copy).
//   * 64 x 64 output tiles, 4 warps of 32 x 32 (2 x 4 mma tiles each), K
//     in steps of 64 bytes through a 4-stage ring of 16-byte cp.async
//     copies, so the next k-steps load while the tensor cores run this
//     one.  Shared-memory rows are padded to 80 bytes, which makes every
//     ldmatrix phase conflict-free.
//   * Split-K over a thread-block cluster of `split` blocks (1-8, chosen
//     by the wrapper so that the card fills: 8 at 24 tiles, 2 at 96):
//     rank s sums k-steps [n*s/split, n*(s+1)/split); the partial int32
//     tiles meet in shared memory, and every rank adds its share of the
//     tile's elements over all ranks through distributed shared memory
//     (int32 addition is associative: the sum is exact), then runs bias
//     and requant on it.  One launch per call: no atomics, no workspace.
//   * Ragged edges are the kernel's own: rows past M or N and k past K
//     are zero-filled, so they add exact zeros.  When K is not a multiple
//     of 16 (or a base is not 16-byte aligned) rows are not 16-byte
//     aligned, and the stages fill through a narrower path (predicated
//     byte loads packed into 32-bit words).
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ibert_int.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int BM = 64, BN = 64, BK = 64;  // output tile; k bytes per step
constexpr int kStages = 4;                // ring depth
constexpr int kMaxSplit = 8;              // blocks per cluster along K
constexpr int kThreads = 128;             // 4 warps, 2 x 2 over the tile
constexpr int kLds = BK + 16;             // padded smem row: 80 bytes
constexpr int kStageBytes = (BM + BN) * kLds;
constexpr int kPs = BN + 8;               // int32 row stride of a partial
constexpr int kSmemBytes = kStages * kStageBytes;
static_assert(BM * kPs * 4 <= kSmemBytes, "the partial tile reuses the ring");

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronous; zero-filled (nothing read) when
// !on
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool on) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(on ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// c += a (16x32, row) * b (32x8, col), int8 in, int32 sums, wrapping
__device__ __forceinline__ void mma_s8(int c[4], const unsigned a[4], unsigned b0,
                                       unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// rows [r0, r0 + 64) x k bytes [k0, k0 + 64) of a K-major (rows, k) int8
// matrix into a stage (64 rows of kLds bytes), zeros outside
template <bool kAligned>
__device__ __forceinline__ void load_tile(unsigned char* dst, const int8_t* __restrict__ src,
                                          int rows, int k, int r0, int k0) {
  if constexpr (kAligned) {  // k % 16 == 0: a chunk lies wholly in or out
#pragma unroll
    for (int e = threadIdx.x; e < 64 * (BK / 16); e += kThreads) {
      const int r = e / (BK / 16);
      const int kb = k0 + (e % (BK / 16)) * 16;
      const bool on = r0 + r < rows && kb < k;
      cp_async16(dst + r * kLds + (kb - k0), on ? src + (size_t)(r0 + r) * k + kb : src,
                 on);
    }
  } else {
#pragma unroll 4
    for (int e = threadIdx.x; e < 64 * (BK / 4); e += kThreads) {
      const int r = e / (BK / 4);
      const int kb = k0 + (e % (BK / 4)) * 4;
      unsigned word = 0;
      if (r0 + r < rows) {
        const int8_t* p = src + (size_t)(r0 + r) * k;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (kb + j < k) word |= (unsigned)(uint8_t)p[kb + j] << (8 * j);
      }
      *reinterpret_cast<unsigned*>(dst + r * kLds + (kb - k0)) = word;
    }
  }
}

template <bool kAligned, bool kRequant>
__global__ void __launch_bounds__(kThreads)
int8_matmul_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ bt,
                   const int* __restrict__ bias, void* __restrict__ out, int m, int n, int k,
                   float sa, float sb, float so) {
  __shared__ __align__(128) unsigned char smem[kSmemBytes];
  cg::cluster_group cluster = cg::this_cluster();
  const int split = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int tile = blockIdx.x / split;
  const int tiles_n = (n + BN - 1) / BN;
  const int m0 = (tile / tiles_n) * BM;
  const int n0 = (tile % tiles_n) * BN;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = (warp >> 1) * 32;  // the warp's 32 x 32 quarter
  const int wn = (warp & 1) * 32;

  // this rank's k-steps
  const int n_k = (k + BK - 1) / BK;
  const int kt0 = (int)((long long)n_k * rank / split);
  const int nk = (int)((long long)n_k * (rank + 1) / split) - kt0;

  auto load = [&](int i) {
    unsigned char* st = smem + (i % kStages) * kStageBytes;
    const int k0 = (kt0 + i) * BK;
    load_tile<kAligned>(st, a, m, k, m0, k0);
    load_tile<kAligned>(st + BM * kLds, bt, n, k, n0, k0);
  };

  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  // ldmatrix lane addresses: A's four 8x8 matrices are (rows 0-7, k 0-15),
  // (8-15, 0-15), (0-7, 16-31), (8-15, 16-31) of a 16 x 32 tile, the
  // registers a0..a3 of m16n8k32; B's are (n 0-7, k 0-15), (0-7, 16-31),
  // (8-15, 0-15), (8-15, 16-31): b0, b1 of two n8 tiles
  const int mat = lane >> 3;
  const int a_row = wm + (lane & 7) + (mat & 1) * 8;
  const int a_col = (mat >> 1) * 16;
  const int b_row = wn + (lane & 7) + (mat >> 1) * 8;
  const int b_col = (mat & 1) * 16;

#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < nk) load(i);
    cp_async_commit();
  }
  for (int i = 0; i < nk; ++i) {
    cp_async_wait<kStages - 2>();  // step i's group has landed
    __syncthreads();               // ... for every thread; stage i-1 is free
    if (i + kStages - 1 < nk) load(i + kStages - 1);
    cp_async_commit();
    const unsigned char* sa_ = smem + (i % kStages) * kStageBytes;
    const unsigned char* sb_ = sa_ + BM * kLds;
#pragma unroll
    for (int ks = 0; ks < BK; ks += 32) {
      unsigned af[2][4], bf[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldmatrix_x4(af[mi], sa_ + (a_row + mi * 16) * kLds + ks + a_col);
#pragma unroll
      for (int nj = 0; nj < 2; ++nj)
        ldmatrix_x4(bf[nj], sb_ + (b_row + nj * 16) * kLds + ks + b_col);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          mma_s8(acc[mi][ni], af[mi], bf[ni >> 1][(ni & 1) * 2], bf[ni >> 1][(ni & 1) * 2 + 1]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is idle: it now holds this rank's partial

  // the partial tile, [BM][kPs] int32: c0, c1 at (g, 2t), (g, 2t + 1),
  // c2, c3 eight rows below
  int* part = reinterpret_cast<int*>(smem);
  const int g = lane >> 2;
  const int t2 = (lane & 3) * 2;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int r = wm + mi * 16 + g;
      const int c = wn + ni * 8 + t2;
      *reinterpret_cast<int2*>(part + r * kPs + c) = make_int2(acc[mi][ni][0], acc[mi][ni][1]);
      *reinterpret_cast<int2*>(part + (r + 8) * kPs + c) =
          make_int2(acc[mi][ni][2], acc[mi][ni][3]);
    }
  cluster.sync();  // every rank's partial is written and visible

  // each rank sums a share of the tile over the ranks, four columns at a
  // time, then adds the bias and requantizes
  const float ratio = sa * sb / so;
  for (int e = rank * kThreads + tid; e < BM * (BN / 4); e += split * kThreads) {
    const int r = e / (BN / 4);
    const int c = (e % (BN / 4)) * 4;
    int v[4] = {0, 0, 0, 0};
    for (int s = 0; s < split; ++s) {
      const int4 p = *reinterpret_cast<const int4*>(cluster.map_shared_rank(part, s) +
                                                     r * kPs + c);
      v[0] = ibert::wadd(v[0], p.x);
      v[1] = ibert::wadd(v[1], p.y);
      v[2] = ibert::wadd(v[2], p.z);
      v[3] = ibert::wadd(v[3], p.w);
    }
    const int gr = m0 + r;
    if (gr >= m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gc = n0 + c + j;
      if (gc >= n) continue;
      int x = v[j];
      if (bias != nullptr) x = ibert::wadd(x, bias[gc]);
      if (kRequant) {
        const float f = (float)x * ratio;
        const float sgn = (float)((f > 0.0f) - (f < 0.0f));
        float q = sgn * floorf(fabsf(f) + 0.5f);
        q = fminf(fmaxf(q, -127.0f), 127.0f);
        static_cast<int8_t*>(out)[(size_t)gr * n + gc] = (int8_t)q;
      } else {
        static_cast<int*>(out)[(size_t)gr * n + gc] = x;
      }
    }
  }
  cluster.sync();  // no block exits while a peer still reads its partial
}

template <bool kAligned, bool kRequant>
cudaError_t launch(const int8_t* a, const int8_t* bt, const int* bias, void* out, int m, int n,
                   int k, float sa, float sb, float so, int split, cudaStream_t stream) {
  const int tiles = ((m + BM - 1) / BM) * ((n + BN - 1) / BN);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(tiles * split));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, int8_matmul_kernel<kAligned, kRequant>, a, bt,
                                       bias, out, m, n, k, sa, sb, so);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// A (m, k) int8 row-major; Bt (n, k) int8 row-major, the transpose of B
// (k, n), i.e. B stored column-major; bias (n,) int32 or null; out (m, n)
// row-major, int8 when requant, else int32.  All contiguous.  `split`
// (1..8) blocks of one cluster share each output tile's k-steps.  Launches
// on `stream`, does not synchronise, and returns cudaGetLastError() (0 on
// success).
extern "C" int int8_matmul(const void* a, const void* bt, const void* bias, void* out, int m,
                           int n, int k, float sa, float sb, float so, int requant, int split,
                           void* stream) {
  if (m < 1 || n < 1 || k < 0 || split < 1 || split > kMaxSplit ||
      (long long)((m + BM - 1) / BM) * ((n + BN - 1) / BN) * split >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* a8 = static_cast<const int8_t*>(a);
  const auto* b8 = static_cast<const int8_t*>(bt);
  const auto* bi = static_cast<const int*>(bias);
  const bool aligned =
      k % 16 == 0 && (reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(bt)) % 16 == 0;
  if (aligned)
    return requant ? (int)launch<true, true>(a8, b8, bi, out, m, n, k, sa, sb, so, split, s)
                   : (int)launch<true, false>(a8, b8, bi, out, m, n, k, sa, sb, so, split, s);
  return requant ? (int)launch<false, true>(a8, b8, bi, out, m, n, k, sa, sb, so, split, s)
                 : (int)launch<false, false>(a8, b8, bi, out, m, n, k, sa, sb, so, split, s);
}
