// bf16 matrix product with a reduction order fixed by K alone, for NVIDIA
// Hopper (sm_90a).
//
// A port-only kernel: the JAX package leaves its projections to XLA's dot
// (repro/models/layers.py dense and lm_head; no Pallas kernel stands
// behind them).  C (M, N) = A (M, K) @ B, A and C row-major bf16, B either
// (K, N) row-major (a dense weight) or (N, K) row-major (the tied
// embedding read as the head), f32 sums, each output rounded to bf16 (to
// nearest even) — or kept in f32, for a tensor-parallel shard's partial
// product that the shards' sum rounds once.  torch.matmul on bf16 (on
// f32 copies of the inputs, for the f32 output) is the function.
//
// Why a kernel: an output must be the same bits whatever product it sits
// in.  cuBLAS picks its kernel and its split of K by (M, N, K), so on an
// H100 a column block of minitron-8b's wq (4096 x 4096 cut into 4 x 1024,
// a tensor-parallel shard's) gives other bits than the same columns of
// the whole product at every M from 1 to 64, and rows of a (40, K)
// product others than the same rows of an (8, K) one.  Here the order of
// every sum is a function of K alone:
//  * K is walked in tiles of 64, and the tiles are split over a cluster
//    of `split` blocks, `per` tiles a block (the last may take fewer),
//    both chosen from K alone (`split_of`): rank r sums tiles [r per,
//    (r + 1) per) in order, each as four mma.sync m16n8k16 steps (k 0-15,
//    16-31, ...) into its f32 accumulators; K's tail is zero-filled, the
//    same way for every product of that K;
//  * the ranks' partial tiles meet in shared memory and are added in rank
//    order (rank 0's, plus rank 1's, ...) through distributed shared
//    memory: no atomics, nothing chosen by M, N or the grid;
//  * an output (m, n) sees only row m of A and column n of B, and the
//    tile's shape (16 or 64 rows, by M) only says which outputs a block
//    holds, so a row block of A or a column block of B gives the same
//    bits as the whole.
// The tensor-parallel plans (column shards of wq / wk / wv / wi / wg and
// of the vocabulary) and the pipeline's microbatches then equal one
// device bit for bit, and so does a verify pass's (B*T)-row product its
// decode step's B rows.
//
// What bounds it: bytes at a decode step (M = 8 lanes reads the whole
// weight for 8 rows), operations at a long prefill.  So the design is
// about keeping the weight's bytes in flight:
//  * 64-column tiles; 16 rows a tile at M <= 16 (a decode step: 4 warps
//    of 16 x 16, so the tensor cores do a quarter of a 64-row tile's
//    work), else 64 (4 warps of 32 x 32);
//  * the split of K puts up to 8 blocks on each tile (minitron-8b's
//    4096 x 1024 shard: 16 tiles, 128 blocks), each walking at most
//    max(3, ceil(K / 512)) tiles of 64 (3: the ring holds three ahead);
//  * a 4-stage ring of 16-byte cp.async copies, three K tiles ahead of
//    the tensor cores (where K, N and the bases are 16-byte multiples;
//    else a synchronous path of element loads), fragments by ldmatrix
//    (.trans for a (K, N) weight, kept [k][n] in shared memory); shared
//    rows padded to 72 values, so each ldmatrix phase is conflict-free.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

constexpr int BN = 64, BK = 64;
constexpr int kLd = 72;  // shared row stride, in bf16 values
constexpr int kThreads = 128;
constexpr int kStages = 4;
constexpr int kMaxSplit = 8;
constexpr int kPs = BN + 4;  // f32 row stride of a partial tile
constexpr int kMaxDevices = 64;

template <int BM>
constexpr int smem_bytes() {
  return kStages * (BM + BK) * kLd * 2;  // (K, N) weights: BK rows of n
}
static_assert(64 * kPs * 4 <= smem_bytes<64>() && 16 * kPs * 4 <= smem_bytes<16>(),
              "the partial tile reuses the ring");

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

__device__ __forceinline__ void ldmatrix_x4(unsigned* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma(float* d, const unsigned* a, unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void put(float* p, float v) { *p = v; }

// rows x 64 values of a row-major (rows_all, cols_all) matrix from (r0,
// c0) into a shared [rows][kLd] tile; values past rows_all or cols_all
// read as 0.  kVec: 16-byte cp.async (cols_all % 8 == 0, base aligned),
// else element loads stored synchronously.
template <int kRows, bool kVec>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          int rows_all, int cols_all, int r0, int c0,
                                          int tid) {
  if constexpr (kVec) {
#pragma unroll
    for (int i = 0; i < kRows * 8 / kThreads; ++i) {
      const int idx = tid + i * kThreads;
      const int r = idx >> 3, c = (idx & 7) * 8;
      const bool on = r0 + r < rows_all && c0 + c < cols_all;
      cp_async16(dst + r * kLd + c, on ? src + (size_t)(r0 + r) * cols_all + c0 + c : src, on);
    }
  } else {
    for (int idx = tid; idx < kRows * 64; idx += kThreads) {
      const int r = idx >> 6, c = idx & 63;
      const bool on = r0 + r < rows_all && c0 + c < cols_all;
      dst[r * kLd + c] = on ? src[(size_t)(r0 + r) * cols_all + c0 + c] : __float2bfloat16_rn(0.f);
    }
  }
}

// grid: (n tiles x split, m tiles), clusters of `split` blocks along x;
// rank r of a cluster sums K tiles [r per, min(nk, (r + 1) per))
template <int BM, bool kBNK, bool kVec, typename OutT>
__global__ void __launch_bounds__(kThreads)
gemm_kernel(const __nv_bfloat16* __restrict__ A, const __nv_bfloat16* __restrict__ B,
            OutT* __restrict__ C, int M, int N, int K, int per) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int MI = BM == 16 ? 1 : 2;  // m16 tiles a warp
  constexpr int NJ = BM == 16 ? 2 : 4;  // n8 tiles a warp
  constexpr int kStage = (BM + BK) * kLd;  // values a stage
  static_assert(BM == 16 || BM == 64, "tile rows");
  cg::cluster_group cluster = cg::this_cluster();
  const int split = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = (blockIdx.x / split) * BN, m0 = blockIdx.y * BM;
  const int wm = BM == 16 ? 0 : (warp >> 1) * 32;
  const int wn = BM == 16 ? warp * 16 : (warp & 1) * 32;
  const int nk = (K + BK - 1) / BK;
  const int kt0 = rank * per;
  const int mine = min(nk - kt0, per);

  auto* ring = reinterpret_cast<__nv_bfloat16*>(smem);
  auto load = [&](int slot, int kt) {
    __nv_bfloat16* sa = ring + slot * kStage;
    __nv_bfloat16* sb = sa + BM * kLd;
    load_tile<BM, kVec>(sa, A, M, K, m0, kt * BK, tid);
    if constexpr (kBNK)
      load_tile<BN, kVec>(sb, B, N, K, n0, kt * BK, tid);  // [n][k]
    else
      load_tile<BK, kVec>(sb, B, K, N, kt * BK, n0, tid);  // [k][n]
  };

  float acc[MI][NJ][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < mine) load(s, kt0 + s);
    cp_async_commit();
  }
  const int lr = lane & 7, lm = lane >> 3;  // ldmatrix: row, matrix
  for (int i = 0; i < mine; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile i is in; every warp is done with tile i - 1
    const int nxt = i + kStages - 1;
    if (nxt < mine) load(nxt % kStages, kt0 + nxt);
    cp_async_commit();
    const __nv_bfloat16* sa = ring + (i % kStages) * kStage;
    const __nv_bfloat16* sb = sa + BM * kLd;
#pragma unroll
    for (int ks = 0; ks < BK; ks += 16) {
      unsigned af[MI][4], bf[NJ / 2][4];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
        ldmatrix_x4(af[mi], sa + (wm + mi * 16 + (lm & 1) * 8 + lr) * kLd + ks + (lm >> 1) * 8);
#pragma unroll
      for (int p = 0; p < NJ / 2; ++p) {
        // registers 0, 1: n8 tile 2p at k 0-7, 8-15; 2, 3: tile 2p + 1
        if constexpr (kBNK)
          ldmatrix_x4(bf[p], sb + (wn + p * 16 + (lm >> 1) * 8 + lr) * kLd + ks + (lm & 1) * 8);
        else
          ldmatrix_x4_trans(bf[p], sb + (ks + (lm & 1) * 8 + lr) * kLd + wn + p * 16 + (lm >> 1) * 8);
      }
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int nj = 0; nj < NJ; ++nj)
          mma(acc[mi][nj], af[mi], bf[nj >> 1][(nj & 1) * 2], bf[nj >> 1][(nj & 1) * 2 + 1]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is idle: it now holds this rank's partial

  // the partial tile, [BM][kPs] f32: c0, c1 at (g, 2t), (g, 2t + 1), c2,
  // c3 eight rows below
  float* part = reinterpret_cast<float*>(smem);
  const int g = lane >> 2, t2 = (lane & 3) * 2;
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int nj = 0; nj < NJ; ++nj) {
      const int r = wm + mi * 16 + g, c = wn + nj * 8 + t2;
      *reinterpret_cast<float2*>(part + r * kPs + c) = make_float2(acc[mi][nj][0], acc[mi][nj][1]);
      *reinterpret_cast<float2*>(part + (r + 8) * kPs + c) =
          make_float2(acc[mi][nj][2], acc[mi][nj][3]);
    }
  cluster.sync();  // every rank's partial is written and visible

  // each rank adds a share of the tile's outputs over the ranks, in rank
  // order, four columns at a time
  for (int e = rank * kThreads + tid; e < BM * (BN / 4); e += split * kThreads) {
    const int r = e / (BN / 4), c = (e % (BN / 4)) * 4;
    float4 v = *reinterpret_cast<const float4*>(cluster.map_shared_rank(part, 0) + r * kPs + c);
    for (int s = 1; s < split; ++s) {
      const float4 p = *reinterpret_cast<const float4*>(cluster.map_shared_rank(part, s) +
                                                        r * kPs + c);
      v.x += p.x;
      v.y += p.y;
      v.z += p.z;
      v.w += p.w;
    }
    const int gr = m0 + r;
    if (gr >= M) continue;
    const float o[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (n0 + c + j < N) put(C + (size_t)gr * N + n0 + c + j, o[j]);
  }
  cluster.sync();  // no block exits while a peer still reads its partial
}

// tiles of 64 a block, and blocks a cluster, for a K: a function of K
// alone, so every product of that K sums in one order
void split_of(int K, int* per, int* split) {
  const int nk = (K + BK - 1) / BK;
  *per = max(3, (nk + kMaxSplit - 1) / kMaxSplit);
  *split = max(1, (nk + *per - 1) / *per);
}

template <int BM, bool kBNK, bool kVec, typename OutT>
cudaError_t launch(const __nv_bfloat16* A, const __nv_bfloat16* B, OutT* C, int M, int N,
                   int K, cudaStream_t st) {
  auto* fn = gemm_kernel<BM, kBNK, kVec, OutT>;
  constexpr int smem = smem_bytes<BM>();
  static bool ready[kMaxDevices] = {};  // the smem limit raised, per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices || !ready[dev]) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    if (dev < kMaxDevices) ready[dev] = true;
  }
  int per = 0, split = 0;
  split_of(K, &per, &split);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(((N + BN - 1) / BN) * split), (unsigned)((M + BM - 1) / BM));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, fn, A, B, C, M, N, K, per);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <bool kBNK, bool kVec, typename OutT>
cudaError_t by_rows(const __nv_bfloat16* A, const __nv_bfloat16* B, OutT* C, int M, int N,
                    int K, cudaStream_t st) {
  return M <= 16 ? launch<16, kBNK, kVec>(A, B, C, M, N, K, st)
                 : launch<64, kBNK, kVec>(A, B, C, M, N, K, st);
}

template <typename OutT>
cudaError_t dispatch(const __nv_bfloat16* A, const __nv_bfloat16* B, OutT* C, int M, int N,
                     int K, bool b_nk, bool vec, cudaStream_t st) {
  if (b_nk)
    return vec ? by_rows<true, true>(A, B, C, M, N, K, st)
               : by_rows<true, false>(A, B, C, M, N, K, st);
  return vec ? by_rows<false, true>(A, B, C, M, N, K, st)
             : by_rows<false, false>(A, B, C, M, N, K, st);
}

}  // namespace

// a: (M, K) bf16 and c: (M, N) (bf16, or f32 when out_f32 != 0), both
// row-major and contiguous; b: (K, N) row-major (b_nk == 0) or (N, K)
// row-major (b_nk != 0), contiguous.  M, N, K >= 1, M <= 65535 * 64.  Launches
// on `stream`, does not synchronise, and returns the CUDA error of the
// launch (0 = none).
extern "C" int gemm_bf16(const void* a, const void* b, void* c, int M, int N, int K, int b_nk,
                         int out_f32, void* stream) {
  if (M < 1 || N < 1 || K < 1 || (M + 63) / 64 > 65535)
    return (int)cudaErrorInvalidValue;
  const auto* A = static_cast<const __nv_bfloat16*>(a);
  const auto* B = static_cast<const __nv_bfloat16*>(b);
  const bool vec = K % 8 == 0 && (b_nk || N % 8 == 0) &&
                   ((uintptr_t)a | (uintptr_t)b) % 16 == 0;
  const auto st = static_cast<cudaStream_t>(stream);
  if (out_f32)
    return (int)dispatch(A, B, static_cast<float*>(c), M, N, K, b_nk != 0, vec, st);
  return (int)dispatch(A, B, static_cast<__nv_bfloat16*>(c), M, N, K, b_nk != 0, vec, st);
}
