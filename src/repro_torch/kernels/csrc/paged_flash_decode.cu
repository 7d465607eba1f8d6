// Paged single-query flash decode for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/flash_decode.py
// paged_flash_decode (body _paged_kernel).  For each lane b and kv head h
// it computes single-query attention of the G = H / KVH query heads of that
// group over the lane's logical key slots 0..MAXP*ps, slot s living in row
// s % ps of arena page page_table[b, s / ps]:
//
//   * a key counts iff kpos <= qpos[b] and active[b] (the never-written
//     sentinel 2^30, the trash page 0 and stale rows all fail the test);
//   * online f32 softmax with NEG_INF = -1e30; p is taken from the mask,
//     not from the scores, so a fully masked page adds exact zeros;
//   * p is rounded to bf16 before the PV product, sums stay f32;
//   * out = acc / max(l, 1e-30) in bf16, so an inactive lane is exact zeros.
//
// What bounds it: device-memory bytes.  One decode call reads the K and V
// rows of the kept keys (hd*2 bytes each, per kv head) plus, for every
// walked slot, its kpos and page-table entry; q and the output are small.
// At B=8, MAXP=128, ps=16, KVH=3, hd=64 that is about 7.6 MB: 2.3 us at
// 3.35 TB/s.  The arithmetic is ~4*G flops per K/V element, far below
// the H100's flop-to-byte balance, so plain FMAs suffice.
//
// Design: decode_split.cuh's body (one cluster of 8 blocks per (b, h),
// the lane's slots split into 32-slot tiles over the cluster's blocks and
// their warps, an exact skip of tiles with no kept key by their kpos,
// cp.async rings, warp-parallel scores and softmax, one combine through
// distributed shared memory).  This file supplies the loader: lane r of a
// warp reads the page-table entry and kpos of tile slot r (the TPU's
// scalar-prefetched BlockSpec gather), and rows are read in place from the
// (P, ps, KVH, hd) arena: K/V are not copied and G is not padded.  A tile
// spans 32 / ps pages at ps < 32 and part of a page above.
//
// Known limits: every slot's page-table entry and kpos up to MAXP*ps is
// read, also past qpos (the skip trusts no invariant of the engine); a
// tile's first K/V byte waits on two dependent loads (page id, then
// kpos); the split is 8 whatever the lane's length, so a short lane
// leaves most of its cluster idle; hd 128 keeps one tile in flight per
// warp (one ring stage, for three blocks per SM).
#include "decode_split.cuh"

namespace {

using decode_split::kMaxG;
using decode_split::kSentinel;
using decode_split::kSplit;
using decode_split::kThreads;

template <int HD>
struct PagedLoader {
  static constexpr int kRowBytes = HD * 2;
  static constexpr bool kScaled = false;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const int* kpos;
  const int* table;  // this lane's row of the page table
  int h, kvh, ps, maxp;

  __device__ int slots() const { return maxp * ps; }
  __device__ int row(int slot, int* kp) const {
    const int j = slot / ps;
    if (j >= maxp) {
      *kp = kSentinel;
      return -1;
    }
    const int r = table[j] * ps + (slot - j * ps);
    *kp = kpos[r];
    return r;
  }
  __device__ const void* k_src(int r, int c) const {
    return k + ((size_t)r * kvh + h) * HD + c * 8;
  }
  __device__ const void* v_src(int r, int c) const {
    return v + ((size_t)r * kvh + h) * HD + c * 8;
  }
  __device__ static void unpack(const unsigned char* row, int c, float out[8]) {
    decode_split::unpack_bf16x8(reinterpret_cast<const uint4*>(row)[c], out);
  }
};

template <int HD, int GMAX>
__global__ void __cluster_dims__(kSplit, 1, 1) __launch_bounds__(kThreads, 1)
paged_flash_decode_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          const int* __restrict__ kpos,
                          const int* __restrict__ page_table,
                          const int* __restrict__ qpos,
                          const unsigned char* __restrict__ active,
                          __nv_bfloat16* __restrict__ out,
                          int kvh, int g, int ps, int maxp) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int item = blockIdx.x / kSplit;  // one cluster per (b, h)
  const int b = item / kvh;
  const int h = item % kvh;
  const size_t head0 = ((size_t)b * kvh + h) * g * HD;  // this group's q/out rows
  if (!active[b]) {
    decode_split::write_zeros<HD>(out + head0, g);
    return;
  }
  const PagedLoader<HD> ld{k, v, kpos, page_table + (size_t)b * maxp, h, kvh, ps, maxp};
  decode_split::decode<HD, GMAX, true>(q + head0, out + head0, g, qpos[b], 0, ld, smem);
}

template <int HD, int GMAX>
cudaError_t launch(const void* q, const void* k, const void* v, const void* kpos,
                   const void* page_table, const void* qpos, const void* active,
                   void* out, int b, int kvh, int g, int ps, int maxp,
                   cudaStream_t stream) {
  constexpr size_t smem = decode_split::Smem<HD, GMAX, PagedLoader<HD>>::kBytes;
  auto kernel = paged_flash_decode_kernel<HD, GMAX>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<kSplit * b * kvh, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(kpos),
      static_cast<const int*>(page_table), static_cast<const int*>(qpos),
      static_cast<const unsigned char*>(active), static_cast<__nv_bfloat16*>(out),
      kvh, g, ps, maxp);
  return cudaGetLastError();
}

// G rounds up to a compiled group width: 2, 4 or 8
template <int HD>
cudaError_t launch_hd(const void* q, const void* k, const void* v, const void* kpos,
                      const void* page_table, const void* qpos, const void* active,
                      void* out, int b, int kvh, int g, int ps, int maxp,
                      cudaStream_t stream) {
  if (g <= 2)
    return launch<HD, 2>(q, k, v, kpos, page_table, qpos, active, out, b, kvh, g, ps, maxp,
                         stream);
  if (g <= 4)
    return launch<HD, 4>(q, k, v, kpos, page_table, qpos, active, out, b, kvh, g, ps, maxp,
                         stream);
  return launch<HD, 8>(q, k, v, kpos, page_table, qpos, active, out, b, kvh, g, ps, maxp,
                       stream);
}

}  // namespace

// C interface, loaded with ctypes.  q: (B, KVH*G, hd) bf16, pre-scaled;
// k/v: (P, ps, KVH, hd) bf16; kpos: (P, ps) int32; page_table: (B, MAXP)
// int32; qpos: (B,) int32; active: (B,) bool (one byte each); out: like q.
// All contiguous, 16-byte aligned.  Launches on `stream`, does not
// synchronise, and returns cudaGetLastError() (0 on success).
extern "C" int paged_flash_decode_bf16(const void* q, const void* k, const void* v,
                                       const void* kpos, const void* page_table,
                                       const void* qpos, const void* active, void* out,
                                       int b, int kvh, int g, int hd, int ps, int maxp,
                                       void* stream) {
  if (b < 1 || kvh < 1 || g < 1 || g > kMaxG || ps < 1 || maxp < 1 ||
      (long long)maxp * ps >= (1LL << 30) || (long long)b * kvh * kSplit >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16:
      return (int)launch_hd<16>(q, k, v, kpos, page_table, qpos, active, out, b, kvh, g, ps,
                                maxp, st);
    case 64:
      return (int)launch_hd<64>(q, k, v, kpos, page_table, qpos, active, out, b, kvh, g, ps,
                                maxp, st);
    case 128:
      return (int)launch_hd<128>(q, k, v, kpos, page_table, qpos, active, out, b, kvh, g, ps,
                                 maxp, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
