// Paged single-query flash decode over an int8 KV arena for NVIDIA Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/flash_decode.py
// paged_flash_decode_q (body _paged_kernel_q).  It walks the same slots as
// paged_flash_decode.cu (slot s of lane b is row s % ps of arena page
// page_table[b, s / ps]), but the arena holds int8 K/V with one f32 scale
// per row per kv head ((P, ps, KVH) planes, core/quant.kv_quantize):
//
//   * K and V are dequantized as float(int8) * scale, one rounding each,
//     as kv_dequantize computes them; q is promoted to f32;
//   * scores, the online softmax and the PV product are f32, and p is not
//     rounded (decode_split.cuh with kRoundP = false);
//   * a key counts iff kpos <= qpos[b] and active[b]; out is bf16 (q's
//     dtype), exact zeros for an inactive lane.
//
// What bounds it: device-memory bytes.  One call reads, for the keys the
// active lanes keep, the int8 K and V rows (hd bytes each per kv head)
// and their two f32 scales, plus the kpos and page-table entries of the
// walked slots: (2 hd + 8) / (4 hd) of the bf16 arena's row bytes, 0.53
// at hd 64.  At B=8, MAXP=128, ps=16, KVH=3, hd=64 that is ~2.8 MB, under
// 1 us at 3.35 TB/s; the arithmetic is ~4*G flops per element, far below
// the card's flop-to-byte balance.  At the serve shapes the floor is
// latency: the launch, the page id -> kpos -> K/V chain, and two cluster
// barriers.
//
// Design: decode_split.cuh's body, as the bf16 kernels (one cluster of 8
// blocks per (b, h), the lane's slots split into 32-slot tiles over the
// cluster's blocks and their warps, an exact skip of tiles with no kept
// key by their kpos, 2-stage cp.async rings per warp, warp-parallel
// scores and a sub-stream online softmax with one exp per key and head,
// one combine through distributed shared memory).  This file supplies
// the loader: PagedLoader's row and page arithmetic over int8 rows of hd
// bytes (hd/16 16-byte chunks each), and a scaled row: lane r of a warp
// copies row r's K and V scales into the stage with 4-byte cp.async
// beside the row's chunks (zero-filled for a row that does not count),
// and the scoring lanes multiply each unpacked int8 value by its row's
// scale before the dot and the PV product.  The scale is applied to the
// values, not folded into the score or into p, so the kernel computes
// the plain version's products value for value.
//
// Known limits: as paged_flash_decode.cu (every slot's page id and kpos
// up to MAXP*ps is read; a tile's first byte waits on two dependent
// loads; the split is 8 whatever the lane's length).
#include "decode_split.cuh"

namespace {

using decode_split::kMaxG;
using decode_split::kSentinel;
using decode_split::kSplit;
using decode_split::kThreads;

template <int HD>
struct PagedQLoader {
  static constexpr int kRowBytes = HD;  // one int8 per value
  static constexpr bool kScaled = true;
  const int8_t* k;
  const int8_t* v;
  const float* k_scale;
  const float* v_scale;
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
    return k + ((size_t)r * kvh + h) * HD + c * 16;
  }
  __device__ const void* v_src(int r, int c) const {
    return v + ((size_t)r * kvh + h) * HD + c * 16;
  }
  __device__ const float* ks_src(int r) const { return k_scale + (size_t)r * kvh + h; }
  __device__ const float* vs_src(int r) const { return v_scale + (size_t)r * kvh + h; }
  // values 8c..8c+7 of an int8 row: 8 bytes at 8c, each exactly to f32
  __device__ static void unpack(const unsigned char* row, int c, float out[8]) {
    const uint2 u = reinterpret_cast<const uint2*>(row)[c];
    const unsigned w[2] = {u.x, u.y};
#pragma unroll
    for (int i = 0; i < 8; ++i)
      out[i] = (float)(int8_t)(unsigned char)(w[i / 4] >> (8 * (i % 4)));
  }
};

template <int HD, int GMAX>
__global__ void __cluster_dims__(kSplit, 1, 1) __launch_bounds__(kThreads, 1)
paged_flash_decode_q_kernel(const __nv_bfloat16* __restrict__ q,
                            const int8_t* __restrict__ k, const int8_t* __restrict__ v,
                            const float* __restrict__ k_scale,
                            const float* __restrict__ v_scale,
                            const int* __restrict__ kpos,
                            const int* __restrict__ page_table,
                            const int* __restrict__ qpos,
                            const unsigned char* __restrict__ active,
                            __nv_bfloat16* __restrict__ out, int kvh, int g, int ps,
                            int maxp) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int item = blockIdx.x / kSplit;  // one cluster per (b, h)
  const int b = item / kvh;
  const int h = item % kvh;
  const size_t head0 = ((size_t)b * kvh + h) * g * HD;  // this group's q/out rows
  if (!active[b]) {
    decode_split::write_zeros<HD>(out + head0, g);
    return;
  }
  const PagedQLoader<HD> ld{k, v, k_scale, v_scale, kpos, page_table + (size_t)b * maxp,
                            h, kvh, ps, maxp};
  decode_split::decode<HD, GMAX, false>(q + head0, out + head0, g, qpos[b], 0, ld, smem);
}

template <int HD, int GMAX>
cudaError_t launch(const void* q, const void* k, const void* v, const void* k_scale,
                   const void* v_scale, const void* kpos, const void* page_table,
                   const void* qpos, const void* active, void* out, int b, int kvh, int g,
                   int ps, int maxp, cudaStream_t stream) {
  constexpr size_t smem = decode_split::Smem<HD, GMAX, PagedQLoader<HD>>::kBytes;
  auto kernel = paged_flash_decode_q_kernel<HD, GMAX>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<kSplit * b * kvh, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const int8_t*>(k),
      static_cast<const int8_t*>(v), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const int*>(kpos),
      static_cast<const int*>(page_table), static_cast<const int*>(qpos),
      static_cast<const unsigned char*>(active), static_cast<__nv_bfloat16*>(out), kvh, g,
      ps, maxp);
  return cudaGetLastError();
}

// G rounds up to a compiled group width: 2, 4 or 8
template <int HD>
cudaError_t launch_hd(const void* q, const void* k, const void* v, const void* k_scale,
                      const void* v_scale, const void* kpos, const void* page_table,
                      const void* qpos, const void* active, void* out, int b, int kvh, int g,
                      int ps, int maxp, cudaStream_t stream) {
  if (g <= 2)
    return launch<HD, 2>(q, k, v, k_scale, v_scale, kpos, page_table, qpos, active, out, b,
                         kvh, g, ps, maxp, stream);
  if (g <= 4)
    return launch<HD, 4>(q, k, v, k_scale, v_scale, kpos, page_table, qpos, active, out, b,
                         kvh, g, ps, maxp, stream);
  return launch<HD, 8>(q, k, v, k_scale, v_scale, kpos, page_table, qpos, active, out, b,
                       kvh, g, ps, maxp, stream);
}

}  // namespace

// C interface, loaded with ctypes.  q: (B, KVH*G, hd) bf16, pre-scaled;
// k/v: (P, ps, KVH, hd) int8; k_scale/v_scale: (P, ps, KVH) f32; kpos:
// (P, ps) int32; page_table: (B, MAXP) int32; qpos: (B,) int32; active:
// (B,) bool (one byte each); out: like q.  All contiguous; q, k and v
// 16-byte aligned.  Launches on `stream`, does not synchronise, and
// returns cudaGetLastError() (0 on success).
extern "C" int paged_flash_decode_q_int8(const void* q, const void* k, const void* v,
                                         const void* k_scale, const void* v_scale,
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
      return (int)launch_hd<16>(q, k, v, k_scale, v_scale, kpos, page_table, qpos, active,
                                out, b, kvh, g, ps, maxp, st);
    case 64:
      return (int)launch_hd<64>(q, k, v, k_scale, v_scale, kpos, page_table, qpos, active,
                                out, b, kvh, g, ps, maxp, st);
    case 128:
      return (int)launch_hd<128>(q, k, v, k_scale, v_scale, kpos, page_table, qpos, active,
                                 out, b, kvh, g, ps, maxp, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
