// Paged single-query flash decode over an int8 KV arena for NVIDIA Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/flash_decode.py
// paged_flash_decode_q (body _paged_kernel_q).  It walks the same pages as
// paged_flash_decode.cu, but the arena holds int8 K/V with one f32 scale
// per row per kv head ((P, ps, KVH) planes, core/quant.kv_quantize):
//
//   * each page's tiles are dequantized into shared memory as
//     float(int8) * scale, one rounding, as kv_dequantize computes them;
//   * q is promoted to f32, scores and the online softmax are f32, and p
//     stays f32 for the PV product (decode_attn.cuh with kRoundP = false);
//   * a key counts iff kpos <= qpos[b] and active[b]; out is bf16 (q's
//     dtype), exact zeros for an inactive lane.
//
// What bounds it: device-memory bytes.  One call reads
//   B*MAXP*ps*KVH*hd (int8 K) + the same for V + 2*B*MAXP*ps*KVH*4 (the
//   scales) + B*MAXP*ps*4 (kpos)
// plus q, the page table and the output: (2 hd + 8 + 4/KVH) / (4 hd +
// 4/KVH) of the bf16 arena's bytes, 0.53 at hd=64, KVH=3.  At B=8,
// MAXP=128, ps=16 that is 6.75 MB, 2.0 us at 3.35 TB/s; the arithmetic is
// ~4*G flops per element, far below the card's flop-to-byte balance.
//
// Design (simple first): one block of 128 threads per (b, h), one page per
// tile.  The loader reads 16 int8 values per 16-byte load, multiplies them
// by the row's scale and stores f32 tiles (ps x hd, 4 KB each at ps=16,
// hd=64).  Known limits, left to later work: as paged_flash_decode.cu
// (B*KVH blocks underfill the SMs, no overlap of loads and compute, every
// page of the table walked), and the f32 tiles double the shared-memory
// traffic of the dot products against keeping int8 tiles.
#include "decode_attn.cuh"

namespace {

using decode_attn::kMaxG;
using decode_attn::kThreads;
using decode_attn::Tiles;

template <int HD>
__global__ void __launch_bounds__(kThreads)
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
  constexpr int kVec = 16;  // int8 values per 16-byte load
  constexpr int kRowVecs = HD / kVec;
  extern __shared__ __align__(16) unsigned char smem[];
  const Tiles<HD, float> t(smem, g, ps);

  const int b = blockIdx.x / kvh;
  const int h = blockIdx.x % kvh;
  const size_t head0 = ((size_t)b * kvh + h) * g * HD;  // this group's q/out rows
  if (!active[b]) {
    decode_attn::write_zeros<HD>(out + head0, g);
    return;
  }
  const size_t row_stride = (size_t)kvh * HD;  // elements between page rows
  auto load = [&](int j) {
    const int page = page_table[(size_t)b * maxp + j];
    const size_t row0 = (size_t)page * ps;  // the page's first arena row
    for (int i = threadIdx.x; i < ps * kRowVecs; i += kThreads) {
      const int r = i / kRowVecs;
      const int c = (i % kRowVecs) * kVec;
      const size_t off = (row0 + r) * row_stride + (size_t)h * HD + c;
      const size_t srow = (row0 + r) * kvh + h;
      const float ks = k_scale[srow];
      const float vs = v_scale[srow];
      const uint4 kx = *reinterpret_cast<const uint4*>(k + off);
      const uint4 vx = *reinterpret_cast<const uint4*>(v + off);
      const int8_t* k8 = reinterpret_cast<const int8_t*>(&kx);
      const int8_t* v8 = reinterpret_cast<const int8_t*>(&vx);
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        t.k[r * HD + c + e] = (float)k8[e] * ks;
        t.v[r * HD + c + e] = (float)v8[e] * vs;
      }
    }
    for (int r = threadIdx.x; r < ps; r += kThreads) t.kpos[r] = kpos[row0 + r];
  };
  decode_attn::decode_group<HD, float, false>(q + head0, out + head0, g, ps, maxp, qpos[b], 0,
                                              t, load);
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, const void* k_scale,
                   const void* v_scale, const void* kpos, const void* page_table,
                   const void* qpos, const void* active, void* out, int b, int kvh, int g,
                   int ps, int maxp, cudaStream_t stream) {
  const size_t smem = Tiles<HD, float>::bytes(g, ps);
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  paged_flash_decode_q_kernel<HD><<<b * kvh, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const int8_t*>(k),
      static_cast<const int8_t*>(v), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const int*>(kpos),
      static_cast<const int*>(page_table), static_cast<const int*>(qpos),
      static_cast<const unsigned char*>(active), static_cast<__nv_bfloat16*>(out), kvh, g,
      ps, maxp);
  return cudaGetLastError();
}

}  // namespace

// C interface, loaded with ctypes.  q: (B, KVH*G, hd) bf16, pre-scaled;
// k/v: (P, ps, KVH, hd) int8; k_scale/v_scale: (P, ps, KVH) f32; kpos:
// (P, ps) int32; page_table: (B, MAXP) int32; qpos: (B,) int32; active:
// (B,) bool (one byte each); out: like q.  All contiguous, 16-byte aligned.
// Launches on `stream`, does not synchronise, and returns
// cudaGetLastError() (0 on success).
extern "C" int paged_flash_decode_q_int8(const void* q, const void* k, const void* v,
                                         const void* k_scale, const void* v_scale,
                                         const void* kpos, const void* page_table,
                                         const void* qpos, const void* active, void* out,
                                         int b, int kvh, int g, int hd, int ps, int maxp,
                                         void* stream) {
  if (b < 1 || kvh < 1 || g < 1 || g > kMaxG || ps < 1 || maxp < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16:
      return (int)launch<16>(q, k, v, k_scale, v_scale, kpos, page_table, qpos, active, out,
                             b, kvh, g, ps, maxp, st);
    case 64:
      return (int)launch<64>(q, k, v, k_scale, v_scale, kpos, page_table, qpos, active, out,
                             b, kvh, g, ps, maxp, st);
    case 128:
      return (int)launch<128>(q, k, v, k_scale, v_scale, kpos, page_table, qpos, active, out,
                              b, kvh, g, ps, maxp, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
