// Paged single-query flash decode for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/flash_decode.py
// paged_flash_decode (body _paged_kernel).  For each lane b and kv head h
// it computes single-query attention of the G = H / KVH query heads of that
// group over the lane's pages page_table[b, 0..MAXP):
//
//   * a key counts iff kpos <= qpos[b] and active[b] (the never-written
//     sentinel 2^30, the trash page 0 and stale rows all fail the test);
//   * online f32 softmax with NEG_INF = -1e30; p is taken from the mask,
//     not from the scores, so a fully masked page adds exact zeros;
//   * p is rounded to bf16 before the PV product, sums stay f32;
//   * out = acc / max(l, 1e-30) in bf16, so an inactive lane is exact zeros.
//
// What bounds it: device-memory bytes.  One decode call reads
//   B*MAXP*ps*KVH*hd*2 (K) + the same for V + B*MAXP*ps*4 (kpos)
// plus q, the page table and the output, which are small.  At B=8, MAXP=128,
// ps=16, KVH=3, hd=64 that is about 12.6 MB: 3.8 us at 3.35 TB/s.  Its
// arithmetic is ~2*2*G flops per K/V element, far below the H100's
// flop-to-byte balance, so plain FMAs suffice: G is 3 (2 reduced), not a
// tensor-core tile, and is not padded to 8 as the TPU wrapper pads it.
//
// Design (simple first): one block of 128 threads per (b, h) runs the
// decode body of decode_attn.cuh over the lane's pages, one page per tile.
// The loader reads the block's own page-table entry (the TPU's scalar-
// prefetched BlockSpec gather) and stages the page's K and V tiles (ps x hd
// bf16, 2 KB each at ps=16, hd=64) in shared memory with coalesced 16-byte
// loads.  Known limits, left to later work: B*KVH blocks (24 at B=8)
// underfill the 132 SMs, loads are not overlapped with compute, and every
// page of the table is walked (no early stop at page qpos // ps, no split
// over pages with a combine pass).
#include "decode_attn.cuh"

namespace {

using decode_attn::kMaxG;
using decode_attn::kThreads;
using decode_attn::Tiles;

template <int HD>
__global__ void __launch_bounds__(kThreads)
paged_flash_decode_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          const int* __restrict__ kpos,
                          const int* __restrict__ page_table,
                          const int* __restrict__ qpos,
                          const unsigned char* __restrict__ active,
                          __nv_bfloat16* __restrict__ out,
                          int kvh, int g, int ps, int maxp) {
  constexpr int kVec = 8;  // bf16 values per 16-byte load
  constexpr int kRowVecs = HD / kVec;
  extern __shared__ __align__(16) unsigned char smem[];
  const Tiles<HD, __nv_bfloat16> t(smem, g, ps);

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
    const size_t base = ((size_t)page * ps * kvh + h) * HD;
    for (int i = threadIdx.x; i < ps * kRowVecs; i += kThreads) {
      const size_t off = base + (i / kRowVecs) * row_stride + (i % kRowVecs) * kVec;
      reinterpret_cast<uint4*>(t.k)[i] = *reinterpret_cast<const uint4*>(k + off);
      reinterpret_cast<uint4*>(t.v)[i] = *reinterpret_cast<const uint4*>(v + off);
    }
    for (int r = threadIdx.x; r < ps; r += kThreads) t.kpos[r] = kpos[(size_t)page * ps + r];
  };
  decode_attn::decode_group<HD, __nv_bfloat16, true>(q + head0, out + head0, g, ps, maxp,
                                                     qpos[b], 0, t, load);
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, const void* kpos,
                   const void* page_table, const void* qpos, const void* active,
                   void* out, int b, int kvh, int g, int ps, int maxp,
                   cudaStream_t stream) {
  const size_t smem = Tiles<HD, __nv_bfloat16>::bytes(g, ps);
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  paged_flash_decode_kernel<HD><<<b * kvh, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(kpos),
      static_cast<const int*>(page_table), static_cast<const int*>(qpos),
      static_cast<const unsigned char*>(active), static_cast<__nv_bfloat16*>(out),
      kvh, g, ps, maxp);
  return cudaGetLastError();
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
  if (b < 1 || kvh < 1 || g < 1 || g > kMaxG || ps < 1 || maxp < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16:
      return (int)launch<16>(q, k, v, kpos, page_table, qpos, active, out, b, kvh, g, ps,
                             maxp, st);
    case 64:
      return (int)launch<64>(q, k, v, kpos, page_table, qpos, active, out, b, kvh, g, ps,
                             maxp, st);
    case 128:
      return (int)launch<128>(q, k, v, kpos, page_table, qpos, active, out, b, kvh, g, ps,
                              maxp, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
