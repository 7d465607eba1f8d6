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
// Design (simple first): one block of 128 threads per (b, h).  A loop over
// the lane's pages stages each page's K and V tile (ps x hd bf16, 2 KB each
// at ps=16, hd=64) in shared memory with coalesced 16-byte loads; scores are
// f32 dot products, one warp per (query head, row) reduced with shuffles;
// m and l live in the registers of thread g < G, acc in registers spread
// over the block.  Known limits, left to later work: B*KVH blocks (24 at
// B=8) underfill the 132 SMs, loads are not overlapped with compute, and
// every page of the table is walked (no early stop at page qpos // ps, no
// split over pages with a combine pass).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxG = 8;
constexpr float kNegInf = -1e30f;

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
  constexpr int kAcc = (kMaxG * HD + kThreads - 1) / kThreads;
  constexpr int kVec = 8;  // bf16 values per 16-byte load
  constexpr int kRowVecs = HD / kVec;

  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem);  // [ps][HD]
  __nv_bfloat16* v_s = k_s + ps * HD;                             // [ps][HD]
  float* q_s = reinterpret_cast<float*>(v_s + ps * HD);           // [g][HD]
  float* p_s = q_s + g * HD;                                      // [g][ps]
  float* alpha_s = p_s + g * ps;                                  // [kMaxG]
  float* l_s = alpha_s + kMaxG;                                   // [kMaxG]
  int* kpos_s = reinterpret_cast<int*>(l_s + kMaxG);              // [ps]

  const int b = blockIdx.x / kvh;
  const int h = blockIdx.x % kvh;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int heads = kvh * g;
  const int lane_qpos = qpos[b];
  const bool lane_active = active[b] != 0;

  // the group's query rows, once, as f32
  const __nv_bfloat16* qb = q + ((size_t)b * heads + (size_t)h * g) * HD;
  for (int i = tid; i < g * HD; i += kThreads) q_s[i] = __bfloat162float(qb[i]);

  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
  float m_run = kNegInf;  // owned by thread tid < g (query head tid)
  float l_run = 0.f;

  const size_t row_stride = (size_t)kvh * HD;  // elements between page rows
  for (int j = 0; j < maxp; ++j) {
    const int page = page_table[(size_t)b * maxp + j];
    const size_t base = ((size_t)page * ps * kvh + h) * HD;
    for (int i = tid; i < ps * kRowVecs; i += kThreads) {
      const int r = i / kRowVecs;
      const int c = i % kRowVecs;
      const size_t off = base + r * row_stride + c * kVec;
      reinterpret_cast<uint4*>(k_s)[i] = *reinterpret_cast<const uint4*>(k + off);
      reinterpret_cast<uint4*>(v_s)[i] = *reinterpret_cast<const uint4*>(v + off);
    }
    for (int r = tid; r < ps; r += kThreads) kpos_s[r] = kpos[(size_t)page * ps + r];
    __syncthreads();

    // scores, masked to NEG_INF: one warp per (query head, row)
    for (int pr = warp; pr < g * ps; pr += kWarps) {
      const int gi = pr / ps;
      const int r = pr % ps;
      float part = 0.f;
      for (int d = lane; d < HD; d += 32)
        part += q_s[gi * HD + d] * __bfloat162float(k_s[r * HD + d]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
      if (lane == 0) {
        const bool msk = lane_active && kpos_s[r] <= lane_qpos;
        p_s[gi * ps + r] = msk ? part : kNegInf;
      }
    }
    __syncthreads();

    // online softmax step of query head tid; p replaces the scores in p_s
    if (tid < g) {
      float* s = p_s + tid * ps;
      float m_new = m_run;
      for (int r = 0; r < ps; ++r) m_new = fmaxf(m_new, s[r]);
      float psum = 0.f;
      for (int r = 0; r < ps; ++r) {
        const bool msk = lane_active && kpos_s[r] <= lane_qpos;
        const float p = msk ? expf(s[r] - m_new) : 0.f;
        psum += p;
        s[r] = __bfloat162float(__float2bfloat16(p));
      }
      const float alpha = expf(m_run - m_new);
      l_run = l_run * alpha + psum;
      m_run = m_new;
      alpha_s[tid] = alpha;
    }
    __syncthreads();

    // acc = acc * alpha + p @ V over this page
#pragma unroll
    for (int i = 0; i < kAcc; ++i) {
      const int idx = tid + i * kThreads;
      if (idx < g * HD) {
        const int gi = idx / HD;
        const int d = idx % HD;
        float pv = 0.f;
        for (int r = 0; r < ps; ++r)
          pv += p_s[gi * ps + r] * __bfloat162float(v_s[r * HD + d]);
        acc[i] = acc[i] * alpha_s[gi] + pv;
      }
    }
    __syncthreads();  // the next page overwrites the tiles and p
  }

  if (tid < g) l_s[tid] = l_run;
  __syncthreads();
  __nv_bfloat16* ob = out + ((size_t)b * heads + (size_t)h * g) * HD;
#pragma unroll
  for (int i = 0; i < kAcc; ++i) {
    const int idx = tid + i * kThreads;
    if (idx < g * HD)
      ob[idx] = __float2bfloat16(acc[i] / fmaxf(l_s[idx / HD], 1e-30f));
  }
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, const void* kpos,
                   const void* page_table, const void* qpos, const void* active,
                   void* out, int b, int kvh, int g, int ps, int maxp,
                   size_t smem, cudaStream_t stream) {
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
  const size_t smem = (size_t)2 * ps * hd * sizeof(__nv_bfloat16)
                      + (size_t)g * hd * sizeof(float) + (size_t)g * ps * sizeof(float)
                      + (size_t)2 * kMaxG * sizeof(float) + (size_t)ps * sizeof(int);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16:
      return (int)launch<16>(q, k, v, kpos, page_table, qpos, active, out, b, kvh, g, ps,
                             maxp, smem, st);
    case 64:
      return (int)launch<64>(q, k, v, kpos, page_table, qpos, active, out, b, kvh, g, ps,
                             maxp, smem, st);
    case 128:
      return (int)launch<128>(q, k, v, kpos, page_table, qpos, active, out, b, kvh, g, ps,
                              maxp, smem, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
