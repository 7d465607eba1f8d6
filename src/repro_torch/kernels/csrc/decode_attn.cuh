// The first decode body (sm_90a), now run only by paged_flash_decode_q.cu
// (int8 page arena with f32 row scales).  The bf16 kernels,
// paged_flash_decode.cu and flash_decode.cu, run decode_split.cuh (keys
// split over a thread-block cluster, an exact tile skip by kpos,
// warp-parallel softmax); the int8 kernel is to move onto that body with a
// dequantizing loader.
//
// One block of kThreads threads computes one (lane, kv head): the G query
// heads of that group attend over the lane's keys, walked as tiles.  The
// kernel supplies only its tile loader; the online softmax is this file's:
//
//   * a key counts iff kpos <= qpos and, when window > 0, qpos - kpos <
//     window (the never-written sentinel 2^30 fails the first test);
//   * f32 scores and an online f32 softmax with NEG_INF = -1e30; p is taken
//     from the mask, not from the scores, so a fully masked tile adds exact
//     zeros;
//   * p is rounded to bf16 before the PV product when kRoundP (the bf16
//     caches, as the Pallas kernels cast p to v's dtype) and stays f32
//     otherwise (the dequantized int8 tiles); sums stay f32;
//   * out = acc / max(l, 1e-30) in bf16; an inactive lane writes exact
//     zeros without walking its keys.
//
// Layout: scores are one warp per (query head, key) reduced with shuffles;
// the softmax step of query head g runs on thread g (m and l in its
// registers); acc is spread over the block's registers.  Known limits:
// B*KVH blocks underfill the 132 SMs, each tile is loaded synchronously
// and walked with four block barriers, and every tile is walked (no skip).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace decode_attn {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxG = 8;
constexpr int kSentinel = 1 << 30;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(float x) { return x; }

// One block's shared memory: the K and V tiles ([tile][HD] of T), the
// group's query rows ([g][HD] f32), p ([g][tile] f32), alpha and l
// ([kMaxG] f32 each), and the tile's kpos ([tile] int).
template <int HD, typename T>
struct Tiles {
  T* k;
  T* v;
  float* q;
  float* p;
  float* alpha;
  float* l;
  int* kpos;

  static size_t bytes(int g, int tile) {
    return (size_t)2 * tile * HD * sizeof(T) + (size_t)g * HD * sizeof(float) +
           (size_t)g * tile * sizeof(float) + (size_t)2 * kMaxG * sizeof(float) +
           (size_t)tile * sizeof(int);
  }

  __device__ Tiles(unsigned char* smem, int g, int tile) {
    k = reinterpret_cast<T*>(smem);
    v = k + tile * HD;
    q = reinterpret_cast<float*>(v + tile * HD);
    p = q + g * HD;
    alpha = p + g * tile;
    l = alpha + kMaxG;
    kpos = reinterpret_cast<int*>(l + kMaxG);
  }
};

__device__ __forceinline__ bool keep(int kp, int qpos, int window) {
  return kp <= qpos && (window <= 0 || qpos - kp < window);
}

// Exact zeros for an inactive lane's G rows.
template <int HD>
__device__ __forceinline__ void write_zeros(__nv_bfloat16* __restrict__ ob, int g) {
  for (int i = threadIdx.x; i < g * HD; i += kThreads) ob[i] = __float2bfloat16(0.f);
}

// Attention of the G query rows qb ([g][HD] bf16, pre-scaled) over n_tiles
// tiles of `tile` keys; the result goes to ob ([g][HD] bf16).  load(j)
// stages tile j into t.k, t.v and t.kpos with every thread of the block;
// a row that holds no key gets kpos = kSentinel and finite K/V.
template <int HD, typename T, bool kRoundP, typename Load>
__device__ __forceinline__ void decode_group(const __nv_bfloat16* __restrict__ qb,
                                             __nv_bfloat16* __restrict__ ob, int g,
                                             int tile, int n_tiles, int qpos, int window,
                                             const Tiles<HD, T>& t, Load load) {
  constexpr int kAcc = (kMaxG * HD + kThreads - 1) / kThreads;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  for (int i = tid; i < g * HD; i += kThreads) t.q[i] = __bfloat162float(qb[i]);

  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
  float m_run = kNegInf;  // owned by thread tid < g (query head tid)
  float l_run = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    load(j);
    __syncthreads();

    // scores, masked to NEG_INF: one warp per (query head, row)
    for (int pr = warp; pr < g * tile; pr += kWarps) {
      const int gi = pr / tile;
      const int r = pr % tile;
      float part = 0.f;
      for (int d = lane; d < HD; d += 32) part += t.q[gi * HD + d] * to_f32(t.k[r * HD + d]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
      if (lane == 0) t.p[gi * tile + r] = keep(t.kpos[r], qpos, window) ? part : kNegInf;
    }
    __syncthreads();

    // online softmax step of query head tid; p replaces the scores in t.p
    if (tid < g) {
      float* s = t.p + tid * tile;
      float m_new = m_run;
      for (int r = 0; r < tile; ++r) m_new = fmaxf(m_new, s[r]);
      float psum = 0.f;
      for (int r = 0; r < tile; ++r) {
        const float p = keep(t.kpos[r], qpos, window) ? expf(s[r] - m_new) : 0.f;
        psum += p;
        s[r] = kRoundP ? __bfloat162float(__float2bfloat16(p)) : p;
      }
      const float alpha = expf(m_run - m_new);
      l_run = l_run * alpha + psum;
      m_run = m_new;
      t.alpha[tid] = alpha;
    }
    __syncthreads();

    // acc = acc * alpha + p @ V over this tile
#pragma unroll
    for (int i = 0; i < kAcc; ++i) {
      const int idx = tid + i * kThreads;
      if (idx < g * HD) {
        const int gi = idx / HD;
        const int d = idx % HD;
        float pv = 0.f;
        for (int r = 0; r < tile; ++r) pv += t.p[gi * tile + r] * to_f32(t.v[r * HD + d]);
        acc[i] = acc[i] * t.alpha[gi] + pv;
      }
    }
    __syncthreads();  // the next tile overwrites K, V, kpos and p
  }

  if (tid < g) t.l[tid] = l_run;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kAcc; ++i) {
    const int idx = tid + i * kThreads;
    if (idx < g * HD) ob[idx] = __float2bfloat16(acc[i] / fmaxf(t.l[idx / HD], 1e-30f));
  }
}

}  // namespace decode_attn
