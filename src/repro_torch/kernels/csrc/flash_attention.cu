// Prefill flash attention for NVIDIA Hopper (sm_90a), causal or not.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py
// flash_attention (body _kernel), reached from repro/kernels/ops.py
// flash_attention on the long-prefill route at contiguous positions.  For
// query head h of batch row b it computes, over positions 0..S-1:
//
//   * s = (q . k) * 1/sqrt(hd): the dot summed in f32 from the unscaled
//     inputs, the scale applied to the f32 score, as the Pallas body does;
//   * under causal, key j counts for query i iff j <= i; keys past S (the
//     ragged last tile) never count;
//   * an online f32 softmax with NEG_INF = -1e30, p taken from the mask;
//     p rounded to bf16 before the PV product when v is bf16 (the body
//     casts p to v's dtype), kept f32 for f32 inputs; sums in f32;
//   * out = acc / max(l, 1e-30), in q's dtype.
//
// What bounds it on this card: operations.  One causal call does
// 4*B*H*S^2*hd/2 flops on Q+K+V+O bytes that are read and written once: at
// smollm-135m's B=1, S=4096, H=9, hd=64 that is 19.3 GFLOP over 14 MB,
// ~1,400 flop per byte, far above the H100's ~295 bf16 flop per byte of
// HBM.  The bound is the bf16 tensor-core peak (989 TFLOP/s).
//
// Design (simple first; tensor cores, wgmma and TMA are later work): the
// Pallas grid's sequential KV-block axis becomes a loop inside one block of
// 256 threads per (b*h, 64-query tile).  The block reads kv head h / G in
// place (no copy of K/V per query head, no padding copy), stages its Q tile
// once and each 64-key K and V tile as f32 in shared memory (rows padded
// by 4 floats, so the 16-byte reads below hit distinct banks), and masks
// the ragged tail itself.  Under causal it walks key tiles 0..qt only, the
// diagonal included: tile 0 always holds key 0, which every query row
// counts, so no row ever sums exp(0) over a fully masked first tile.
// Thread t owns query rows 4(t/16)..+3 of the tile, both for the 4 x 4
// scores it computes (keys t%16 + 16i) and for its slice of the output
// accumulator, so each row's max and sum are reduced over the 16 lanes of
// one half-warp with shuffles: the softmax step runs spread over threads,
// not on one thread per row.  The QK and PV products are f32 FMAs.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;  // query rows per block and keys per tile
constexpr int kRows = 4;   // query rows per thread
constexpr int kKeys = 4;   // keys per thread per tile: c, c+16, c+32, c+48
constexpr int kPLd = kTile + 4;  // shared row stride of the p tile (floats)
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(float x) { return x; }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <int HD>
__host__ __device__ constexpr int row_ld() {
  return HD + 4;  // shared row stride of the Q, K and V tiles (floats)
}

template <int HD>
__host__ __device__ constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)3 * kTile * row_ld<HD>() + (size_t)kTile * kPLd);
}

// Stage rows r0..r0+63 of one head (`stride` elements between rows) into
// shared rows of row_ld<HD>() floats; rows at or past s become zeros.
template <int HD, typename T>
__device__ __forceinline__ void stage(float* __restrict__ dst, const T* __restrict__ src,
                                      size_t stride, int r0, int s) {
  constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte load
  constexpr int kRowVecs = HD / kVec;
  for (int i = threadIdx.x; i < kTile * kRowVecs; i += kThreads) {
    const int r = i / kRowVecs;
    const int col = (i % kRowVecs) * kVec;
    float x[kVec];
    if (r0 + r < s) {
      const uint4 raw = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * stride + col);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < kVec; ++j) x[j] = to_f32(e[j]);
    } else {
#pragma unroll
      for (int j = 0; j < kVec; ++j) x[j] = 0.f;
    }
    float4* d = reinterpret_cast<float4*>(dst + r * row_ld<HD>() + col);
#pragma unroll
    for (int j = 0; j < kVec / 4; ++j)
      d[j] = make_float4(x[4 * j], x[4 * j + 1], x[4 * j + 2], x[4 * j + 3]);
  }
}

// grid: (ceil(S / 64) query tiles, B*H); q/out: (B, S, H, hd); k/v: (B, S,
// KVH, hd); query head hq reads kv head hq / (H / KVH).
template <int HD, typename T, bool kCausal>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int s, int h, int kvh,
                       float scale) {
  constexpr int kLd = row_ld<HD>();
  constexpr int kDims = HD / 16;                 // output dims per thread
  constexpr int kVecD = kDims < 4 ? kDims : 4;   // contiguous dims per chunk
  constexpr int kChunks = kDims / kVecD;         // chunks 16*kVecD dims apart
  constexpr bool kRoundP = sizeof(T) == 2;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* ks = qs + kTile * kLd;
  float* vs = ks + kTile * kLd;
  float* ps = vs + kTile * kLd;

  const int qt = gridDim.x - 1 - blockIdx.x;  // the longest causal rows first
  const int b = blockIdx.y / h;
  const int hq = blockIdx.y % h;
  const int hk = hq / (h / kvh);
  const int q0 = qt * kTile;
  const size_t qstride = (size_t)h * HD;
  const size_t kstride = (size_t)kvh * HD;
  const T* qb = q + (size_t)b * s * qstride + (size_t)hq * HD;
  const T* kb = k + (size_t)b * s * kstride + (size_t)hk * HD;
  const T* vb = v + (size_t)b * s * kstride + (size_t)hk * HD;
  T* ob = out + (size_t)b * s * qstride + (size_t)hq * HD;

  const int row0 = (threadIdx.x >> 4) * kRows;  // this thread's first tile row
  const int c = threadIdx.x & 15;               // its key / dim-chunk lane

  stage<HD, T>(qs, qb, qstride, q0, s);

  float m_run[kRows], l_run[kRows], acc[kRows][kDims];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m_run[i] = kNegInf;
    l_run[i] = 0.f;
#pragma unroll
    for (int e = 0; e < kDims; ++e) acc[i][e] = 0.f;
  }

  const int n_kt = kCausal ? qt + 1 : (s + kTile - 1) / kTile;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kTile;
    stage<HD, T>(ks, kb, kstride, k0, s);
    stage<HD, T>(vs, vb, kstride, k0, s);
    __syncthreads();

    // scores of rows row0..+3 against keys c + 16j, f32 sums over hd
    float sc[kRows][kKeys];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kKeys; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 qv[kRows], kv[kKeys];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        qv[i] = *reinterpret_cast<const float4*>(qs + (row0 + i) * kLd + d);
#pragma unroll
      for (int j = 0; j < kKeys; ++j)
        kv[j] = *reinterpret_cast<const float4*>(ks + (c + 16 * j) * kLd + d);
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kKeys; ++j) {
          float a = sc[i][j];
          a = fmaf(qv[i].x, kv[j].x, a);
          a = fmaf(qv[i].y, kv[j].y, a);
          a = fmaf(qv[i].z, kv[j].z, a);
          a = fmaf(qv[i].w, kv[j].w, a);
          sc[i][j] = a;
        }
    }

    // online softmax step of each row, reduced over its 16 lanes
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qi = q0 + row0 + i;
      bool ok[kKeys];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        const int kj = k0 + c + 16 * j;
        ok[j] = kj < s && (!kCausal || kj <= qi);
        sc[i][j] = ok[j] ? sc[i][j] * scale : kNegInf;
        mx = fmaxf(mx, sc[i][j]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m_run[i], mx);
      const float alpha = expf(m_run[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        const float p = ok[j] ? expf(sc[i][j] - m_new) : 0.f;
        psum += p;
        ps[(row0 + i) * kPLd + c + 16 * j] = kRoundP ? to_f32(from_f32<T>(p)) : p;
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) psum += __shfl_xor_sync(0xffffffffu, psum, o);
      l_run[i] = l_run[i] * alpha + psum;
      m_run[i] = m_new;
#pragma unroll
      for (int e = 0; e < kDims; ++e) acc[i][e] *= alpha;
    }
    __syncwarp();  // a row's p comes from the 16 lanes of its own half-warp

    // acc += p @ V over this tile: dims ch*16*kVecD + c*kVecD + e
#pragma unroll 2
    for (int j = 0; j < kTile; j += 4) {
      float4 pv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        pv[i] = *reinterpret_cast<const float4*>(ps + (row0 + i) * kPLd + j);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float* vr = vs + (j + jj) * kLd + c * kVecD;
        float vv[kDims];
#pragma unroll
        for (int ch = 0; ch < kChunks; ++ch) {
          const float* src = vr + ch * 16 * kVecD;
          if constexpr (kVecD == 4) {
            const float4 t = *reinterpret_cast<const float4*>(src);
            vv[ch * 4] = t.x;
            vv[ch * 4 + 1] = t.y;
            vv[ch * 4 + 2] = t.z;
            vv[ch * 4 + 3] = t.w;
          } else if constexpr (kVecD == 2) {
            const float2 t = *reinterpret_cast<const float2*>(src);
            vv[ch * 2] = t.x;
            vv[ch * 2 + 1] = t.y;
          } else {
            vv[ch] = src[0];
          }
        }
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const float p = jj == 0 ? pv[i].x : jj == 1 ? pv[i].y : jj == 2 ? pv[i].z : pv[i].w;
#pragma unroll
          for (int e = 0; e < kDims; ++e) acc[i][e] = fmaf(p, vv[e], acc[i][e]);
        }
      }
    }
    __syncthreads();  // the next tile overwrites K, V and p
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qi = q0 + row0 + i;
    if (qi >= s) continue;
    const float l = fmaxf(l_run[i], 1e-30f);
    T* orow = ob + (size_t)qi * qstride + c * kVecD;
#pragma unroll
    for (int ch = 0; ch < kChunks; ++ch)
#pragma unroll
      for (int e = 0; e < kVecD; ++e)
        orow[ch * 16 * kVecD + e] = from_f32<T>(acc[i][ch * kVecD + e] / l);
  }
}

template <int HD, typename T, bool kCausal>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int b, int s, int h,
                   int kvh, cudaStream_t stream) {
  const size_t smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<HD, T, kCausal>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  // the Pallas kernel's scale: 1/sqrt(hd) as a double, rounded to f32
  const float scale = (float)(1.0 / sqrt((double)HD));
  const dim3 grid((s + kTile - 1) / kTile, b * h);
  flash_attention_kernel<HD, T, kCausal><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), s, h, kvh, scale);
  return cudaGetLastError();
}

template <int HD, typename T>
cudaError_t launch_causal(const void* q, const void* k, const void* v, void* out, int b, int s,
                          int h, int kvh, int causal, cudaStream_t st) {
  return causal ? launch<HD, T, true>(q, k, v, out, b, s, h, kvh, st)
                : launch<HD, T, false>(q, k, v, out, b, s, h, kvh, st);
}

template <typename T>
cudaError_t launch_hd(const void* q, const void* k, const void* v, void* out, int b, int s,
                      int h, int kvh, int hd, int causal, cudaStream_t st) {
  switch (hd) {
    case 16:
      return launch_causal<16, T>(q, k, v, out, b, s, h, kvh, causal, st);
    case 32:
      return launch_causal<32, T>(q, k, v, out, b, s, h, kvh, causal, st);
    case 64:
      return launch_causal<64, T>(q, k, v, out, b, s, h, kvh, causal, st);
    case 128:
      return launch_causal<128, T>(q, k, v, out, b, s, h, kvh, causal, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// C interface, loaded with ctypes.  q/out: (B, S, H, hd); k/v: (B, S, KVH,
// hd); all bf16 (bf16 = 1) or all f32 (bf16 = 0), contiguous, 16-byte
// aligned; q unscaled; hd in {16, 32, 64, 128}; H a multiple of KVH.
// Launches on `stream`, does not synchronise, and returns
// cudaGetLastError() (0 on success).
extern "C" int flash_attention(const void* q, const void* k, const void* v, void* out, int b,
                               int s, int h, int kvh, int hd, int bf16, int causal,
                               void* stream) {
  if (b < 1 || s < 1 || kvh < 1 || h < kvh || h % kvh != 0 || (long long)b * h > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(bf16 ? launch_hd<__nv_bfloat16>(q, k, v, out, b, s, h, kvh, hd, causal, st)
                    : launch_hd<float>(q, k, v, out, b, s, h, kvh, hd, causal, st));
}
