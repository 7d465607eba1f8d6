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
// smollm-135m's B=2, S=4096, H=9, hd=64 that is 38.7 GFLOP over 25 MB,
// ~1,500 flop per byte, far above the H100's ~295 bf16 flop per byte of
// HBM.  The bound is the tensor-core peak of the products' type: 989
// TFLOP/s in bf16, 67 TFLOP/s of f32 FMAs for the f32 kernel.
//
// bf16: the tensor-core kernel (flash_attention_kernel_wgmma).  One
// persistent block of three warpgroups per SM walks work items (b, h,
// 128-query tile), longest causal rows first, the long and short ones
// dealt out in turn; the Pallas grid's sequential KV-block axis is a loop
// over 128-key tiles inside an item.
//   * Warpgroup 0 is the producer: one thread issues TMA loads of each
//     item's Q tile and of its K and V tiles into a two-stage ring of
//     each, with "full" mbarriers (TMA reports the bytes) and "empty" ones
//     (each consumer warp arrives when its products have read a tile: K
//     after S = Q K^T, V after O += P V, Q after the item's last S).  So
//     the next tiles, and the next item's Q, load while this tile's math
//     runs.  The tensor maps are 4-D, (hd, heads, S, B), built on the host
//     per call: query head hq reads kv head hq / (H / KVH) in place, with
//     no per-head copy, and TMA fills rows past S with zeros, so no row
//     outside the tensors enters a product.
//   * Tiles stay bf16 in shared memory, each row of kBox = min(hd, 64)
//     elements swizzled over its 32, 64 or 128 bytes (hd 128 as two
//     64-column boxes), the layout the wgmma descriptors name.  At hd 128,
//     Q plus two stages of K and V take 160 KB: one block per SM.
//   * Warpgroups 1 and 2 each own 64 query rows.  S = Q K^T is a chain of
//     wgmma m64n128k16 over hd, both operands from shared memory, f32
//     accumulators; O += P V is a chain of wgmma m64n(hd)k16 with P from
//     registers: for 16-bit inputs the f32 accumulator's fragment is the
//     A operand's after packing pairs to bf16x2, so p never touches
//     shared memory.  V, keys x hd with hd contiguous, is the B operand
//     with the transpose bit.
//   * S of tile kt and O += P V of tile kt - 1 are issued together, and
//     the softmax of tile kt runs while that PV product is in flight.
//     Named barriers give the two consumers turns at the tensor cores, so
//     one's products run while the other computes its softmax.
//   * The softmax step runs on the accumulator fragment in registers: a
//     row's max and sum reduce over the 4 lanes that hold it (shuffles
//     over 1 and 2), and exp(x - m) is taken as 2^(x log2e - m log2e)
//     (ex2.approx), which moves p by ulps before p is rounded to bf16.
//     Only tiles that cross the causal diagonal or the end of S apply the
//     mask, and there p is taken from the mask; key tiles are walked from
//     tile 0, which holds key 0 that every row counts, so no row ever
//     sums exp(0) over a fully masked tile.  O is rescaled only when a
//     row of the warp moved its max.
//   * The output is divided by max(l, 1e-30) and stored as bf16 from
//     registers.
//
// f32: the FMA kernel (flash_attention_kernel), kept as it was.  TF32
// tensor cores keep about 10 mantissa bits and cannot meet the 2e-5 f32
// limit, so both products stay on CUDA-core FMAs: one block of 256
// threads per (b*h, 64-query tile) stages Q and each 64-key K and V tile
// as f32 in shared memory (rows padded by 4 floats), thread t owns 4
// query rows x 4 keys, and a row's max and sum reduce over the 16 lanes
// of a half-warp.
#include <cuda.h>  // CUtensorMap and its enums (types only: no link against libcuda)
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

__device__ __forceinline__ float to_f32(float x) { return x; }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
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

// ---------------------------------------------------------------------------
// bf16: both products on the tensor cores (wgmma), K/V tiles by TMA.
// ---------------------------------------------------------------------------
namespace tc {

// A block is one producer warpgroup and kWG consumer warpgroups of 64
// query rows each; setmaxnreg moves the producer's registers to the
// consumers (40 x 128 + 232 x 256 of the SM's 65,536).
constexpr int kWG = 2;
constexpr int kBM = 64 * kWG;  // query rows per work item
constexpr int kBN = 128;       // keys per K/V tile
constexpr int kStages = 2;     // K and V tiles in flight, each
constexpr int kThreads = 128 * (kWG + 1);
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr float kLog2e = 1.4426950408889634f;

// Shared layout per head_dim, every region 1024-byte aligned: Q | K[0]
// K[1] | V[0] V[1] | barriers.  A tile is stored as hd / kBox boxes of
// rows x kBox elements, each row kRowBytes long and swizzled over
// kRowBytes (TMA writes it so, and the wgmma descriptors read it so).
template <int HD>
struct Cfg {
  static constexpr int kBox = HD < 64 ? HD : 64;  // elements per swizzled row
  static constexpr int kRowBytes = 2 * kBox;      // 32, 64 or 128: the swizzle span
  static constexpr int kBoxes = HD / kBox;        // 1, or 2 at hd 128
  static constexpr uint32_t kSbo = 8 * kRowBytes;  // bytes between 8-row groups
  // wgmma descriptor layout type: 1 = 128-byte, 2 = 64-byte, 3 = 32-byte swizzle
  static constexpr uint64_t kLayout = kRowBytes == 128 ? 1 : kRowBytes == 64 ? 2 : 3;
  static constexpr int kQBytes = kBM * HD * 2;
  static constexpr int kTileBytes = kBN * HD * 2;  // one K or one V tile
  static constexpr int kBarOff = kQBytes + 2 * kStages * kTileBytes;
  static constexpr size_t kSmem = kBarOff + 128 + 1024;  // 10 barriers, alignment slack
};

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Spin until the barrier's phase of this parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of a 4-D tensor map at (c0, c1, c2, c3) into shared memory at
// dst; completion (the box's full bytes, zeros past the tensor's bounds
// included) is reported to bar.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor: start address, leading and stride byte
// offsets (16-byte units) and the swizzle layout type.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                         uint64_t layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)((lbo >> 4) & 0x3FFF) << 16 |
         (uint64_t)((sbo >> 4) & 0x3FFF) << 32 | layout << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed groups are still running
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of wgmma accumulators
// across the asynchronous product (CUTLASS's warpgroup_fence_operand).
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // round to nearest even
  return *reinterpret_cast<uint32_t*>(&v);
}

// D(64 x 128, f32) (+)= A(64 x 16, smem) B(128 x 16, smem)^T, both K-major
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D(64 x 16, f32) (+)= A(64 x 16, bf16 registers) B(16 x 16, smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8], const uint32_t* a, uint64_t db,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// D(64 x 32, f32) (+)= A(64 x 16, bf16 registers) B(16 x 32, smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t* a, uint64_t db,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// D(64 x 64, f32) (+)= A(64 x 16, bf16 registers) B(16 x 64, smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t* a, uint64_t db,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// D(64 x 128, f32) (+)= A(64 x 16, bf16 registers) B(16 x 128, smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t* a, uint64_t db,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// Named barriers 1..kWG order the consumer warpgroups' turns at the
// tensor cores.
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// S = Q K^T over one key tile: hd / 16 wgmma steps, both operands from
// shared memory, committed as one group and not waited for.
template <int HD>
__device__ __forceinline__ void issue_qk(float (&sc)[kBN / 2], uint32_t q_wg, uint32_t kb) {
  using C = Cfg<HD>;
  constexpr int kSteps = C::kBox / 16;  // 16-element k-steps per swizzled row
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < HD / 16; ++ks) {
    const uint32_t col = (ks % kSteps) * 32, box = ks / kSteps;
    wgmma_ss_n128(sc, desc(q_wg + box * kBM * C::kRowBytes + col, 16, C::kSbo, C::kLayout),
                  desc(kb + box * kBN * C::kRowBytes + col, 16, C::kSbo, C::kLayout), ks > 0);
  }
  wgmma_commit();
}

// O += P V over one key tile: P from registers, V (keys x hd, hd
// contiguous) as the MN-major B operand, 16 keys per step; committed as
// one group and not waited for.
template <int HD>
__device__ __forceinline__ void issue_pv(float (&o)[HD / 2], const uint32_t (&pa)[kBN / 4],
                                         uint32_t vb) {
  using C = Cfg<HD>;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kBN / 16; ++kk) {
    const uint64_t db = desc(vb + kk * 16 * C::kRowBytes, kBN * C::kRowBytes, C::kSbo, C::kLayout);
    if constexpr (HD == 16) wgmma_rs_n16(o, pa + 4 * kk, db, 1);
    if constexpr (HD == 32) wgmma_rs_n32(o, pa + 4 * kk, db, 1);
    if constexpr (HD == 64) wgmma_rs_n64(o, pa + 4 * kk, db, 1);
    if constexpr (HD == 128) wgmma_rs_n128(o, pa + 4 * kk, db, 1);
  }
  wgmma_commit();
}

// One online-softmax step on a tile's scores, in the accumulator fragment:
// element (j, i, c) is register 4j + 2i + c, at query row r0 + 8i and key
// k0 + 8j + cq + c.  sc becomes p (f32); m and l (this thread's columns
// only) advance; alpha rescales the rows' earlier sums.  kMask: the tile
// crosses the causal diagonal or the end of S, and p is taken from the
// mask (key j counts for row r iff j < s and, under causal, j <= r);
// every other tile runs without a mask.
template <bool kCausal, bool kMask>
__device__ __forceinline__ void softmax_step(float (&sc)[kBN / 2], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], float scale, int k0, int s,
                                             int r0, int cq) {
  int lim[2];  // row i keeps the tile's columns 8j + c with 8j + c < lim[i]
#pragma unroll
  for (int i = 0; i < 2; ++i) lim[i] = (kCausal ? min(s, r0 + 8 * i + 1) : s) - k0 - cq;
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float x = sc[4 * j + 2 * i + c] * scale;
        if (kMask && 8 * j + c >= lim[i]) x = kNegInf;
        sc[4 * j + 2 * i + c] = x;
        mx[i] = fmaxf(mx[i], x);
      }
  float ml2[2], psum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {  // a row's max over the 4 lanes that hold it
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    // exp(x - m) as 2^(x log2e - m log2e): moves p by ulps before p is
    // rounded to bf16
    alpha[i] = ex2((m[i] - mx[i]) * kLog2e);
    ml2[i] = mx[i] * kLog2e;
    m[i] = mx[i];
  }
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float p = ex2(fmaf(sc[4 * j + 2 * i + c], kLog2e, -ml2[i]));
        if (kMask && 8 * j + c >= lim[i]) p = 0.f;  // from the mask, not exp(-1e30 - m)
        sc[4 * j + 2 * i + c] = p;
        psum[i] += p;
      }
#pragma unroll
  for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + psum[i];
}

// p rounded to bf16, as the PV product's A fragments: for 16-bit inputs
// the f32 accumulator's fragment is the A operand's after packing pairs.
__device__ __forceinline__ void pack_p(uint32_t (&pa)[kBN / 4], const float (&sc)[kBN / 2]) {
#pragma unroll
  for (int e = 0; e < kBN / 4; ++e) pa[e] = pack_bf16(sc[2 * e], sc[2 * e + 1]);
}

// The work items: one per (query tile, batch row, head), longest causal
// rows first.  A persistent block takes item `round * G + i` in even
// rounds and `round * G + G - 1 - i` in odd ones (G blocks), so the long
// and the short items of each round even out over the blocks.
struct Items {
  int n_qt, bh;  // query tiles per head, B*H
  __device__ __forceinline__ int at(int round) const {
    const int w = round * (int)gridDim.x +
                  ((round & 1) ? (int)gridDim.x - 1 - (int)blockIdx.x : (int)blockIdx.x);
    return w < n_qt * bh ? w : -1;
  }
};

// grid: one persistent block per SM (at most one per item), kThreads
// threads.  tq: (hd, H, S, B) with boxes (kBox, 1, kBM, 1); tk, tv: (hd,
// KVH, S, B) with boxes (kBox, 1, kBN, 1); out: (B, S, H, hd).  Query
// head hq reads kv head hq / (H / KVH).
template <int HD, bool kCausal>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_kernel_wgmma(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv,
                             __nv_bfloat16* __restrict__ out, int nb, int s, int h, int kvh,
                             float scale) {
  using C = Cfg<HD>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sq = (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) + 1023) & ~1023u;
  const uint32_t sk = sq + C::kQBytes;               // K stage st at sk + st * kTileBytes
  const uint32_t sv = sk + kStages * C::kTileBytes;  // V likewise
  // barriers (8 bytes each): Q full, Q empty, then per stage K full, V
  // full, K empty, V empty
  const uint32_t q_full = sq + C::kBarOff, q_empty = q_full + 8;
  const uint32_t k_full = q_full + 16, v_full = k_full + 8 * kStages;
  const uint32_t k_empty = v_full + 8 * kStages, v_empty = k_empty + 8 * kStages;

  const Items items{(s + kBM - 1) / kBM, nb * h};
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, 4 * kWG);  // lane 0 of each consumer warp
#pragma unroll
    for (int st = 0; st < kStages; ++st) {
      mbar_init(k_full + 8 * st, 1);
      mbar_init(v_full + 8 * st, 1);
      mbar_init(k_empty + 8 * st, 4 * kWG);
      mbar_init(v_empty + 8 * st, 4 * kWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one thread keeps the next Q and K/V tiles in flight,
    // across items.  K/V tile g (counted over the block's items) goes to
    // stage g % 2 once the products of tile g - 2 have released it (S =
    // Q K^T for K, O += P V for V); the next item's Q once the last S of
    // the current item is in.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 0) {
      int g = 0;
      for (int round = 0, w; (w = items.at(round)) >= 0; ++round) {
        const int qt = items.n_qt - 1 - w / items.bh;
        const int b = (w % items.bh) / h, hq = w % h, hk = hq / (h / kvh);
        const int q0 = qt * kBM;
        const int n_kt = ((kCausal ? min(s, q0 + kBM) : s) + kBN - 1) / kBN;
        if (round > 0) mbar_wait(q_empty, (round - 1) & 1);
        mbar_expect_tx(q_full, C::kQBytes);
#pragma unroll
        for (int x = 0; x < C::kBoxes; ++x)
          tma_load(sq + x * kBM * C::kRowBytes, &tq, q_full, x * C::kBox, hq, q0, b);
        for (int kt = 0; kt < n_kt; ++kt, ++g) {
          const int st = g % kStages;
          const uint32_t parity = (g / kStages - 1) & 1;
          if (g >= kStages) mbar_wait(k_empty + 8 * st, parity);
          mbar_expect_tx(k_full + 8 * st, C::kTileBytes);
#pragma unroll
          for (int x = 0; x < C::kBoxes; ++x)
            tma_load(sk + st * C::kTileBytes + x * kBN * C::kRowBytes, &tk, k_full + 8 * st,
                     x * C::kBox, hk, kt * kBN, b);
          if (g >= kStages) mbar_wait(v_empty + 8 * st, parity);
          mbar_expect_tx(v_full + 8 * st, C::kTileBytes);
#pragma unroll
          for (int x = 0; x < C::kBoxes; ++x)
            tma_load(sv + st * C::kTileBytes + x * kBN * C::kRowBytes, &tv, v_full + 8 * st,
                     x * C::kBox, hk, kt * kBN, b);
        }
      }
    }
  } else {
    // consumer warpgroup: 64 query rows of each item.  Thread t holds rows
    // r0 and r0 + 8 and, of each group of 8 columns j, columns 8j + cq and
    // 8j + cq + 1.  The products of one tile overlap the softmax of the
    // next: S of tile kt and O += P V of tile kt - 1 are issued together,
    // and the softmax of tile kt runs while the PV product is in flight.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int t = threadIdx.x - 128 * wg;
    const int lane = t % 32;
    const int cq = 2 * (lane % 4);
    const uint32_t q_wg = sq + (wg - 1) * 64 * C::kRowBytes;
    // Turns at the tensor cores go round the consumers (warpgroup c issues
    // its products after warpgroup c - 1 has issued its own), so one
    // warpgroup's products run while the others compute their softmax.
    // Each item starts a round: the last consumer lets consumer 0 go
    // first and does not pass on its last turn.
    const int c = wg - 1;
    const auto take_turn = [&] { bar_sync(1 + c, 256); };
    const auto pass_turn = [&] { bar_arrive(1 + (c + 1) % kWG, 256); };

    float sc[kBN / 2], o[HD / 2], m[2], l[2], alpha[2];
    uint32_t pa[kBN / 4];
#pragma unroll
    for (int e = 0; e < kBN / 2; ++e) sc[e] = 0.f;
    int g = 0;  // K/V tiles consumed over the block's items
    for (int round = 0, w; (w = items.at(round)) >= 0; ++round) {
      const int q0 = (items.n_qt - 1 - w / items.bh) * kBM;
      const int n_kt = ((kCausal ? min(s, q0 + kBM) : s) + kBN - 1) / kBN;
      const int rmin = q0 + c * 64;  // the warpgroup's first query row
      const int r0 = rmin + (t / 32) * 16 + lane / 4;
      // only tiles that cross the causal diagonal or the end of S take the mask
      const auto softmax = [&](int k0) {
        if ((kCausal && k0 + kBN - 1 > rmin) || k0 + kBN > s)
          softmax_step<kCausal, true>(sc, m, l, alpha, scale, k0, s, r0, cq);
        else
          softmax_step<kCausal, false>(sc, m, l, alpha, scale, k0, s, r0, cq);
      };
#pragma unroll
      for (int e = 0; e < HD / 2; ++e) o[e] = 0.f;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        m[i] = kNegInf;
        l[i] = 0.f;
      }
      if (c == kWG - 1) pass_turn();

      mbar_wait(q_full, round & 1);
      mbar_wait(k_full + 8 * (g % kStages), (g / kStages) & 1);
      fence_regs(sc);
      take_turn();
      issue_qk<HD>(sc, q_wg, sk + (g % kStages) * C::kTileBytes);
      pass_turn();
      wgmma_wait<0>();
      fence_regs(sc);
      if (lane == 0) {
        mbar_arrive(k_empty + 8 * (g % kStages));
        if (n_kt == 1) mbar_arrive(q_empty);  // the item's last S is in
      }
      softmax(0);
      pack_p(pa, sc);
      for (int kt = 1; kt < n_kt; ++kt) {
        const int gk = g + kt, gv = g + kt - 1;  // this tile's K, the previous tile's V
        mbar_wait(k_full + 8 * (gk % kStages), (gk / kStages) & 1);
        mbar_wait(v_full + 8 * (gv % kStages), (gv / kStages) & 1);
        fence_regs(sc);
        fence_regs(o);
        fence_regs(pa);
        take_turn();
        issue_qk<HD>(sc, q_wg, sk + (gk % kStages) * C::kTileBytes);
        issue_pv<HD>(o, pa, sv + (gv % kStages) * C::kTileBytes);
        pass_turn();
        wgmma_wait<1>();  // S of tile kt is in
        fence_regs(sc);
        if (lane == 0) {
          mbar_arrive(k_empty + 8 * (gk % kStages));
          if (kt == n_kt - 1) mbar_arrive(q_empty);
        }
        softmax(kt * kBN);
        wgmma_wait<0>();  // O += P V of tile kt - 1 is in
        fence_regs(o);
        fence_regs(pa);
        if (lane == 0) mbar_arrive(v_empty + 8 * (gv % kStages));
        // rescale only when a row of this warp moved its max (alpha == 1
        // leaves o as it is)
        if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
          for (int e = 0; e < HD / 2; ++e) o[e] *= alpha[(e / 2) % 2];
        }
        pack_p(pa, sc);
      }
      const int gv = g + n_kt - 1;
      mbar_wait(v_full + 8 * (gv % kStages), (gv / kStages) & 1);
      fence_regs(o);
      fence_regs(pa);
      take_turn();
      issue_pv<HD>(o, pa, sv + (gv % kStages) * C::kTileBytes);
      if (c != kWG - 1) pass_turn();
      wgmma_wait<0>();
      fence_regs(o);
      if (lane == 0) mbar_arrive(v_empty + 8 * (gv % kStages));
      g += n_kt;

      // out = acc / max(l, 1e-30) in bf16; l summed over the row's 4 lanes
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
        const int row = r0 + 8 * i;
        if (row >= s) continue;
        const float lv = fmaxf(l[i], 1e-30f);
        const int b = (w % items.bh) / h, hq = w % h;
        __nv_bfloat16* orow = out + (((size_t)b * s + row) * h + hq) * HD + cq;
#pragma unroll
        for (int j = 0; j < HD / 8; ++j)
          *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
              __floats2bfloat162_rn(o[4 * j + 2 * i] / lv, o[4 * j + 2 * i + 1] / lv);
      }
    }
  }
}

// cuTensorMapEncodeTiled, taken from the driver at run time so that the
// library needs no link against libcuda
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The 4-D map (hd, heads, S, B) of a contiguous (B, S, heads, hd) bf16
// tensor, with boxes of (kBox, 1, rows, 1) swizzled over kRowBytes; rows
// past S read as zeros.
template <int HD>
bool make_map(EncodeTiled encode, CUtensorMap* map, const void* ptr, int heads, int s, int b,
              int rows) {
  using C = Cfg<HD>;
  const cuuint64_t dims[4] = {(cuuint64_t)HD, (cuuint64_t)heads, (cuuint64_t)s, (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)HD * 2, (cuuint64_t)heads * HD * 2,
                                 (cuuint64_t)s * heads * HD * 2};
  const cuuint32_t box[4] = {(cuuint32_t)C::kBox, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle = C::kRowBytes == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : C::kRowBytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                          : CU_TENSOR_MAP_SWIZZLE_32B;
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
                box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD, bool kCausal>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int b, int s, int h,
                   int kvh, cudaStream_t stream) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  CUtensorMap tq, tk, tv;
  if (!make_map<HD>(encode, &tq, q, h, s, b, kBM) ||
      !make_map<HD>(encode, &tk, k, kvh, s, b, kBN) ||
      !make_map<HD>(encode, &tv, v, kvh, s, b, kBN))
    return cudaErrorInvalidValue;
  const size_t smem = Cfg<HD>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel_wgmma<HD, kCausal>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  // the Pallas kernel's scale: 1/sqrt(hd) as a double, rounded to f32
  const float scale = (float)(1.0 / sqrt((double)HD));
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  const long long items = (long long)((s + kBM - 1) / kBM) * b * h;
  const int grid = (int)(items < sms ? items : sms);  // persistent blocks, one per SM
  flash_attention_kernel_wgmma<HD, kCausal><<<grid, kThreads, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(out), b, s, h, kvh, scale);
  return cudaGetLastError();
}

cudaError_t launch_hd(const void* q, const void* k, const void* v, void* out, int b, int s, int h,
                      int kvh, int hd, int causal, cudaStream_t st) {
  switch (hd) {
    case 16:
      return causal ? launch<16, true>(q, k, v, out, b, s, h, kvh, st)
                    : launch<16, false>(q, k, v, out, b, s, h, kvh, st);
    case 32:
      return causal ? launch<32, true>(q, k, v, out, b, s, h, kvh, st)
                    : launch<32, false>(q, k, v, out, b, s, h, kvh, st);
    case 64:
      return causal ? launch<64, true>(q, k, v, out, b, s, h, kvh, st)
                    : launch<64, false>(q, k, v, out, b, s, h, kvh, st);
    case 128:
      return causal ? launch<128, true>(q, k, v, out, b, s, h, kvh, st)
                    : launch<128, false>(q, k, v, out, b, s, h, kvh, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace tc

}  // namespace

// C interface, loaded with ctypes.  q/out: (B, S, H, hd); k/v: (B, S, KVH,
// hd); all bf16 (bf16 = 1: the tensor-core kernel) or all f32 (bf16 = 0:
// the FMA kernel), contiguous, 16-byte aligned; q unscaled; hd in {16, 32,
// 64, 128}; H a multiple of KVH.  Launches on `stream`, does not
// synchronise, and returns cudaGetLastError() (0 on success).
extern "C" int flash_attention(const void* q, const void* k, const void* v, void* out, int b,
                               int s, int h, int kvh, int hd, int bf16, int causal,
                               void* stream) {
  if (b < 1 || s < 1 || kvh < 1 || h < kvh || h % kvh != 0 || (long long)b * h > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(bf16 ? tc::launch_hd(q, k, v, out, b, s, h, kvh, hd, causal, st)
                    : launch_hd<float>(q, k, v, out, b, s, h, kvh, hd, causal, st));
}
