// Row normalisation (RMSNorm and LayerNorm) for NVIDIA Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package computes both norms in plain jnp
// (repro/models/layers.py rmsnorm and layernorm; no Pallas kernel stands
// behind them).  Per row of x (rows, d), in f32:
//   rmsnorm:   y = (x * r) * g,            r = 1 / sqrt(mean(x * x) + eps)
//   layernorm: y = ((x - mu) * r) * g + b, r = 1 / sqrt(var + eps),
//              mu = mean(x), var = mean((x - mu)^2)   (two passes, as jnp.var)
// x and y are bf16 or f32 (y in x's dtype, rounded to nearest even); g and b
// are f32 (d,).  kernels/ref.py rmsnorm and layernorm are the function.
//
// Why a kernel: a row must give the same bits whatever tensor it sits in.
// Greedy speculation is lossless only if the verify pass (B*T rows) gives
// each row what a decode step (B rows) gives it, and PyTorch's CUDA
// reduction sums a row of 576 in another order at 40 rows than at 8.  Here
// every f32 sum has an order fixed by (d, dtype) alone, through one
// geometry (ops.row_norm_geometry, passed in by the wrapper):
//  * a row is cut into 16-byte vectors (8 bf16 or 4 f32 values); thread t
//    of the row's `tpr` threads (a power of two) holds vectors t, t + tpr,
//    t + 2 tpr, ... (`slots` of them);
//  * a vector's values are added as a pairwise tree, (v0 + v1) + (v2 + v3)
//    and so on; a thread adds its vectors' trees in slot order to an
//    accumulator that starts at +0;
//  * the thread sums are added by a __shfl_xor_sync butterfly over the
//    row's lanes of a warp (float addition commutes, so every lane ends
//    with the same bits); a row of more than a warp then adds its warps'
//    sums in warp order through shared memory;
//  * nothing depends on the row count, the grid, the row's place or the
//    pointers' alignment: an unaligned row takes scalar loads in the same
//    element-to-thread map; no atomics, no split of a row over blocks;
//  * built with -fmad=false, so every product is rounded before its sum
//    and the output keeps the plain version's order: (x * r) * g, then + b.
// 1 / sqrtf (IEEE division and square root: no fast-math flags) takes the
// place of torch.rsqrt, and the mean divides by d, as the CPU's mean does.
// kernels/ref.py row_norm_schedule repeats this order in torch: the card
// tests and chip_smoke.py hold the kernel equal to it bit for bit.
//
// What bounds it: at a decode step (8 rows of 576-7168) the latency of one
// round trip to device memory and the launch, since the bytes (23 KB at
// smollm-135m's 576) take nanoseconds at 3.35 TB/s; at a long prompt (4096
// rows of 1536, 25 MB) the bytes.  The design answers both:
//  * the row is read once, by 16-byte loads all in flight before the
//    first sum, and kept in registers (kSlots vectors a thread) for the
//    output;
//    the output is written by 16-byte stores;
//  * g (and b) are staged into shared memory by cp.async, started with
//    the row's loads, so their latency overlaps the reductions, and a
//    block's rows share one copy;
//  * enough threads a row that each holds at most kSlots vectors, and a
//    thread a vector where the row fits a warp: a part of a warp a row and
//    several rows a block at the narrow widths, up to a block of 512
//    threads a row at the widest.
// A row wider than kMaxBlock threads x kSlots vectors (past 16,384 bf16 or
// 8,192 f32 values) is walked in chunks of kSlots slots over the same map:
// read again for each pass, with g and b read from device memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSlots = 4;        // 16-byte vectors a thread holds in registers
constexpr int kMaxBlock = 512;   // threads a block, and a row, at most
constexpr int kBigSmem = 48 * 1024;  // dynamic shared memory past this needs the attribute

template <typename T>
struct Vec;  // values in a 16-byte vector
template <>
struct Vec<float> {
  static constexpr int n = 4;
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int n = 8;
};

__device__ __forceinline__ unsigned word(const uint4& r, int i) {
  return i == 0 ? r.x : i == 1 ? r.y : i == 2 ? r.z : r.w;
}

// value e of a vector held as its 16 bytes (exact for bf16)
template <typename T>
__device__ __forceinline__ float value(const uint4& r, int e) {
  if constexpr (sizeof(T) == 4) {
    return __uint_as_float(word(r, e));
  } else {
    const unsigned w = word(r, e >> 1);
    return __uint_as_float((e & 1) ? (w & 0xffff0000u) : (w << 16));
  }
}

// vector v of a row: one 16-byte load, or (unaligned) a load a value in the
// same map, zeros past d
template <typename T, bool kAligned>
__device__ __forceinline__ uint4 load_vec(const T* __restrict__ row, int v, int d) {
  if constexpr (kAligned) {
    return __ldg(reinterpret_cast<const uint4*>(row) + v);
  } else {
    constexpr int V = Vec<T>::n;
    unsigned w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const int c = v * V + e;
      if (c >= d) continue;
      if constexpr (sizeof(T) == 4) {
        w[e] = __ldg(reinterpret_cast<const unsigned*>(row) + c);
      } else {
        const unsigned h = __ldg(reinterpret_cast<const unsigned short*>(row) + c);
        w[e >> 1] |= h << (16 * (e & 1));
      }
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
}

__device__ __forceinline__ unsigned bf16_bits(float f) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(f));
}

// vector v of an output row from its V f32 values (bf16: rounded to nearest
// even)
template <typename T, bool kAligned>
__device__ __forceinline__ void store_vec(T* __restrict__ row, int v, int d,
                                          const float (&o)[Vec<T>::n]) {
  constexpr int V = Vec<T>::n;
  unsigned w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (sizeof(T) == 4)
      w[i] = __float_as_uint(o[i]);
    else
      w[i] = bf16_bits(o[2 * i]) | (bf16_bits(o[2 * i + 1]) << 16);
  }
  if constexpr (kAligned) {
    reinterpret_cast<uint4*>(row)[v] = make_uint4(w[0], w[1], w[2], w[3]);
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const int c = v * V + e;
      if (c >= d) continue;
      if constexpr (sizeof(T) == 4)
        reinterpret_cast<unsigned*>(row)[c] = w[e];
      else
        reinterpret_cast<unsigned short*>(row)[c] =
            static_cast<unsigned short>(w[e >> 1] >> (16 * (e & 1)));
    }
  }
}

// the pairwise tree over a vector's values: level by level, f[i] = f[2i] +
// f[2i + 1]
template <int V>
__device__ __forceinline__ float tree(float (&f)[V]) {
#pragma unroll
  for (int w = V / 2; w >= 1; w >>= 1) {
#pragma unroll
    for (int i = 0; i < w; ++i) f[i] = f[2 * i] + f[2 * i + 1];
  }
  return f[0];
}

// The row's total of its threads' sums: a butterfly over the row's lanes
// of a warp, then (tpr > 32) the warps' sums in warp order.  Every thread
// of the block calls it (it may hold a barrier).
__device__ __forceinline__ float row_total(float s, int tpr, float* part) {
  const int width = tpr < 32 ? tpr : 32;
  for (int o = width >> 1; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if (tpr <= 32) return s;
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = s;
  __syncthreads();
  const int first = (threadIdx.x / tpr) * (tpr >> 5);
  float t = part[first];
  for (int k = 1; k < (tpr >> 5); ++k) t += part[first + k];
  return t;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// One block: blockDim.x / tpr rows, tpr threads each.  kAligned: every row
// and g, b start on 16 bytes and d fills whole vectors.
template <typename T, bool kLayer, bool kAligned>
__global__ void __launch_bounds__(kMaxBlock)
row_norm_kernel(const T* __restrict__ x, const float* __restrict__ g,
                const float* __restrict__ b, T* __restrict__ y, int rows,
                int d, float eps, int tpr, int slots) {
  constexpr int V = Vec<T>::n;
  extern __shared__ __align__(16) float staged[];  // g, then b (one chunk)
  __shared__ float part[2][kMaxBlock / 32];
  const int t = threadIdx.x & (tpr - 1);
  const int row = blockIdx.x * (blockDim.x / tpr) + threadIdx.x / tpr;
  const bool live = row < rows;  // a dead thread still joins the reductions
  const int nvec = (d + V - 1) / V;
  const int chunks = (slots + kSlots - 1) / kSlots;
  const T* xr = x + (size_t)(live ? row : 0) * d;

  uint4 r[kSlots];
  auto load = [&](int k) {
#pragma unroll
    for (int i = 0; i < kSlots; ++i) {
      const int v = (k * kSlots + i) * tpr + t;
      r[i] = live && v < nvec ? load_vec<T, kAligned>(xr, v, d) : make_uint4(0u, 0u, 0u, 0u);
    }
  };
  load(0);
  const float* gp = g;
  const float* bp = b;
  if (chunks == 1) {  // g and b into shared memory, in flight with x
    const int dp = (d + 3) & ~3;
    if constexpr (kAligned) {
      for (int c = threadIdx.x; c < d / 4; c += blockDim.x) {
        cp_async16(staged + 4 * c, g + 4 * c);
        if constexpr (kLayer) cp_async16(staged + dp + 4 * c, b + 4 * c);
      }
    } else {
      for (int c = threadIdx.x; c < d; c += blockDim.x) {
        cp_async4(staged + c, g + c);
        if constexpr (kLayer) cp_async4(staged + dp + c, b + c);
      }
    }
    gp = staged;
    bp = staged + dp;
  }

  // the first sum: x (layernorm's mean) or x * x (rmsnorm)
  float acc = 0.0f;
  for (int k = 0; k < chunks; ++k) {
    if (k) load(k);
#pragma unroll
    for (int i = 0; i < kSlots; ++i) {
      float f[V];
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float v = value<T>(r[i], e);
        f[e] = kLayer ? v : v * v;
      }
      acc += tree<V>(f);
    }
  }
  const float fd = (float)d;
  const float s = row_total(acc, tpr, part[0]);
  float mu = 0.0f, rs;
  if constexpr (kLayer) {
    mu = s / fd;
    acc = 0.0f;  // the variance from the values held (or read again)
    for (int k = 0; k < chunks; ++k) {
      if (chunks > 1) load(k);
#pragma unroll
      for (int i = 0; i < kSlots; ++i) {
        const int v = (k * kSlots + i) * tpr + t;
        float f[V];
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const float c = value<T>(r[i], e) - mu;
          f[e] = v * V + e < d ? c * c : 0.0f;
        }
        acc += tree<V>(f);
      }
    }
    rs = 1.0f / sqrtf(row_total(acc, tpr, part[1]) / fd + eps);
  } else {
    rs = 1.0f / sqrtf(s / fd + eps);
  }

  if (chunks == 1) {
    cp_async_wait_all();
    __syncthreads();
  }
  if (!live) return;
  T* yr = y + (size_t)row * d;
  for (int k = 0; k < chunks; ++k) {
    if (chunks > 1) load(k);
#pragma unroll
    for (int i = 0; i < kSlots; ++i) {
      const int v = (k * kSlots + i) * tpr + t;
      if (v >= nvec) continue;
      float gv[V], bv[V];
      if constexpr (kAligned) {
#pragma unroll
        for (int q = 0; q < V / 4; ++q) {
          const float4 g4 = reinterpret_cast<const float4*>(gp + v * V)[q];
          gv[4 * q] = g4.x, gv[4 * q + 1] = g4.y, gv[4 * q + 2] = g4.z, gv[4 * q + 3] = g4.w;
          if constexpr (kLayer) {
            const float4 b4 = reinterpret_cast<const float4*>(bp + v * V)[q];
            bv[4 * q] = b4.x, bv[4 * q + 1] = b4.y, bv[4 * q + 2] = b4.z, bv[4 * q + 3] = b4.w;
          }
        }
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const int c = v * V + e;
          gv[e] = c < d ? gp[c] : 0.0f;
          if constexpr (kLayer) bv[e] = c < d ? bp[c] : 0.0f;
        }
      }
      float o[V];
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float xv = value<T>(r[i], e);
        if constexpr (kLayer)
          o[e] = ((xv - mu) * rs) * gv[e] + bv[e];
        else
          o[e] = (xv * rs) * gv[e];
      }
      store_vec<T, kAligned>(yr, v, d, o);
    }
  }
}

template <typename T, bool kLayer, bool kAligned>
cudaError_t launch(const void* x, const float* g, const float* b, void* y, int rows, int d,
                   float eps, int tpr, int slots, int block_rows, cudaStream_t stream) {
  auto kernel = row_norm_kernel<T, kLayer, kAligned>;
  const int chunks = (slots + kSlots - 1) / kSlots;
  const size_t smem = chunks == 1 ? sizeof(float) * (kLayer ? 2 : 1) * ((d + 3) & ~3) : 0;
  if (smem > (size_t)kBigSmem) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int blocks = (rows + block_rows - 1) / block_rows;
  kernel<<<blocks, block_rows * tpr, smem, stream>>>(static_cast<const T*>(x), g, b,
                                                     static_cast<T*>(y), rows, d, eps, tpr,
                                                     slots);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_form(const void* x, const float* g, const float* b, void* y, int rows,
                        int d, float eps, int tpr, int slots, int block_rows,
                        cudaStream_t st) {
  const uintptr_t bits = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y) |
                         reinterpret_cast<uintptr_t>(g) | reinterpret_cast<uintptr_t>(b);
  const bool aligned = ((size_t)d * sizeof(T)) % 16 == 0 && bits % 16 == 0;
  if (b != nullptr)
    return aligned ? launch<T, true, true>(x, g, b, y, rows, d, eps, tpr, slots, block_rows, st)
                   : launch<T, true, false>(x, g, b, y, rows, d, eps, tpr, slots, block_rows, st);
  return aligned ? launch<T, false, true>(x, g, b, y, rows, d, eps, tpr, slots, block_rows, st)
                 : launch<T, false, false>(x, g, b, y, rows, d, eps, tpr, slots, block_rows, st);
}

}  // namespace

// x, y: (rows, d) contiguous, bf16 (bf16 != 0) or f32; g and b: (d,) f32
// contiguous, b null for rmsnorm.  rows >= 1, d >= 1.  threads (a row),
// slots (vectors a thread) and block_rows (rows a block) are
// ops.row_norm_geometry(d, dtype); a geometry that does not cover d
// exactly so is refused.  Returns the CUDA error of the launch (0 = none).
extern "C" int row_norm(const void* x, const void* g, const void* b, void* y, int rows, int d,
                        float eps, int bf16, int threads, int slots, int block_rows,
                        void* stream) {
  const int vec = bf16 ? Vec<__nv_bfloat16>::n : Vec<float>::n;
  const int nvec = d >= 1 ? (d + vec - 1) / vec : 0;
  const int block = threads * block_rows;
  if (rows < 1 || d < 1 || threads < 1 || (threads & (threads - 1)) != 0 || block_rows < 1 ||
      block > kMaxBlock || block % 32 != 0 || slots != (nvec + threads - 1) / threads)
    return (int)cudaErrorInvalidValue;
  const auto* gf = static_cast<const float*>(g);
  const auto* bf = static_cast<const float*>(b);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(bf16 ? launch_form<__nv_bfloat16>(x, gf, bf, y, rows, d, eps, threads, slots,
                                                 block_rows, st)
                    : launch_form<float>(x, gf, bf, y, rows, d, eps, threads, slots,
                                         block_rows, st));
}
