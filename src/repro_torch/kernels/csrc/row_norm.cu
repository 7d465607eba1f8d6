// Row normalisation (RMSNorm and LayerNorm) for NVIDIA Hopper (sm_90a).
//
// A port-only kernel: the JAX package computes both norms in plain jnp
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
// the order of every f32 sum is a function of d alone:
//  * one warp per row: no split of a row over blocks, no atomics, nothing
//    chosen by the row count or the grid;
//  * lane l takes columns l, l + 32, l + 64, ... in that order, its i-th
//    value into accumulator i % kAcc, the kAcc accumulators then added as
//    a fixed tree, and the 32 lane sums by a fixed __shfl_xor_sync
//    butterfly (float addition commutes, so every lane ends with the same
//    bits);
//  * built with -fmad=false, so every product is rounded before its sum
//    and the output keeps the plain version's order: (x * r) * g, then + b.
// 1 / sqrtf (IEEE division and square root: no fast-math flags) takes the
// place of torch.rsqrt, and the mean divides by d, as the CPU's mean does.
//
// What bounds it: bytes.  It reads x and writes y once (plus g and b): at
// smollm-135m's decode step, 8 rows of 576 bf16, that is 23 KB, 7 ns at
// 3.35 TB/s, so a launch's latency is what it costs on the serving path.
// The design stays simple: each pass re-reads the row (from L1 or L2 after
// the first), two passes for rmsnorm and three for layernorm, each loop
// unrolled so that a lane has several loads in flight (the sums keep
// their order), and a block holds kRowsPerBlock rows.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowsPerBlock = 4;  // warps (rows) a block
constexpr int kAcc = 4;           // f32 accumulators a lane

__device__ __forceinline__ float load(const float* p, int c) {
  return __ldg(p + c);
}
__device__ __forceinline__ float load(const __nv_bfloat16* p, int c) {
  const unsigned short u =
      __ldg(reinterpret_cast<const unsigned short*>(p) + c);
  return __uint_as_float(static_cast<unsigned>(u) << 16);  // exact
}
__device__ __forceinline__ void store(float* p, int c, float v) { p[c] = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, int c, float v) {
  p[c] = __float2bfloat16_rn(v);
}

// The row's sum of f(x_c) over c < d in the fixed order above; every lane
// returns the same bits.
template <typename T, typename F>
__device__ __forceinline__ float row_sum(const T* __restrict__ xr, int d,
                                         int lane, F f) {
  float acc[kAcc];
#pragma unroll
  for (int j = 0; j < kAcc; ++j) acc[j] = 0.0f;
#pragma unroll 4
  for (int c0 = lane; c0 < d; c0 += 32 * kAcc) {
#pragma unroll
    for (int j = 0; j < kAcc; ++j) {
      const int c = c0 + 32 * j;  // lane's value 4 * iteration + j
      if (c < d) acc[j] += f(load(xr, c));
    }
  }
  float s = (acc[0] + acc[1]) + (acc[2] + acc[3]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

template <typename T, bool kLayer>
__global__ void __launch_bounds__(32 * kRowsPerBlock)
row_norm_kernel(const T* __restrict__ x, const float* __restrict__ g,
                const float* __restrict__ b, T* __restrict__ y, int rows,
                int d, float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;  // the whole warp: its shuffles stay full
  const T* xr = x + (size_t)row * d;
  T* yr = y + (size_t)row * d;
  const float fd = (float)d;
  if constexpr (kLayer) {
    const float mu = row_sum(xr, d, lane, [](float v) { return v; }) / fd;
    const float var =
        row_sum(xr, d, lane, [mu](float v) { return (v - mu) * (v - mu); }) /
        fd;
    const float r = 1.0f / sqrtf(var + eps);
#pragma unroll 4
    for (int c = lane; c < d; c += 32)
      store(yr, c, ((load(xr, c) - mu) * r) * __ldg(g + c) + __ldg(b + c));
  } else {
    const float ms = row_sum(xr, d, lane, [](float v) { return v * v; }) / fd;
    const float r = 1.0f / sqrtf(ms + eps);
#pragma unroll 4
    for (int c = lane; c < d; c += 32)
      store(yr, c, (load(xr, c) * r) * __ldg(g + c));
  }
}

template <typename T>
cudaError_t launch(const void* x, const float* g, const float* b, void* y,
                   int rows, int d, float eps, cudaStream_t stream) {
  const int blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  if (b != nullptr)
    row_norm_kernel<T, true><<<blocks, 32 * kRowsPerBlock, 0, stream>>>(
        xt, g, b, yt, rows, d, eps);
  else
    row_norm_kernel<T, false><<<blocks, 32 * kRowsPerBlock, 0, stream>>>(
        xt, g, nullptr, yt, rows, d, eps);
  return cudaGetLastError();
}

}  // namespace

// x, y: (rows, d) contiguous, bf16 (bf16 != 0) or f32; g and b: (d,) f32
// contiguous, b null for rmsnorm.  rows >= 1, d >= 1.  Returns the CUDA
// error of the launch (0 = none).
extern "C" int row_norm(const void* x, const void* g, const void* b, void* y,
                        int rows, int d, float eps, int bf16, void* stream) {
  const auto* gf = static_cast<const float*>(g);
  const auto* bf = static_cast<const float*>(b);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(bf16 ? launch<__nv_bfloat16>(x, gf, bf, y, rows, d, eps, st)
                    : launch<float>(x, gf, bf, y, rows, d, eps, st));
}
