// I-BERT integer LayerNorm for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/i_layernorm.py i_layernorm
// (body _kernel; paper Fig. 10 layers 4 and 6).  Per row q of H int32
// values (int8-range, or the sum of two such residuals):
//   mean = sum(q) // H                       (floor, int32 wrapping)
//   qc = q - mean;  var = sum(qc*qc) // H
//   std = max(i_sqrt(var << 14), 1)          (~ std * 2^7)
//   out = ((qc << 18) // std) * q_gamma + q_beta
// i_sqrt is I-BERT Alg. 4: a Newton integer square root from
// x0 = int(exp2(ceil(ceil(log2(n + 1)) / 2))), 20 steps with an early stop
// once a step does not decrease x.  x0 comes from a table that holds
// exp2 as the reference computes it in float32 (exp2(15) -> 32767).
// Bit-exact against kernels/ref.py i_layernorm_rows.
//
// What bounds it: bytes.  It reads the row and writes the result once
// (plus gamma and beta): at (B*S, 768) = (128, 768) that is 0.79 MB,
// 0.24 us at 3.35 TB/s.  The 20 Newton steps run once per row.
//
// Design (simple first): one block of 256 threads per row.  The mean and
// the variance are block reductions (warp shuffles, then one warp over the
// per-warp sums) in uint32, which wraps as XLA's int32 sums do; thread 0
// runs i_sqrt and shares the result through shared memory; the row is read
// again from L1/L2 for each pass rather than held in registers, so any H
// works.
#include <cuda_runtime.h>
#include <stdint.h>

#include "ibert_int.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__constant__ int kIsqrtX0[17] = {1,    2,    4,    8,     16,    32,
                                 64,   128,  256,  512,   1024,  2048,
                                 4096, 8192, 16384, 32767, 65536};

__device__ int i_sqrt(int n) {
  using namespace ibert;
  const float bits = ceil_log2((float)max(n, 1) + 1.0f);
  const int k = (int)ceilf(bits / 2.0f);
  int x = max(kIsqrtX0[k], 1);
  bool done = false;
  for (int it = 0; it < kIsqrtIters; ++it) {
    const int nx = sra(wadd(x, floordiv(n, max(x, 1))), 1);
    done = done || nx >= x;
    x = done ? x : nx;
  }
  return n == 0 ? 0 : x;
}

// sum over the block; every thread gets the total
__device__ unsigned block_sum(unsigned v, unsigned* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = ibert::warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = lane < kWarps ? red[lane] : 0u;
  v = ibert::warp_sum(v);
  __syncthreads();  // red may be written again by the next call
  return v;
}

__global__ void __launch_bounds__(kThreads)
i_layernorm_kernel(const int* __restrict__ q, const int* __restrict__ gamma,
                   const int* __restrict__ beta, int* __restrict__ out, int h) {
  using namespace ibert;
  __shared__ unsigned red[kWarps];
  __shared__ int std_s;
  const int* x = q + (size_t)blockIdx.x * h;
  int* y = out + (size_t)blockIdx.x * h;

  unsigned s = 0;
  for (int i = threadIdx.x; i < h; i += kThreads) s += (unsigned)x[i];
  const int mean = floordiv((int)block_sum(s, red), h);

  unsigned s2 = 0;
  for (int i = threadIdx.x; i < h; i += kThreads) {
    const int qc = wsub(x[i], mean);
    s2 += (unsigned)wmul(qc, qc);
  }
  const int var = floordiv((int)block_sum(s2, red), h);
  if (threadIdx.x == 0) std_s = max(i_sqrt(wshl(var, 14)), 1);
  __syncthreads();
  const int sd = std_s;

  for (int i = threadIdx.x; i < h; i += kThreads) {
    const int qc = wsub(x[i], mean);
    const int norm = floordiv(wmul(qc, 1 << (kLnNormShift + 7)), sd);
    y[i] = wadd(wmul(norm, gamma[i]), beta[i]);
  }
}

}  // namespace

// q, out: (rows, h) int32; gamma, beta: (h,) int32; all contiguous.
// Returns the CUDA error of the launch (0 = none).
extern "C" int i_layernorm(const void* q, const void* gamma, const void* beta,
                           void* out, int rows, int h, void* stream) {
  i_layernorm_kernel<<<rows, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(q), static_cast<const int*>(gamma),
      static_cast<const int*>(beta), static_cast<int*>(out), h);
  return (int)cudaGetLastError();
}
