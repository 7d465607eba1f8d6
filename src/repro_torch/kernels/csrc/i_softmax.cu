// I-BERT integer softmax for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/i_softmax.py i_softmax (body
// _kernel; paper Fig. 10 layer 2).  Per row of int32 scores q at a float32
// scale S:
//   qn = max(q - max(q), floor(-30 / S))
//   i-exp: z = qn // q_ln2 (floor), p = qn + z*q_ln2, e = ((p+q_b)^2 + q_c) >> z
//   q_sum = max(sum(e), 1)                    (int32, wrapping)
//   sh = max(ceil(log2(q_sum + 1)) - 16, 0)  (float32, log(x) / log(2))
//   out = ((e >> sh) * (2^29 // max(q_sum >> sh, 1))) >> 15
// with q_ln2, q_b, q_c the float32 constants of the scale, computed in the
// kernel exactly as the reference computes them.  Output: int32
// probabilities at 2^-14.  Bit-exact against kernels/ref.py i_softmax_rows.
//
// What bounds it: bytes.  It reads and writes each int32 once: at the
// encoder's (B*12*S, S) = (1536, 128) that is 1.57 MB, 0.47 us at 3.35 TB/s;
// its ~15 integer operations per element are far below the card's rate.
//
// Design (simple first): one warp per row, four rows per block.  The row is
// read three times (max, sum, output), each pass with consecutive lanes on
// consecutive elements; the second and third reads come from L1/L2, and
// i-exp is recomputed in the last pass instead of being kept, so any row
// length works without shared memory.  Reductions are warp shuffles; the
// sum is taken in uint32, which wraps as XLA's int32 sum does.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "ibert_int.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;

struct ExpConsts {
  int q_clamp, q_ln2, q_b, q_c;
};

__device__ __forceinline__ ExpConsts exp_consts(float scale) {
  using namespace ibert;
  ExpConsts c;
  c.q_clamp = (int)floorf(kExpClamp / scale);
  c.q_ln2 = max(to_i32(floorf(kLn2 / scale)), 1);
  c.q_b = to_i32(floorf(kExpB / scale));
  c.q_c = to_i32(floorf(kExpC / (kExpA * scale * scale)));
  return c;
}

// i-exp of qn = q - q_max (<= 0), I-BERT Alg. 2
__device__ __forceinline__ int i_exp(int qn, const ExpConsts& c) {
  using namespace ibert;
  qn = max(qn, c.q_clamp);
  const int z = floordiv(wsub(0, qn), c.q_ln2);
  const int p = wadd(qn, wmul(z, c.q_ln2));
  const int t = wadd(p, c.q_b);
  return sra(wadd(wmul(t, t), c.q_c), z);
}

__global__ void __launch_bounds__(kThreads)
i_softmax_kernel(const int* __restrict__ q, int* __restrict__ out, int rows,
                 int cols, float scale) {
  using namespace ibert;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;  // whole warps leave together
  const int* x = q + (size_t)row * cols;
  int* y = out + (size_t)row * cols;
  const ExpConsts c = exp_consts(scale);

  int mx = INT_MIN;
  for (int i = lane; i < cols; i += 32) mx = max(mx, x[i]);
  mx = warp_max(mx);

  unsigned sum = 0;
  for (int i = lane; i < cols; i += 32) sum += (unsigned)i_exp(wsub(x[i], mx), c);
  const int q_sum = max((int)warp_sum(sum), 1);

  const int sh = (int)fmaxf(ceil_log2((float)q_sum + 1.0f) - 16.0f, 0.0f);
  const int factor = floordiv(1 << 29, max(sra(q_sum, sh), 1));
  for (int i = lane; i < cols; i += 32) {
    const int e = i_exp(wsub(x[i], mx), c);
    y[i] = sra(wmul(sra(e, sh), factor), 29 - kSoftmaxOutBits);
  }
}

}  // namespace

// q, out: (rows, cols) int32, contiguous.  Returns the CUDA error of the
// launch (0 = none).
extern "C" int i_softmax(const void* q, void* out, int rows, int cols,
                         float scale, void* stream) {
  const int blocks = (rows + kWarps - 1) / kWarps;
  i_softmax_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(q), static_cast<int*>(out), rows, cols, scale);
  return (int)cudaGetLastError();
}
