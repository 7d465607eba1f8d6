// I-BERT integer GELU for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/i_gelu.py i_gelu (body
// _kernel; paper Fig. 10 layer 5).  Elementwise over int32 q at a float32
// scale S, with the constants of the scale computed as the reference does:
//   s_e = S / sqrt(2);  q_b = floor(1.769 / s_e);  s_erf = -0.2888 * s_e * s_e
//   q_c = q_one = floor(1 / s_erf)              (the erf polynomial's c is 1)
//   g = max(ceil(log2(2 / |s_erf| + 1)) - 19, 0)
//   i-erf: q_erf = sign(q) * ((min(|q|, q_b) - q_b)^2 + q_c)
//   out = q * ((q_erf + q_one) >> g)
// in int32 with two's-complement wrap.  Bit-exact against kernels/ref.py
// i_gelu_elem.
//
// What bounds it: bytes.  It reads and writes each int32 once: at the
// encoder's (B*S, d_ff) = (128, 3072) that is 3.1 MB, 0.94 us at 3.35 TB/s;
// its ~12 integer operations per element are far below the card's rate.
//
// Design (simple first): a grid-stride loop, one element per thread per
// step, consecutive threads on consecutive elements; every thread computes
// the scale's constants once (a few float32 operations).  16-byte vector
// loads are left to later work.
#include <cuda_runtime.h>
#include <stdint.h>

#include "ibert_int.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
i_gelu_kernel(const int* __restrict__ q, int* __restrict__ out, long long n,
              float scale) {
  using namespace ibert;
  const float s_e = scale / kSqrt2;
  const int q_b = to_i32(floorf(kErfBNeg / s_e));
  const float s_erf = kErfA * s_e * s_e;
  const int q_c = to_i32(floorf(kErfC / s_erf));
  const int q_one = to_i32(floorf(1.0f / s_erf));
  const float tmax = 2.0f / fabsf(s_erf);
  const int g = (int)fmaxf(ceil_log2(tmax + 1.0f) - 19.0f, 0.0f);

  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += stride) {
    const int x = q[i];
    const int sgn = (x > 0) - (x < 0);
    const int ax = x < 0 ? wsub(0, x) : x;
    const int t0 = wsub(min(ax, q_b), q_b);
    const int q_erf = wmul(sgn, wadd(wmul(t0, t0), q_c));
    out[i] = wmul(x, sra(wadd(q_erf, q_one), g));
  }
}

}  // namespace

// q, out: n int32, contiguous.  Returns the CUDA error of the launch
// (0 = none).
extern "C" int i_gelu(const void* q, void* out, long long n, float scale,
                      void* stream) {
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 132 * 16) blocks = 132 * 16;  // 16 blocks per SM, then stride
  i_gelu_kernel<<<(unsigned)blocks, kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(q), static_cast<int*>(out), n, scale);
  return (int)cudaGetLastError();
}
