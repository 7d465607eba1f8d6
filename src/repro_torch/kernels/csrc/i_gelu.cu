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
// Design: a stream of 16-byte vectors, one tile of kThreads * 4 kV
// elements a block (kV = 2 vectors a thread: 8 elements a thread, 192
// blocks at (128, 3072) on the 132 SMs; 16 elements a thread timed equal
// with a cold L2 and 4% slower warm, PERF.md), thread t taking
// vectors t, t + kThreads, ... of its block's tile, so a warp's loads are
// 512 contiguous bytes.
//  * The loads come first: each thread issues all its kV 16-byte loads
//    (ld.global.cs, read once) before it computes the scale's constants
//    (two float32 divisions, a logf, floors), so that arithmetic runs
//    while the loads are in flight, and the stores are streaming too
//    (st.global.cs).
//  * The constants stay on the device, per thread, as the reference's
//    float32 arithmetic (a host-side logf need not round as CUDA's does).
//  * Layouts: the vector path (kVec) takes q and out 16-byte aligned; a
//    ragged end (n not a multiple of 4) is its last vector, read and
//    written element by element.  A q not 16-byte aligned (a view into
//    another tensor) takes the same kernel's scalar path (thread t takes
//    elements t, t + kThreads, ... of the tile): out comes from the
//    allocator aligned, so no scalar head could align both.
#include <cuda_runtime.h>
#include <stdint.h>

#include "ibert_int.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kV = 2;  // 16-byte vectors a thread

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
i_gelu_kernel(const int* __restrict__ q, int* __restrict__ out, long long n,
              float scale) {
  using namespace ibert;
  constexpr int kElems = 4 * kV;
  const long long base = (long long)blockIdx.x * kThreads * kElems;
  // element k of this thread's slot i
  auto at = [&](int i, int k) -> long long {
    return kVec ? base + 4LL * (i * kThreads + threadIdx.x) + k
                : base + (long long)(4 * i + k) * kThreads + threadIdx.x;
  };

  int x[kElems];
#pragma unroll
  for (int i = 0; i < kV; ++i) {
    if (kVec && at(i, 3) < n) {
      const int4 v = __ldcs(reinterpret_cast<const int4*>(q + at(i, 0)));
      x[4 * i] = v.x;
      x[4 * i + 1] = v.y;
      x[4 * i + 2] = v.z;
      x[4 * i + 3] = v.w;
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        x[4 * i + k] = at(i, k) < n ? __ldcs(q + at(i, k)) : 0;
    }
  }

  const float s_e = scale / kSqrt2;
  const int q_b = to_i32(floorf(kErfBNeg / s_e));
  const float s_erf = kErfA * s_e * s_e;
  const int q_c = to_i32(floorf(kErfC / s_erf));
  const int q_one = to_i32(floorf(1.0f / s_erf));
  const float tmax = 2.0f / fabsf(s_erf);
  const int g = (int)fmaxf(ceil_log2(tmax + 1.0f) - 19.0f, 0.0f);

  int y[kElems];
#pragma unroll
  for (int e = 0; e < kElems; ++e) {
    const int xe = x[e];
    const int sgn = (xe > 0) - (xe < 0);
    const int ax = xe < 0 ? wsub(0, xe) : xe;
    const int t0 = wsub(min(ax, q_b), q_b);
    const int q_erf = wmul(sgn, wadd(wmul(t0, t0), q_c));
    y[e] = wmul(xe, sra(wadd(q_erf, q_one), g));
  }

#pragma unroll
  for (int i = 0; i < kV; ++i) {
    if (kVec && at(i, 3) < n) {
      __stcs(reinterpret_cast<int4*>(out + at(i, 0)),
             make_int4(y[4 * i], y[4 * i + 1], y[4 * i + 2], y[4 * i + 3]));
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (at(i, k) < n) __stcs(out + at(i, k), y[4 * i + k]);
    }
  }
}

}  // namespace

// q, out: n int32, contiguous.  Returns the CUDA error of the launch
// (0 = none).
extern "C" int i_gelu(const void* q, void* out, long long n, float scale,
                      void* stream) {
  const auto* qi = static_cast<const int*>(q);
  auto* oi = static_cast<int*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long tile = (long long)kThreads * 4 * kV;
  const unsigned blocks = (unsigned)((n + tile - 1) / tile);
  const bool vec = ((reinterpret_cast<uintptr_t>(q) |
                     reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  if (vec)
    i_gelu_kernel<true><<<blocks, kThreads, 0, st>>>(qi, oi, n, scale);
  else
    i_gelu_kernel<false><<<blocks, kThreads, 0, st>>>(qi, oi, n, scale);
  return (int)cudaGetLastError();
}
