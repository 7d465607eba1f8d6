// Integer arithmetic of the reference I-BERT kernels, for the CUDA ports of
// repro/kernels/{int8_matmul,i_softmax,i_layernorm,i_gelu}.py.
//
// The reference is XLA's int32 and float32 arithmetic.  C++ differs from it
// in four places, and each has a helper here:
//   * int32 overflow wraps in XLA and is undefined in C++: wrapping add, sub,
//     mul and left shift go through uint32 (wadd, wsub, wmul, wshl);
//   * integer `//` floors in XLA and truncates in C++ (floordiv);
//   * a right shift by 32 or more fills with the sign in XLA and is
//     undefined in C++: the shift is clamped to 31 (sra);
//   * Python constants enter as float32 roundings of the double value, so
//     they are written here as exact hexadecimal float32 literals, and the
//     sources build with -fmad=false so that no multiply-add is contracted.
// log2(x) is log(x) / log(2) in float32, as jnp.log2 computes it.
#pragma once

#include <math.h>
#include <stdint.h>

namespace ibert {

constexpr float kLn2 = 0x1.62e43p-1f;        // float32(math.log(2.0))
constexpr float kExpA = 0x1.6ebf42p-2f;      // float32(0.35815147)
constexpr float kExpB = 0x1.5a5e36p+0f;      // float32(1.353)
constexpr float kExpC = 0x1.60418ap-2f;      // float32(0.344)
constexpr float kExpClamp = -30.0f;
constexpr float kErfA = -0x1.27bb3p-2f;      // float32(-0.2888)
constexpr float kErfBNeg = 0x1.c4dd3p+0f;    // float32(1.769) = -_ERF_B
constexpr float kErfC = 1.0f;
constexpr float kSqrt2 = 0x1.6a09e6p+0f;     // float32(math.sqrt(2.0))
constexpr float kI32Clip = 0x1.ffe27cp+30f;  // float32(2.147e9)
constexpr int kSoftmaxOutBits = 14;
constexpr int kLnNormShift = 11;
constexpr int kIsqrtIters = 20;

__device__ __forceinline__ int wadd(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}
__device__ __forceinline__ int wsub(int a, int b) {
  return (int)((unsigned)a - (unsigned)b);
}
__device__ __forceinline__ int wmul(int a, int b) {
  return (int)((unsigned)a * (unsigned)b);
}
__device__ __forceinline__ int wshl(int a, int s) {
  return (int)((unsigned)a << s);
}
// arithmetic right shift; a shift of 32 or more fills with the sign
__device__ __forceinline__ int sra(int a, int s) { return a >> (s < 31 ? s : 31); }

// floor division for b > 0 (every divisor here is at least 1)
__device__ __forceinline__ int floordiv(int a, int b) {
  const int q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

// saturating float -> int32, as the reference's _to_i32
__host__ __device__ __forceinline__ int to_i32(float x) {
  return (int)fminf(fmaxf(x, -kI32Clip), kI32Clip);
}

// ceil(log2(x)) as the reference computes it: ceil(log(x) / ln 2) in
// float32, from the correctly rounded float32 log the CPU gives.  logf may
// be an ulp off, and at x = 2^26 that put the quotient past 26 (i_gelu's
// shift one too large; tests/test_torch_cuda.py seeds x at and beside every
// power of two); the float32 of a double log is the correctly rounded one.
__device__ __forceinline__ float ceil_log2(float x) {
  return ceilf((float)log((double)x) / kLn2);
}

// warp-wide reductions (all 32 lanes take part)
__device__ __forceinline__ unsigned warp_sum(unsigned v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ int warp_max(int v) {
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

}  // namespace ibert
