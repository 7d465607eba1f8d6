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
// 0.24 us at 3.35 TB/s.  What holds it back is latency: a row is a short
// chain (load, two sums, a square root, a division per element), so the
// design keeps that chain short rather than the bytes few.
//
// Design: one warp per row, no shared memory and no block barrier: a warp
// never waits on another.  A warp, because its 32 lanes hold a 768-wide
// row in registers at 6 vectors a lane and its sums need only shuffles.
// A block holds kRowsPerBlock = 2 warps (the encoder's 128 rows on 64
// SMs): at (128, 768), with the rows warm in L2 as the encoder leaves
// them, 2 timed ~1% faster than 1 and ~4% faster than 4; with a cold L2
// all three tie (PERF.md).
//  * Every load is issued before any arithmetic.  At H = 768 a lane holds
//    6 16-byte vectors of its row (lane l has columns 4(32j + l) .. +3)
//    and the same slices of gamma and beta: one memory latency a row, and
//    the row stays in registers for the sums and the output.
//  * One pass gives both sums, S = sum(q) and S2 = sum(q*q), reduced
//    together by warp shuffles in uint32.  The reference's int32 sums wrap,
//    i.e. they are sums in the ring of integers mod 2^32; addition there is
//    associative and commutative, so any summation order gives the same
//    bits, and sum((q - m)^2) = S2 - 2 m S + H m^2 holds there exactly.
//    So var needs no second pass and no second reduction.
//  * Every lane runs i_sqrt itself on the same var (no broadcast, no
//    barrier), and leaves the Newton loop at the first step that does not
//    decrease x: the reference runs 20 steps with x frozen from there on,
//    which is the same value.  For n < 0 (var << 14 wraps once var >=
//    2^17) the steps go on decreasing x, up to all 20, unless x + n // x
//    wraps: the exit then comes where the reference's x freezes.
//  * The per-element floor division by std stays an integer division: the
//    32 lanes run theirs side by side.
// Row layouts: the vector path (kVec) takes H a multiple of 4 with every
// base 16-byte aligned; the same kernel's scalar path (lane l has columns
// 32i + l) takes any other H or alignment.  A lane holds kV = 6 vectors
// (24 values), a chunk of 768 columns: H <= 768 is held whole, a longer
// row (any H, e.g. 8192) is walked in chunks of 768, the first held in
// registers, the others read again from L1/L2 for the output.
#include <cuda_runtime.h>
#include <stdint.h>

#include "ibert_int.cuh"

namespace {

constexpr int kRowsPerBlock = 2;  // warps (rows) a block
constexpr int kV = 6;             // 16-byte vectors a lane a chunk
constexpr int kSlots = 4 * kV;    // values a lane a chunk
constexpr int kChunk = 32 * kSlots;  // columns a chunk

__constant__ int kIsqrtX0[17] = {1,    2,    4,    8,     16,    32,
                                 64,   128,  256,  512,   1024,  2048,
                                 4096, 8192, 16384, 32767, 65536};

__device__ __forceinline__ int i_sqrt(int n) {
  using namespace ibert;
  const float bits = ceil_log2((float)max(n, 1) + 1.0f);
  const int k = (int)ceilf(bits / 2.0f);
  int x = max(kIsqrtX0[k], 1);
  for (int it = 0; it < kIsqrtIters; ++it) {
    const int nx = sra(wadd(x, floordiv(n, max(x, 1))), 1);
    if (nx >= x) break;  // the reference keeps x from here on
    x = nx;
  }
  return n == 0 ? 0 : x;
}

// column of slot i of `lane` in the chunk that starts at c0
template <bool kVec>
__device__ __forceinline__ int column(int c0, int lane, int i) {
  return kVec ? c0 + 4 * (32 * (i / 4) + lane) + i % 4 : c0 + 32 * i + lane;
}

// one chunk of a row into registers, every load issued before any use;
// columns at or past h read as 0
template <bool kVec>
__device__ __forceinline__ void load(const int* __restrict__ p, int c0,
                                     int h, int lane, int (&x)[kSlots]) {
#pragma unroll
  for (int j = 0; j < kV; ++j) {
    if constexpr (kVec) {
      const int c = column<kVec>(c0, lane, 4 * j);
      const int4 v = c < h ? __ldg(reinterpret_cast<const int4*>(p + c))
                           : make_int4(0, 0, 0, 0);
      x[4 * j] = v.x;
      x[4 * j + 1] = v.y;
      x[4 * j + 2] = v.z;
      x[4 * j + 3] = v.w;
    } else {
#pragma unroll
      for (int k = 4 * j; k < 4 * j + 4; ++k) {
        const int c = column<kVec>(c0, lane, k);
        x[k] = c < h ? __ldg(p + c) : 0;
      }
    }
  }
}

__device__ __forceinline__ void add_sums(const int (&x)[kSlots], unsigned& s,
                                         unsigned& s2) {
#pragma unroll
  for (int i = 0; i < kSlots; ++i) {
    s += (unsigned)x[i];
    s2 += (unsigned)x[i] * (unsigned)x[i];
  }
}

// out = ((q - mean) << 18) // sd * gamma + beta for one chunk
template <bool kVec>
__device__ __forceinline__ void normalize_store(
    const int (&x)[kSlots], const int (&g)[kSlots], const int (&b)[kSlots],
    int mean, int sd, int* __restrict__ y, int c0, int h, int lane) {
  using namespace ibert;
  int o[kSlots];
#pragma unroll
  for (int i = 0; i < kSlots; ++i) {
    const int qc = wsub(x[i], mean);
    const int norm = floordiv(wmul(qc, 1 << (kLnNormShift + 7)), sd);
    o[i] = wadd(wmul(norm, g[i]), b[i]);
  }
#pragma unroll
  for (int j = 0; j < kV; ++j) {
    if constexpr (kVec) {
      const int c = column<kVec>(c0, lane, 4 * j);
      if (c < h)
        *reinterpret_cast<int4*>(y + c) =
            make_int4(o[4 * j], o[4 * j + 1], o[4 * j + 2], o[4 * j + 3]);
    } else {
#pragma unroll
      for (int k = 4 * j; k < 4 * j + 4; ++k) {
        const int c = column<kVec>(c0, lane, k);
        if (c < h) y[c] = o[k];
      }
    }
  }
}

template <bool kVec>
__global__ void __launch_bounds__(32 * kRowsPerBlock)
i_layernorm_kernel(const int* __restrict__ q, const int* __restrict__ gamma,
                   const int* __restrict__ beta, int* __restrict__ out,
                   int rows, int h) {
  using namespace ibert;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;  // the whole warp: its shuffles stay full
  const int* xr = q + (size_t)row * h;
  int* yr = out + (size_t)row * h;

  int x[kSlots], g[kSlots], b[kSlots];
  load<kVec>(xr, 0, h, lane, x);
  load<kVec>(gamma, 0, h, lane, g);
  load<kVec>(beta, 0, h, lane, b);
  unsigned s = 0, s2 = 0;
  add_sums(x, s, s2);
  for (int c0 = kChunk; c0 < h; c0 += kChunk) {
    int xc[kSlots];
    load<kVec>(xr, c0, h, lane, xc);
    add_sums(xc, s, s2);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, o);
    s2 += __shfl_xor_sync(0xffffffffu, s2, o);
  }
  const int mean = floordiv((int)s, h);
  // sum((q - mean)^2) in the ring mod 2^32: S2 - 2 mean S + h mean^2
  const unsigned um = (unsigned)mean;
  const unsigned ss = s2 - 2u * um * s + (unsigned)h * um * um;
  const int var = floordiv((int)ss, h);
  const int sd = max(i_sqrt(wshl(var, 14)), 1);

  normalize_store<kVec>(x, g, b, mean, sd, yr, 0, h, lane);
  for (int c0 = kChunk; c0 < h; c0 += kChunk) {
    int xc[kSlots], gc[kSlots], bc[kSlots];
    load<kVec>(xr, c0, h, lane, xc);
    load<kVec>(gamma, c0, h, lane, gc);
    load<kVec>(beta, c0, h, lane, bc);
    normalize_store<kVec>(xc, gc, bc, mean, sd, yr, c0, h, lane);
  }
}

template <bool kVec>
cudaError_t launch(const int* q, const int* gamma, const int* beta, int* out,
                   int rows, int h, cudaStream_t stream) {
  const int blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  i_layernorm_kernel<kVec><<<blocks, 32 * kRowsPerBlock, 0, stream>>>(
      q, gamma, beta, out, rows, h);
  return cudaGetLastError();
}

}  // namespace

// q, out: (rows, h) int32; gamma, beta: (h,) int32; all contiguous.
// Returns the CUDA error of the launch (0 = none).
extern "C" int i_layernorm(const void* q, const void* gamma, const void* beta,
                           void* out, int rows, int h, void* stream) {
  const auto* qi = static_cast<const int*>(q);
  const auto* gi = static_cast<const int*>(gamma);
  const auto* bi = static_cast<const int*>(beta);
  auto* oi = static_cast<int*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = h % 4 == 0 && ((reinterpret_cast<uintptr_t>(q) |
                                   reinterpret_cast<uintptr_t>(gamma) |
                                   reinterpret_cast<uintptr_t>(beta) |
                                   reinterpret_cast<uintptr_t>(out)) &
                                  15) == 0;
  return (int)(vec ? launch<true>(qi, gi, bi, oi, rows, h, st)
                   : launch<false>(qi, gi, bi, oi, rows, h, st));
}
