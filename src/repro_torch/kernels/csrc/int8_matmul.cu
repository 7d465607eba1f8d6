// INT8 x INT8 -> INT32 GEMM with fused bias and requant, for NVIDIA Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/int8_matmul.py int8_matmul
// (body _kernel): the paper's Linear module (Matrix-Multiply + Bias Addition
// + Quant).  out = A (M,K) int8 @ B (K,N) int8, accumulated in int32, plus
// an optional int32 bias (N,) at scale sa*sb; with requant the epilogue is
//   ratio = (sa * sb) / so            (float32, in that order)
//   x = float(acc) * ratio
//   q = sign(x) * floor(|x| + 0.5)    (round half away, not roundf)
//   out = int8(clip(q, -127, 127))
// and without it the int32 accumulator is stored.  Bit-exact against
// kernels/ref.py int8_matmul.
//
// What bounds it: at the I-BERT encoder's shapes (M = B*S = 128, K and N in
// {768, 3072}) it moves 0.8-4.0 MB, 0.24-1.2 us at 3.35 TB/s, and does
// 2*M*N*K = 0.15-0.6 G int8 ops, 0.08-0.3 us at the tensor cores' 1,979
// TOPS: bound by bytes, and both far below what one launch costs.
//
// Design (simple first): one block of 128 threads per 32 x 64 output tile.
// A K loop stages a 32 x 32 tile of A and a 32 x 64 tile of B in shared
// memory, packed four k values to a 32-bit word (B is transposed on the
// way in), and each thread accumulates a 4 x 4 sub-tile with __dp4a (four
// int8 products and a sum per instruction).  Ragged M, N and K edges are
// masked with zeros in the kernel, so the wrapper pads nothing.  Rows and
// columns of a thread are strided by 8 and 16 so that its shared-memory
// reads hit distinct banks.  Known limits, left to later work: no tensor
// cores (mma.sync / wgmma s8), byte loads instead of 16-byte vectors, no
// overlap of the next tile's loads with this tile's math, and 24-96 blocks
// at M = 128 underfill the 132 SMs.
#include <cuda_runtime.h>
#include <stdint.h>

#include "ibert_int.cuh"

namespace {

constexpr int BM = 32, BN = 64, BK = 32;
constexpr int TM = 4, TN = 4;
constexpr int RT = BM / TM;              // 8 thread rows
constexpr int CT = BN / TN;              // 16 thread columns
constexpr int kThreads = RT * CT;        // 128
constexpr int KW = BK / 4;               // packed words per tile row
constexpr int KWP = KW + 1;              // odd stride: conflict-free reads

template <bool kRequant>
__global__ void __launch_bounds__(kThreads)
int8_matmul_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ b,
                   const int* __restrict__ bias, void* __restrict__ out,
                   int m, int n, int k, float sa, float sb, float so) {
  __shared__ int a_s[BM][KWP];  // a_s[r][w] = A[r0 + r][k0 + 4w .. 4w + 3]
  __shared__ int b_s[BN][KWP];  // b_s[c][w] = B[k0 + 4w .. 4w + 3][c0 + c]

  const int tid = threadIdx.x;
  const int tr = tid / CT;
  const int tc = tid % CT;
  const int r0 = blockIdx.y * BM;
  const int c0 = blockIdx.x * BN;

  int acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < k; k0 += BK) {
    for (int i = tid; i < BM * KW; i += kThreads) {
      const int r = i / KW, w = i % KW;
      const int gr = r0 + r, gk = k0 + 4 * w;
      unsigned word = 0;
      if (gr < m) {
        const int8_t* p = a + (size_t)gr * k;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (gk + j < k) word |= (unsigned)(uint8_t)p[gk + j] << (8 * j);
      }
      a_s[r][w] = (int)word;
    }
    // consecutive threads read consecutive columns of one k row: coalesced
    for (int i = tid; i < BN * KW; i += kThreads) {
      const int c = i % BN, w = i / BN;
      const int gc = c0 + c, gk = k0 + 4 * w;
      unsigned word = 0;
      if (gc < n) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (gk + j < k)
            word |= (unsigned)(uint8_t)b[(size_t)(gk + j) * n + gc] << (8 * j);
      }
      b_s[c][w] = (int)word;
    }
    __syncthreads();
#pragma unroll
    for (int w = 0; w < KW; ++w) {
      int av[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = a_s[tr + RT * i][w];
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = b_s[tc + CT * j][w];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = __dp4a(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  const float ratio = sa * sb / so;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = r0 + tr + RT * i;
    if (r >= m) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = c0 + tc + CT * j;
      if (c >= n) continue;
      int v = acc[i][j];
      if (bias != nullptr) v = ibert::wadd(v, bias[c]);
      if (kRequant) {
        const float x = (float)v * ratio;
        const float sgn = (float)((x > 0.0f) - (x < 0.0f));
        float q = sgn * floorf(fabsf(x) + 0.5f);
        q = fminf(fmaxf(q, -127.0f), 127.0f);
        static_cast<int8_t*>(out)[(size_t)r * n + c] = (int8_t)q;
      } else {
        static_cast<int*>(out)[(size_t)r * n + c] = v;
      }
    }
  }
}

}  // namespace

// A (m, k) and B (k, n) int8, row-major and contiguous; bias (n,) int32 or
// null; out (m, n) int8 when requant, else int32.  Returns the CUDA error of
// the launch (0 = none).
extern "C" int int8_matmul(const void* a, const void* b, const void* bias,
                           void* out, int m, int n, int k, float sa, float sb,
                           float so, int requant, void* stream) {
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* a8 = static_cast<const int8_t*>(a);
  const auto* b8 = static_cast<const int8_t*>(b);
  const auto* bi = static_cast<const int*>(bias);
  if (requant)
    int8_matmul_kernel<true><<<grid, kThreads, 0, s>>>(a8, b8, bi, out, m, n,
                                                        k, sa, sb, so);
  else
    int8_matmul_kernel<false><<<grid, kThreads, 0, s>>>(a8, b8, bi, out, m, n,
                                                         k, sa, sb, so);
  return (int)cudaGetLastError();
}
