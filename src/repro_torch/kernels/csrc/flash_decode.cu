// Dense slot-cache single-query flash decode for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/flash_decode.py flash_decode
// (body _kernel).  For each lane b and kv head h it computes single-query
// attention of the G = H / KVH query heads of that group over the lane's
// own slot rows k[b, 0..Sk), v[b, 0..Sk):
//
//   * a key counts iff kpos[b, s] <= qpos[b], qpos[b] - kpos[b, s] < window
//     when window > 0 (ring buffers test the same absolute positions), and
//     active[b]; never-written slots carry the sentinel 2^30 and fail;
//   * the online f32 softmax of decode_split.cuh, p rounded to bf16 before
//     the PV product as the Pallas body casts it to v's dtype.
//
// What bounds it: device-memory bytes.  One call reads the K and V rows of
// the kept keys plus the kpos of every slot of the active lanes; q and the
// output are small.  At the serve path's B=8, Sk=192, KVH=3, hd=64 that is
// at most 1.18 MB: 0.35 us at 3.35 TB/s.  The arithmetic is ~4*G flops per
// K/V element, far below the card's flop-to-byte balance, so plain FMAs
// suffice and G (3) is not padded to a tile of 8 as the TPU wrapper pads
// it.
//
// Design: decode_split.cuh's body (one cluster of 8 blocks per (b, h),
// the Pallas grid's sequential Sk axis cut into 32-slot tiles over the
// cluster's blocks and their warps, an exact skip by kpos of tiles with no
// kept key (slots past qpos, outside the window, never written),
// cp.async rings, warp-parallel scores and softmax, one combine through
// distributed shared memory).  This file supplies the loader: slot s of
// lane b is row b*Sk + s of the (B, Sk, KVH, hd) cache, read in place.  A
// ragged Sk is masked here (slots past Sk hold no key), so the wrapper
// pads nothing.
//
// Head chunks: a lane holds q and acc of GMAX query heads in registers
// (8 floats of each per head), so a group wider than kMaxG = 8 heads
// (recurrentgemma-2b: MQA, G = 10) would spill.  Its heads are cut into
// ceil(G / 8) chunks of at most 8 (10 -> 5 + 5); each chunk is a cluster
// of its own and reads the same kv head, so that head's K/V rows are read
// once per chunk.  hd 256 (recurrentgemma) stages 512-byte rows in one
// ring stage: 4 warps x 32 slots x 2 x 512 B = 128 KiB, plus 5 x 8 x 258
// f32 partials, ~169 KiB a block.
//
// Known limits: every slot's kpos up to Sk is read, also past qpos and
// outside the window (the skip trusts no invariant of the caller); the
// split is 8 whatever the lane's length, so a short lane leaves most of
// its cluster idle; hd 128 and 256 keep one tile in flight per warp (one
// ring stage); a group of more than 8 heads reads its K/V once per chunk.
#include "decode_split.cuh"

namespace {

using decode_split::kMaxG;
using decode_split::kSentinel;
using decode_split::kSplit;
using decode_split::kThreads;

template <int HD>
struct DenseLoader {
  static constexpr int kRowBytes = HD * 2;
  static constexpr bool kScaled = false;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const int* kpos;  // the cache's kpos, (B, Sk)
  int row0, h, kvh, sk;  // row0 = b * Sk

  __device__ int slots() const { return sk; }
  __device__ int row(int slot, int* kp) const {
    if (slot >= sk) {
      *kp = kSentinel;
      return -1;
    }
    *kp = kpos[row0 + slot];
    return row0 + slot;
  }
  __device__ const void* k_src(int r, int c) const {
    return k + ((size_t)r * kvh + h) * HD + c * 8;
  }
  __device__ const void* v_src(int r, int c) const {
    return v + ((size_t)r * kvh + h) * HD + c * 8;
  }
  __device__ static void unpack(const unsigned char* row, int c, float out[8]) {
    decode_split::unpack_bf16x8(reinterpret_cast<const uint4*>(row)[c], out);
  }
};

template <int HD, int GMAX>
__global__ void __cluster_dims__(kSplit, 1, 1) __launch_bounds__(kThreads, 1)
flash_decode_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, const int* __restrict__ kpos,
                    const int* __restrict__ qpos, const unsigned char* __restrict__ active,
                    __nv_bfloat16* __restrict__ out, int kvh, int g, int n_chunks,
                    int sk, int window) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int item = blockIdx.x / kSplit;  // one cluster per (b, h, head chunk)
  const int chunk = item % n_chunks;
  const int b = item / n_chunks / kvh;
  const int h = item / n_chunks % kvh;
  const int gc = (g + n_chunks - 1) / n_chunks;  // heads per chunk, <= GMAX
  const int g0 = chunk * gc;
  const int gn = min(gc, g - g0);  // this chunk's heads
  const size_t head0 = (((size_t)b * kvh + h) * g + g0) * HD;  // its q/out rows
  if (!active[b]) {
    decode_split::write_zeros<HD>(out + head0, gn);
    return;
  }
  const DenseLoader<HD> ld{k, v, kpos, b * sk, h, kvh, sk};
  decode_split::decode<HD, GMAX, true>(q + head0, out + head0, gn, qpos[b], window, ld, smem);
}

template <int HD, int GMAX>
cudaError_t launch(const void* q, const void* k, const void* v, const void* kpos,
                   const void* qpos, const void* active, void* out, int b, int kvh, int g,
                   int n_chunks, int sk, int window, cudaStream_t stream) {
  constexpr size_t smem = decode_split::Smem<HD, GMAX, DenseLoader<HD>>::kBytes;
  auto kernel = flash_decode_kernel<HD, GMAX>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<kSplit * b * kvh * n_chunks, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(kpos),
      static_cast<const int*>(qpos), static_cast<const unsigned char*>(active),
      static_cast<__nv_bfloat16*>(out), kvh, g, n_chunks, sk, window);
  return cudaGetLastError();
}

// G is cut into chunks of at most kMaxG heads; the chunk width rounds up
// to a compiled group width: 2, 4 or 8
template <int HD>
cudaError_t launch_hd(const void* q, const void* k, const void* v, const void* kpos,
                      const void* qpos, const void* active, void* out, int b, int kvh, int g,
                      int sk, int window, cudaStream_t stream) {
  const int n = (g + kMaxG - 1) / kMaxG;
  const int gc = (g + n - 1) / n;
  if (gc <= 2)
    return launch<HD, 2>(q, k, v, kpos, qpos, active, out, b, kvh, g, n, sk, window, stream);
  if (gc <= 4)
    return launch<HD, 4>(q, k, v, kpos, qpos, active, out, b, kvh, g, n, sk, window, stream);
  return launch<HD, 8>(q, k, v, kpos, qpos, active, out, b, kvh, g, n, sk, window, stream);
}

}  // namespace

// C interface, loaded with ctypes.  q: (B, KVH*G, hd) bf16, pre-scaled;
// k/v: (B, Sk, KVH, hd) bf16; kpos: (B, Sk) int32; qpos: (B,) int32;
// active: (B,) bool (one byte each); out: like q; window: 0 = none; G of
// any width (chunks of at most 8 heads).  All contiguous, 16-byte
// aligned.  Launches on `stream`, does not synchronise, and returns
// cudaGetLastError() (0 on success).
extern "C" int flash_decode_bf16(const void* q, const void* k, const void* v, const void* kpos,
                                 const void* qpos, const void* active, void* out, int b,
                                 int kvh, int g, int hd, int sk, int window, void* stream) {
  const long long chunks = (g + kMaxG - 1) / kMaxG;
  if (b < 1 || kvh < 1 || g < 1 || sk < 1 || window < 0 || (long long)b * sk >= (1LL << 31) ||
      (long long)b * kvh * chunks * kSplit >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16:
      return (int)launch_hd<16>(q, k, v, kpos, qpos, active, out, b, kvh, g, sk, window, st);
    case 64:
      return (int)launch_hd<64>(q, k, v, kpos, qpos, active, out, b, kvh, g, sk, window, st);
    case 128:
      return (int)launch_hd<128>(q, k, v, kpos, qpos, active, out, b, kvh, g, sk, window, st);
    case 256:
      return (int)launch_hd<256>(q, k, v, kpos, qpos, active, out, b, kvh, g, sk, window, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
