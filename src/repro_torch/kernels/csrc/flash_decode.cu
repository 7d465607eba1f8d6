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
//   * the online f32 softmax of decode_attn.cuh, p rounded to bf16 before
//     the PV product as the Pallas body casts it to v's dtype.
//
// What bounds it: device-memory bytes.  One call reads
//   B*Sk*KVH*hd*2 (K) + the same for V + B*Sk*4 (kpos)
// plus q and the output.  At the serve path's B=8, Sk=192, KVH=3, hd=64
// that is 1.18 MB: 0.35 us at 3.35 TB/s.  The arithmetic is ~4*G flops per
// K/V element, far below the card's flop-to-byte balance, so plain FMAs
// suffice and G (3) is not padded to a tile of 8 as the TPU wrapper pads it.
//
// Design (simple first): the Pallas grid's sequential Sk/bs axis becomes a
// loop over tiles of kTile = 64 slots inside one block of 128 threads per
// (b, h); each tile's K and V rows (kTile x hd bf16) are staged in shared
// memory with coalesced 16-byte loads.  A ragged Sk is masked here (rows
// past Sk get the sentinel and zero K/V), so the wrapper pads nothing.  An
// inactive lane writes zeros and reads no keys.  Known limits, left to
// later work: B*KVH blocks (24 at B=8) underfill the 132 SMs, loads are
// not overlapped with compute, and no tile is skipped (slots past qpos
// are read and masked).
#include "decode_attn.cuh"

namespace {

using decode_attn::kMaxG;
using decode_attn::kSentinel;
using decode_attn::kThreads;
using decode_attn::Tiles;

constexpr int kTile = 64;  // cache slots per tile

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, const int* __restrict__ kpos,
                    const int* __restrict__ qpos, const unsigned char* __restrict__ active,
                    __nv_bfloat16* __restrict__ out, int kvh, int g, int sk, int window) {
  constexpr int kVec = 8;  // bf16 values per 16-byte load
  constexpr int kRowVecs = HD / kVec;
  extern __shared__ __align__(16) unsigned char smem[];
  const Tiles<HD, __nv_bfloat16> t(smem, g, kTile);

  const int b = blockIdx.x / kvh;
  const int h = blockIdx.x % kvh;
  const size_t head0 = ((size_t)b * kvh + h) * g * HD;  // this group's q/out rows
  if (!active[b]) {
    decode_attn::write_zeros<HD>(out + head0, g);
    return;
  }
  const size_t row_stride = (size_t)kvh * HD;  // elements between slot rows
  const __nv_bfloat16* kb = k + (size_t)b * sk * row_stride + (size_t)h * HD;
  const __nv_bfloat16* vb = v + (size_t)b * sk * row_stride + (size_t)h * HD;
  const int* kpb = kpos + (size_t)b * sk;
  auto load = [&](int j) {
    const int r0 = j * kTile;
    for (int i = threadIdx.x; i < kTile * kRowVecs; i += kThreads) {
      const int row = r0 + i / kRowVecs;
      uint4 kx = make_uint4(0u, 0u, 0u, 0u), vx = kx;
      if (row < sk) {
        const size_t off = row * row_stride + (i % kRowVecs) * kVec;
        kx = *reinterpret_cast<const uint4*>(kb + off);
        vx = *reinterpret_cast<const uint4*>(vb + off);
      }
      reinterpret_cast<uint4*>(t.k)[i] = kx;
      reinterpret_cast<uint4*>(t.v)[i] = vx;
    }
    for (int r = threadIdx.x; r < kTile; r += kThreads)
      t.kpos[r] = r0 + r < sk ? kpb[r0 + r] : kSentinel;
  };
  decode_attn::decode_group<HD, __nv_bfloat16, true>(q + head0, out + head0, g, kTile,
                                                     (sk + kTile - 1) / kTile, qpos[b],
                                                     window, t, load);
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, const void* kpos,
                   const void* qpos, const void* active, void* out, int b, int kvh, int g,
                   int sk, int window, cudaStream_t stream) {
  const size_t smem = Tiles<HD, __nv_bfloat16>::bytes(g, kTile);
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  flash_decode_kernel<HD><<<b * kvh, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(kpos),
      static_cast<const int*>(qpos), static_cast<const unsigned char*>(active),
      static_cast<__nv_bfloat16*>(out), kvh, g, sk, window);
  return cudaGetLastError();
}

}  // namespace

// C interface, loaded with ctypes.  q: (B, KVH*G, hd) bf16, pre-scaled;
// k/v: (B, Sk, KVH, hd) bf16; kpos: (B, Sk) int32; qpos: (B,) int32;
// active: (B,) bool (one byte each); out: like q; window: 0 = none.  All
// contiguous, 16-byte aligned.  Launches on `stream`, does not synchronise,
// and returns cudaGetLastError() (0 on success).
extern "C" int flash_decode_bf16(const void* q, const void* k, const void* v, const void* kpos,
                                 const void* qpos, const void* active, void* out, int b,
                                 int kvh, int g, int hd, int sk, int window, void* stream) {
  if (b < 1 || kvh < 1 || g < 1 || g > kMaxG || sk < 1 || window < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16:
      return (int)launch<16>(q, k, v, kpos, qpos, active, out, b, kvh, g, sk, window, st);
    case 64:
      return (int)launch<64>(q, k, v, kpos, qpos, active, out, b, kvh, g, sk, window, st);
    case 128:
      return (int)launch<128>(q, k, v, kpos, qpos, active, out, b, kvh, g, sk, window, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
