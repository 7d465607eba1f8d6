// The body of the single-query decode kernels on Hopper (sm_90a):
// paged_flash_decode.cu (bf16 page arena), flash_decode.cu (bf16 dense
// slot cache) and paged_flash_decode_q.cu (int8 page arena with f32 row
// scales).  Each kernel supplies only a loader, which maps a lane's key
// slot to its K/V row and kpos and says how a staged row becomes f32;
// the schedule and the softmax are here.
//
// The function (as the Pallas bodies and kernels/ref.py):
//   * a key counts iff kpos <= qpos and, when window > 0, qpos - kpos <
//     window, and the lane is active (the sentinel 2^30 fails the first);
//   * f32 scores, an online f32 softmax with NEG_INF = -1e30, p taken from
//     the mask and never from the scores, so keys that do not count add
//     exact zeros and a split that holds none adds l = 0, acc = 0;
//   * p is rounded to bf16 before the PV product when kRoundP (the bf16
//     caches) and stays f32 otherwise (the int8 arena); sums stay f32;
//   * out = acc / max(l, 1e-30) in bf16; an inactive lane writes exact
//     zeros and reads no keys.
//
// What bounds it: device-memory bytes (the kept keys' K and V rows and
// their scales, and the kpos of the walked slots); ~4*G flops per K/V
// element is far below the card's flop-to-byte balance, so FMAs suffice
// and G is not padded.
//
// Schedule:
//   * One cluster of kSplit blocks per (lane, kv head).  The lane's key
//     slots are cut into tiles of kTile slots; split s (the block of
//     cluster rank s) takes the contiguous tiles [n*s/kSplit,
//     n*(s+1)/kSplit), dealt to its kWarps warps in turn.
//   * Exact skip: before a tile's K/V are loaded, lane r of the warp reads
//     row r's kpos (and, for a page arena, its page id), and a ballot
//     gives the tile's keep mask.  A tile with no kept key loads nothing;
//     in the others only kept rows (and their scales) are copied and the
//     rest are zero-filled, so no row that does not count is ever read.
//   * Loads: each warp keeps a ring of kStages tiles in shared memory,
//     filled by cp.async (16 bytes a row chunk, 4 bytes a scale); the
//     next tile's kpos and page id are read while the ring's other stage
//     is still in flight.
//   * Scores: hd/8 lanes hold one key row, 8 values each, so a warp pass
//     scores 256/hd keys for all G heads against q in registers and
//     reduces each score with log2(hd/8) shuffles.  Lanes that hold the
//     same key slot of each pass form one sub-stream with its own running
//     (m, l, acc), so the online softmax needs no shuffle: one exp per key
//     and head (exp(-|s - m|) is either alpha or p).
//   * Combines, once each: the warp's sub-streams by xor shuffles, the
//     block's warps through shared memory, then the cluster's blocks
//     through distributed shared memory (every rank combines a share of
//     the output), all by M = max m_i, acc = sum acc_i e^(m_i - M),
//     l = sum l_i e^(m_i - M).  A second cluster barrier follows the
//     combine, so that no block exits while a peer still reads it.
//
// The loader hook, for kernel `Loader`:
//   int slots() const;                     key slots of this lane
//   int row(int slot, int* kp) const;      the slot's K/V row, or -1 (then
//                                          *kp = kSentinel) when it holds
//                                          no key
//   const void* k_src(int row, int c) const;   16-byte chunk c of K row
//   const void* v_src(int row, int c) const;   ... and of V row
//   static constexpr int kRowBytes;        bytes of one staged row (a
//                                          multiple of 16)
//   static void unpack(const unsigned char* row, int c, float out[8]);
//                                          the row's values 8c..8c+7
//   static constexpr bool kScaled;         rows carry one f32 scale each;
//                                          then also
//   const float* ks_src(int row) const;    the K row's scale
//   const float* vs_src(int row) const;    ... and the V row's
// A scaled row's values are unpack's times its scale, one f32 rounding
// each (float(int8) * scale, as kv_dequantize); a row that does not count
// gets the scale 0, so a NaN or inf scale that is never copied cannot
// reach the sums.
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace decode_split {

namespace cg = cooperative_groups;

constexpr int kSplit = 8;  // blocks per cluster: splits of one lane's keys
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;   // key slots per tile: the unit of the skip
constexpr int kMaxG = 8;
constexpr int kSentinel = 1 << 30;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ bool keep(int kp, int qpos, int window) {
  return kp <= qpos && (window <= 0 || qpos - kp < window);
}

// 16 bytes global -> shared, asynchronous; zero-filled (nothing read) when
// !on
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool on) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(on ? 16 : 0));
}
// 4 bytes global -> shared, asynchronous; zero-filled when !on
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool on) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(on ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// 8 bf16 (one 16-byte chunk) to f32, exactly
__device__ __forceinline__ void unpack_bf16x8(const uint4 u, float f[8]) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// Shared memory of one block: per warp a ring of kStages tiles (K rows,
// then V rows, then for a scaled loader the K and V rows' scales), then
// the warps' partials (m, l, acc) and the block's.  Rows of 256 bytes
// (bf16 at hd 128) get one stage, so that three blocks (12 warps, 12
// tiles in flight) fit on an SM rather than one.
template <int HD, int GMAX, typename Loader>
struct Smem {
  static constexpr int kStages = Loader::kRowBytes >= 256 ? 1 : 2;
  static constexpr int kRowsBytes = 2 * kTile * Loader::kRowBytes;
  static constexpr int kStageBytes =
      kRowsBytes + (Loader::kScaled ? 2 * kTile * (int)sizeof(float) : 0);
  static constexpr size_t kRing = (size_t)kWarps * kStages * kStageBytes;
  static constexpr size_t kPart = (size_t)GMAX * (HD + 2);  // floats
  static constexpr size_t kBytes = kRing + (kWarps + 1) * kPart * sizeof(float);
};

// Exact zeros for an inactive lane's g rows, shared by the cluster.
template <int HD>
__device__ __forceinline__ void write_zeros(__nv_bfloat16* __restrict__ ob, int g) {
  const int rank = static_cast<int>(cg::this_cluster().block_rank());
  for (int i = rank * kThreads + threadIdx.x; i < g * HD; i += kSplit * kThreads)
    ob[i] = __float2bfloat16(0.f);
}

// Attention of the g (<= GMAX) query rows qb ([g][HD] bf16, pre-scaled) of
// one (lane, kv head) over the slots of `ld`, by the cluster this block is
// part of; the result goes to ob ([g][HD] bf16).
template <int HD, int GMAX, bool kRoundP, typename Loader>
__device__ __forceinline__ void decode(const __nv_bfloat16* __restrict__ qb,
                                       __nv_bfloat16* __restrict__ ob, int g, int qpos,
                                       int window, const Loader& ld, unsigned char* smem) {
  constexpr int kCpr = HD / 8;       // lanes per key row
  constexpr int kKpp = 32 / kCpr;    // keys per warp pass
  constexpr int kPasses = kTile / kKpp;
  constexpr int kRowBytes = Loader::kRowBytes;
  constexpr int kChunks = kRowBytes / 16;  // 16-byte copies per row
  constexpr int kStages = Smem<HD, GMAX, Loader>::kStages;
  constexpr int kStageBytes = Smem<HD, GMAX, Loader>::kStageBytes;
  constexpr int kRowsBytes = Smem<HD, GMAX, Loader>::kRowsBytes;
  static_assert(HD % 8 == 0 && kCpr <= 32 && kKpp <= 16, "head_dim 16..256");
  static_assert(kRowBytes % 16 == 0 && kChunks <= 32, "rows of 16..512 bytes");

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int rr = lane / kCpr;  // key slot of each pass: the sub-stream
  const int c = lane % kCpr;   // the 8 columns 8c..8c+7

  // this split's tiles, dealt to the warps in turn
  const int n_tiles = (ld.slots() + kTile - 1) / kTile;
  const int t0 = (int)((long long)n_tiles * rank / kSplit);
  const int t1 = (int)((long long)n_tiles * (rank + 1) / kSplit);
  const int first = t0 + warp;
  const int n_my = first < t1 ? (t1 - first + kWarps - 1) / kWarps : 0;
  unsigned char* ring = smem + (size_t)warp * kStages * kStageBytes;

  float q[GMAX][8], acc[GMAX][8], m[GMAX], l[GMAX];
#pragma unroll
  for (int gi = 0; gi < GMAX; ++gi) {
    m[gi] = kNegInf;
    l[gi] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[gi][j] = q[gi][j] = 0.f;
    if (gi < g) unpack_bf16x8(*reinterpret_cast<const uint4*>(qb + gi * HD + c * 8), q[gi]);
  }

  // tile i of this warp, lane r: slot r's K/V row and kpos (-1 and the
  // sentinel past the warp's tiles).  The loads are issued here and used
  // when the tile is copied, one tile later.
  struct Meta {
    int row, kp;
  };
  auto fetch = [&](int i) {
    Meta mt{-1, kSentinel};
    if (i < n_my) mt.row = ld.row((first + i * kWarps) * kTile + lane, &mt.kp);
    return mt;
  };
  // the ballot gives tile i's keep mask (to *mask); its kept rows (and
  // their scales) are copied into its stage and the others zero-filled
  auto issue = [&](int i, const Meta& mt, unsigned* mask) {
    *mask = __ballot_sync(0xffffffffu, mt.row >= 0 && keep(mt.kp, qpos, window));
    if (*mask) {
      unsigned char* st = ring + (i % kStages) * kStageBytes;
#pragma unroll
      for (int e = lane; e < kTile * kChunks; e += 32) {
        const int r = e / kChunks;
        const int cc = e % kChunks;
        const int src = __shfl_sync(0xffffffffu, mt.row, r);
        const bool on = (*mask >> r) & 1u;
        cp_async16(st + r * kRowBytes + cc * 16, ld.k_src(on ? src : 0, cc), on);
        cp_async16(st + (kTile + r) * kRowBytes + cc * 16, ld.v_src(on ? src : 0, cc), on);
      }
      if constexpr (Loader::kScaled) {  // lane r: row r's two scales
        const bool on = (*mask >> lane) & 1u;
        float* sc = reinterpret_cast<float*>(st + kRowsBytes);
        cp_async4(sc + lane, ld.ks_src(on ? mt.row : 0), on);
        cp_async4(sc + kTile + lane, ld.vs_src(on ? mt.row : 0), on);
      }
    }
    cp_async_commit();  // one group per tile, empty or not
  };

  // the ring: tile i in stage i % kStages, one cp.async group per tile
  unsigned mask_cur = 0, mask_next = 0;
  issue(0, fetch(0), &mask_cur);
  if constexpr (kStages == 2) issue(1, fetch(1), &mask_next);
  Meta ahead = fetch(kStages);  // the next tile to issue

  for (int i = 0; i < n_my; ++i) {
    cp_async_wait<kStages - 1>();  // tile i's group (a newer one may fly)
    __syncwarp();
    if (mask_cur) {
      // every pass, and all GMAX heads (those past g have q = 0 and are
      // never written out): no branch inside, so the heads' shuffle
      // chains and the passes interleave.  A row that does not count is
      // zero-filled and gets p = 0, alpha = 1: it changes nothing.
      const unsigned char* st = ring + (i % kStages) * kStageBytes;
#pragma unroll 4
      for (int p = 0; p < kPasses; ++p) {
        const int r = p * kKpp + rr;
        const bool on = (mask_cur >> r) & 1u;
        float kf[8], vf[8];
        Loader::unpack(st + r * kRowBytes, c, kf);
        Loader::unpack(st + (kTile + r) * kRowBytes, c, vf);
        if constexpr (Loader::kScaled) {  // dequantize: one rounding each
          const float* sc = reinterpret_cast<const float*>(st + kRowsBytes);
          const float sk = sc[r];
          const float sv = sc[kTile + r];
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            kf[j] = __fmul_rn(kf[j], sk);
            vf[j] = __fmul_rn(vf[j], sv);
          }
        }
#pragma unroll
        for (int gi = 0; gi < GMAX; ++gi) {
          float s0 = 0.f, s1 = 0.f;
#pragma unroll
          for (int j = 0; j < 8; j += 2) {
            s0 = fmaf(q[gi][j], kf[j], s0);
            s1 = fmaf(q[gi][j + 1], kf[j + 1], s1);
          }
          float s = s0 + s1;
#pragma unroll
          for (int o = kCpr / 2; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
          s = on ? s : kNegInf;
          // one exp: e = exp(-|s - m|) is alpha when s raises the max
          // (then p = 1) and p otherwise (then alpha = 1)
          const float d = s - m[gi];
          const float e = __expf(-fabsf(d));
          const bool up = d > 0.f;
          const float alpha = up ? e : 1.f;
          const float pk = on ? (up ? 1.f : e) : 0.f;
          m[gi] = up ? s : m[gi];
          l[gi] = fmaf(l[gi], alpha, pk);
          const float pv = kRoundP ? __bfloat162float(__float2bfloat16(pk)) : pk;
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[gi][j] = fmaf(pv, vf[j], acc[gi][j] * alpha);
        }
      }
    }
    __syncwarp();  // every lane is done with the stage before it refills
    mask_cur = mask_next;
    mask_next = 0;
    issue(i + kStages, ahead, kStages == 2 ? &mask_next : &mask_cur);
    ahead = fetch(i + kStages + 1);
  }
  cp_async_wait<0>();

  // the warp's sub-streams, combined by xor shuffles over the key slots
#pragma unroll
  for (int o = kCpr; o < 32; o <<= 1) {
#pragma unroll
    for (int gi = 0; gi < GMAX; ++gi) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[gi], o);
      const float lo = __shfl_xor_sync(0xffffffffu, l[gi], o);
      const float mx = fmaxf(m[gi], mo);
      const float a = __expf(m[gi] - mx);
      const float b = __expf(mo - mx);
      l[gi] = l[gi] * a + lo * b;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        acc[gi][j] = acc[gi][j] * a + __shfl_xor_sync(0xffffffffu, acc[gi][j], o) * b;
      m[gi] = mx;
    }
  }

  // the warps' partials, then the block's: [m][GMAX], [l][GMAX], [acc][GMAX][HD]
  constexpr size_t kPart = Smem<HD, GMAX, Loader>::kPart;
  float* parts = reinterpret_cast<float*>(smem + Smem<HD, GMAX, Loader>::kRing);
  float* wpart = parts + warp * kPart;
  float* bpart = parts + kWarps * kPart;
  if (lane < kCpr) {
#pragma unroll
    for (int gi = 0; gi < GMAX; ++gi) {
      if (gi < g) {
#pragma unroll
        for (int j = 0; j < 8; ++j) wpart[2 * GMAX + gi * HD + c * 8 + j] = acc[gi][j];
        if (lane == 0) {
          wpart[gi] = m[gi];
          wpart[GMAX + gi] = l[gi];
        }
      }
    }
  }
  __syncthreads();
  for (int idx = tid; idx < g * HD; idx += kThreads) {
    const int gi = idx / HD;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, parts[w * kPart + gi]);
    float a = 0.f, ls = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float sc = expf(parts[w * kPart + gi] - mx);
      a += parts[w * kPart + 2 * GMAX + idx] * sc;
      ls += parts[w * kPart + GMAX + gi] * sc;
    }
    bpart[2 * GMAX + idx] = a;
    if (idx % HD == 0) {
      bpart[gi] = mx;
      bpart[GMAX + gi] = ls;
    }
  }
  cluster.sync();  // every block's partial is written and visible

  // the cluster's blocks: each rank combines a share of the g*HD outputs
  for (int idx = rank * kThreads + tid; idx < g * HD; idx += kSplit * kThreads) {
    const int gi = idx / HD;
    const float* peer[kSplit];
    float mx = kNegInf;
#pragma unroll
    for (int s = 0; s < kSplit; ++s) {
      peer[s] = cluster.map_shared_rank(bpart, s);
      mx = fmaxf(mx, peer[s][gi]);
    }
    float a = 0.f, ls = 0.f;
#pragma unroll
    for (int s = 0; s < kSplit; ++s) {
      const float sc = expf(peer[s][gi] - mx);
      a += peer[s][2 * GMAX + idx] * sc;
      ls += peer[s][GMAX + gi] * sc;
    }
    ob[idx] = __float2bfloat16(a / fmaxf(ls, 1e-30f));
  }
  cluster.sync();  // no block exits while a peer still reads its partial
}

}  // namespace decode_split
