// Paged batched-decode attention for Hopper (sm_90a), float32.
//
// Replaces the TPU kernel `paged_attention_decode` of
// src/repro/kernels/paged_attention.py (Pallas body `_paged_kernel`).
// One query token per decode slot attends over that slot's pages of a
// paged KV pool:
//
//   q        (slots, Hkv, G, D)     GQA group-major, f32
//   pages_k  (Hkv, P, page, D)      physical pools, f32
//   pages_v  (Hkv, P, page, D)
//   table    (slots, max_pages)     int32 physical page ids
//   lengths  (slots,)               int32, counting the just-written token
//   out      (slots, Hkv, G, D)     f32
//
// What bounds it. Per live position and kv head the kernel reads 2*D*4
// bytes of K and V and does 4*G*D flops: G/2 flop a byte, 2 at granite-8b's
// group of 4 and 24 at granite-20b's 48, against the H100's f32 balance of
// about 20 (67 TFLOP/s over 3.35 TB/s). So the live K/V bytes over the HBM
// rate bound it at every shape the smoke runs, with G 48 near the balance.
// At the serve run's few hundred live tokens that bound is a fraction of a
// microsecond, and the launch plus two dependent trips to HBM (the page
// table, then the pages it names) set the time; at a long context the
// bytes do, as far as the slots' lengths let the work spread over the SMs.
//
// The TPU grid walks a slot's pages as a sequential grid axis and carries
// the online-softmax state (m, l, acc) in VMEM across grid steps. Here:
//
// * The whole GQA group in one block. A block owns one (slot, kv head),
//   keeps the pre-scaled queries of the group in shared memory and stages
//   each live K/V row once for all of them. Its 8 warps form kP = 8 / kR
//   position groups of kR warps; a warp holds kGW rows of the group and
//   carries their (m, l, acc) in registers, so no block barrier is needed
//   until the end. The launch picks (kGW, kR) from G: (4, 1) for G <= 4,
//   where each warp of granite-8b's group streams its own positions, up to
//   (12, 4) for granite-20b's 48 (4 warps of 12 rows a position group).
//   Only a group above 64 rows is taken in passes of 64, each re-reading
//   the pages.
// * Asynchronous, wide staging. A stage is 64 consecutive positions of the
//   block's part (4 pages of 16), cut into chunks of 8 dealt to the
//   position groups in turn, so that a short part still gives every group
//   work. A group's first lane issues one bulk copy (cp.async.bulk) of K
//   and one of V for each run of rows within a page (one a chunk at page
//   16) into the group's slice of a two-stage ring; the slot's mbarrier
//   completes when their bytes have landed, so the next stage is in
//   flight while the current one is computed. The page-table row, the
//   length and the queries come in once, up front, in one trip (a row too
//   wide for shared memory stays in device memory, and the issuing lanes
//   read its ids there). Positions
//   at or past the length are never requested: the part stops at the
//   length, and rows past it in a slot are masked in the scores and read
//   as zero in P.V; leaving them out of the softmax is the reference's
//   -1e30 mask (their weight exp(-1e30 - m) is exactly 0 there).
// * Every warp in the arithmetic, in registers. Scores: 8 lanes take a
//   position and split D (4 float4s a lane at D 128, 2 at D 64), so a warp
//   scores 4 positions of a chunk at once and each lane 2 of them; the 8
//   partial dot products a lane holds (4 rows x 2 positions) are reduced
//   over its 8 lanes by one transposing butterfly (7 shuffles, 3 levels),
//   after which each lane holds one score. A warp of one 4-row tile keeps
//   its queries in registers for the pass. Softmax: a row's 8 scores of a
//   chunk sit in 8 lanes, reduced by 3 shuffles, once per stage. P.V: the
//   probabilities go through a small per-warp scratch and are read back
//   as broadcast float4s against the lane's share of each V row.
// * A slot's pages split over a thread block cluster. When slots x Hkv blocks
//   cannot fill the card, the host plan (`split_plan` in paged_attention.py,
//   from shapes only) launches C blocks a (slot, kv head), C <= 8, as one
//   cluster. Rank r takes the contiguous pages [r n / C, (r + 1) n / C) of
//   the slot's n live pages (n comes from the length on the device; the host
//   never reads lengths). At the end every warp writes its partial (m, l,
//   acc) to its block's shared memory; after cluster.sync() a warp of one
//   rank takes each row, reads the C x kP partials of the cluster through
//   distributed shared memory (16 loads in flight before the weights are
//   known), rescales them to the common max and adds them in rank order; a
//   second cluster.sync() keeps every block's shared memory alive until its
//   peers are done. One launch, no workspace in device memory, no atomics:
//   the same inputs give the same bits. A part without pages (n < C, a dead
//   slot) contributes m = -1e30, l = 0, acc = 0, so a dead slot writes exact
//   zeros. C = 1 launches without a cluster and combines the warps' partials
//   in the block. The denominator is clamped at 1e-30.
//
// Tried and dropped on the card: one block-wide pipeline in which all 8 warps
// scored a stage together, a warp a row ran the softmax and each thread owned
// an output column, with acc in shared memory (four block barriers a stage,
// latency-bound at every shape); scores with 32 lanes a position and a
// 5-level butterfly of 31 shuffles (a longer chain, slower on a long slot); a
// combine that read one remote partial at a time (its latencies add up at 8
// ranks); 16-byte cp.async.cg staging by every lane (slower at a long context
// than the bulk copies, whose one issuing lane frees the others); a third
// ring stage (no faster); more warps an SM, as 16-warp blocks or as a
// one-slot ring at two blocks an SM (a few percent faster at the long
// context, slower at the short shapes and on one long slot); giving each
// position group a contiguous slice of the stage (a short part then leaves
// groups idle); splitting the table's [0, max_pages) instead of the live
// pages (a short slot then sits in one rank); the earlier kernel's grid axis
// of 16-row chunks, which re-read every page once per chunk.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "tf32_mma.cuh"  // cp_async16, cp_async4, cp_async_commit, _wait

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kT = 64;            // positions a stage
constexpr int kStages = 2;        // the ring's depth
constexpr int kChunk = 8;         // positions a score tile
constexpr int kRT = 4;            // rows a score tile
constexpr int kMaxCluster = 8;    // the portable cluster size
constexpr int kSmemMax = 232448;  // sm_90's opt-in shared memory a block
constexpr float kNegInf = -1e30f;
static_assert(kRT * kChunk == 32, "a score tile is one sum a lane");

__device__ __forceinline__ float dot4(float4 a, float4 b, float s) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, fmaf(a.x, b.x, s))));
}

template <int D>
struct Lane;  // a lane's share of a row of D floats
template <>
struct Lane<128> {
  using T = float4;
  static __device__ __forceinline__ void axpy(float4& y, float a, float4 x) {
    y.x = fmaf(a, x.x, y.x);
    y.y = fmaf(a, x.y, y.y);
    y.z = fmaf(a, x.z, y.z);
    y.w = fmaf(a, x.w, y.w);
  }
  static __device__ __forceinline__ void scale(float4& y, float a) {
    y.x *= a;
    y.y *= a;
    y.z *= a;
    y.w *= a;
  }
  static __device__ __forceinline__ float4 zero() {
    return make_float4(0.f, 0.f, 0.f, 0.f);
  }
  static __device__ __forceinline__ float4 div(float4 x, float d) {
    return make_float4(x.x / d, x.y / d, x.z / d, x.w / d);
  }
};
template <>
struct Lane<64> {
  using T = float2;
  static __device__ __forceinline__ void axpy(float2& y, float a, float2 x) {
    y.x = fmaf(a, x.x, y.x);
    y.y = fmaf(a, x.y, y.y);
  }
  static __device__ __forceinline__ void scale(float2& y, float a) {
    y.x *= a;
    y.y *= a;
  }
  static __device__ __forceinline__ float2 zero() {
    return make_float2(0.f, 0.f);
  }
  static __device__ __forceinline__ float2 div(float2 x, float d) {
    return make_float2(x.x / d, x.y / d);
  }
};

// One butterfly step of the transposing reduction over 8 lanes:
// v[0, 2H) -> v[0, H), exchanging with the lane H apart.
template <int H>
__device__ __forceinline__ void fold(float (&v)[8], int lane) {
  const bool upper = lane & H;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float send = upper ? v[i] : v[i + H];
    const float keep = upper ? v[i + H] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, H);
  }
}

// Sum 8 values over each group of 8 lanes: lane L returns its group's sum
// of v[L % 8].
__device__ __forceinline__ float reduce_transpose(float (&v)[8], int lane) {
  fold<4>(v, lane);
  fold<2>(v, lane);
  fold<1>(v, lane);
  return v[0];
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// max / sum over the 8 lanes that hold one row of a score tile (lanes
// that differ in bits 0, 3 and 4)
__device__ __forceinline__ float row_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 8));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 16));
}
__device__ __forceinline__ float row_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 8);
  return x + __shfl_xor_sync(0xffffffffu, x, 16);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// One bulk copy of `bytes` (a multiple of 16) from global to shared
// memory, counted against the mbarrier's expected bytes on completion.
__device__ __forceinline__ void bulk_copy(float* dst, const float* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// the one arrival of a phase, expecting `bytes` of bulk copies
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
}

// the warps of one position group: a named barrier, or the warp alone
__device__ __forceinline__ void group_sync(int id, int threads) {
  if (threads == 32)
    __syncwarp();
  else
    asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Shared memory of a launch with kGW rows a warp and kR warps a position
// group (kP = 8 / kR groups, cap = kR * kGW rows a pass; floats unless
// said):
//   kbuf[kStages][kT][D],           the ring; at the end the partial
//   vbuf[kStages][kT][D]            numerators [kP][cap][D]
//   qs[cap][D]                      pre-scaled queries (rows past G: 0)
//   scr[8][kGW][kT / kP]            a warp's probabilities of a stage
//   alpha[8][kGW]                   a warp's rescale of a stage
//   bars[kP][kStages] (uint64)      a slot's mbarrier
//   pm[kP][cap], pl[kP][cap]        partial max and denominator
//   tbl[maxp] (int)                 the slot's page-table row, where it
//                                   fits
template <int D, int kGW, int kR>
struct Layout {
  static constexpr int kP = kWarps / kR;
  static constexpr int kCap = kR * kGW;
  static constexpr int kS = kT / kP;
  static constexpr size_t kRing = 2 * kStages * kT * D;
  static constexpr size_t kFloats = kRing + kCap * D + kWarps * kGW * kS +
                                    kWarps * kGW + 2 * kP * kStages +
                                    2 * kP * kCap;
  static_assert((kRing + kCap * D + kWarps * kGW * kS + kWarps * kGW) % 2 ==
                    0,
                "mbarriers 8-byte aligned");
  static_assert(kP * kCap * D <= kRing, "partials fit in the ring");
};

template <int D, int kGW, int kR>
__global__ void __launch_bounds__(kThreads, 1)
paged_decode_kernel(const float* __restrict__ q,
                    const float* __restrict__ pages_k,
                    const float* __restrict__ pages_v,
                    const int* __restrict__ page_table,
                    const int* __restrict__ lengths,
                    float* __restrict__ out,
                    int hkv, int G, int num_pages, int page, int maxp,
                    bool table_in_smem, float scale) {
  using LaneT = Lane<D>;
  using V = typename LaneT::T;
  using Lay = Layout<D, kGW, kR>;
  constexpr int kP = Lay::kP;            // position groups
  constexpr int kCap = Lay::kCap;
  constexpr int kS = Lay::kS;            // positions a group takes a stage
  constexpr int kChunks = kS / kChunk;   // score tiles' position chunks
  constexpr int kTiles = kGW / kRT;      // score tiles' row blocks
  constexpr int kCopies = D / 4;         // 16-byte copies a row
  constexpr int kQ = D / 32;             // float4s a score lane takes
  static_assert(kGW % kRT == 0 && kS % kChunk == 0, "whole tiles");

  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int pair = blockIdx.x / C;  // (slot, kv head)
  const int b = pair / hkv, h = pair % hkv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  extern __shared__ __align__(16) float smem[];
  float* kbuf = smem;
  float* vbuf = kbuf + kStages * kT * D;
  float* qs = smem + Lay::kRing;
  float* scr = qs + kCap * D;
  float* al = scr + kWarps * kGW * kS;
  uint64_t* bars = reinterpret_cast<uint64_t*>(al + kWarps * kGW);
  float* pm = reinterpret_cast<float*>(bars + kP * kStages);
  float* pl = pm + kP * kCap;
  int* tbl = reinterpret_cast<int*>(pl + kP * kCap);
  float* pacc = kbuf;  // the partial numerators, once the stream is done

  // the table row, the length, and (per pass) the queries: one trip; a
  // row too wide for shared memory is read where it lies
  const int* trow = page_table + (size_t)b * maxp;
  if (table_in_smem)
    for (int i = tid; i < maxp; i += kThreads)  // 4-byte copies of the ids
      cp_async4(reinterpret_cast<float*>(tbl + i),
                reinterpret_cast<const float*>(trow + i), true);
  const int* ids = table_in_smem ? tbl : trow;
  const int length = lengths[b];
  if (tid < kP * kStages) mbar_init(bars + tid);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");

  // this rank's part of the slot's live pages, as positions [pos0, +n_pos)
  const int n_pages = min((length + page - 1) / page, maxp);
  const int p0 = (int)((long long)rank * n_pages / C);
  const int p1 = (int)((long long)(rank + 1) * n_pages / C);
  const int pos0 = p0 * page;
  const int n_pos = max(0, min(p1 * page, length) - pos0);
  const int n_stages = (n_pos + kT - 1) / kT;

  const float* kh = pages_k + (size_t)h * num_pages * page * D;
  const float* vh = pages_v + (size_t)h * num_pages * page * D;
  const size_t row0 = ((size_t)b * hkv + h) * G;  // q / out row of g = 0

  int uses = 0;  // stages through the ring in earlier passes (mbarrier phase)
  for (int g0 = 0; g0 < G; g0 += kCap) {
    const int rows = min(kCap, G - g0);
    const int R = (rows + kGW - 1) / kGW;  // busy warps a position group
    const float* qg = q + (row0 + g0) * D;
    for (int i = tid; i < kCap * kCopies; i += kThreads) {
      const int r = i / kCopies, c = (i % kCopies) * 4;
      cp_async16(qs + r * D + c, r < rows ? qg + r * D + c : qg, r < rows);
    }
    cp_async_commit();
    cp_async_wait<0>();
    for (int i = tid; i < kCap * kCopies; i += kThreads) {  // own copies
      float4* x = reinterpret_cast<float4*>(qs + 4 * i);
      float4 v = *x;
      v.x *= scale;
      v.y *= scale;
      v.z *= scale;
      v.w *= scale;
      *x = v;
    }
    __syncthreads();  // tbl, qs and the mbarriers are in for every thread

    const int p = warp / kR, rho = warp % kR;  // position group, row block
    const bool busy = rho < R;
    const int gw0 = rho * kGW;               // first row of this warp
    // Scores: lanes 8 g8 .. 8 g8 + 7 take positions pi and pi + 4 of a
    // chunk (pi = g8) and split D, a float4 at columns 4 (j8 + 8 i) each;
    // after the reduction lane L holds row rr_l = (L % 8) / 2 of the tile
    // at position pi = g8 + 4 (L % 2). The 8 lanes of a row lead with the
    // one of g8 = 0, L % 2 = 0.
    const int g8 = lane >> 3, j8 = lane & 7;
    const int rr_l = j8 >> 1, pi = g8 + 4 * (j8 & 1);
    const bool row_lead = g8 == 0 && (j8 & 1) == 0;
    // the queries of a tile's rows at this lane's columns; a warp of one
    // tile keeps them in registers for the pass
    float4 qkeep[kTiles == 1 ? kRT : 1][kQ];
    if constexpr (kTiles == 1) {
#pragma unroll
      for (int rr = 0; rr < kRT; ++rr)
#pragma unroll
        for (int i = 0; i < kQ; ++i)
          qkeep[rr][i] = reinterpret_cast<const float4*>(
              qs + (gw0 + rr) * D)[j8 + 8 * i];
    }
    auto qat = [&](int t, int rr, int i) -> float4 {
      if constexpr (kTiles == 1)
        return qkeep[rr][i];
      else
        return reinterpret_cast<const float4*>(
            qs + (gw0 + t * kRT + rr) * D)[j8 + 8 * i];
    };
    float m[kTiles], l[kTiles];
    V acc[kGW];
#pragma unroll
    for (int t = 0; t < kTiles; ++t) {
      m[t] = kNegInf;
      l[t] = 0.f;
    }
#pragma unroll
    for (int r = 0; r < kGW; ++r) acc[r] = LaneT::zero();

    if (busy) {
      float* ws = scr + warp * kGW * kS;
      float* wa = al + warp * kGW;
      const int gthreads = R * 32;
      const bool leader = rho == 0 && lane == 0;
      // Chunk c of this group's slice of stage s holds the stage's
      // positions [(c kP + p) 8, + 8): the groups interleave by chunks, so
      // that a short part still gives every group work. Its live rows:
      auto live = [&](int s, int c) {
        return max(0, min(kChunk, n_pos - (s * kT + (c * kP + p) * kChunk)));
      };
      // one bulk copy of K and one of V a run of rows within a page,
      // issued by the group's first lane; the slot's mbarrier completes
      // when their bytes have landed. Rows past the part are not copied
      // (compute masks them).
      auto issue = [&](int s) {
        const int slot = (uses + s) % kStages;
        float* kd = kbuf + (slot * kT + p * kS) * D;
        float* vd = vbuf + (slot * kT + p * kS) * D;
        uint64_t* bar = bars + p * kStages + slot;
        int rows_in = 0;
#pragma unroll
        for (int c = 0; c < kChunks; ++c) rows_in += live(s, c);
        // the slot's last reads were generic; these writes are async
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        mbar_expect(bar, 2u * rows_in * D * sizeof(float));
#pragma unroll
        for (int c = 0; c < kChunks; ++c) {
          const int nrows = live(s, c);
          int pos = pos0 + s * kT + (c * kP + p) * kChunk;
          int j = pos / page, r = pos - j * page;
          for (int row = 0; row < nrows; ++j, r = 0) {
            const int run = min(nrows - row, page - r);
            const size_t off = ((size_t)ids[j] * page + r) * D;
            const unsigned bytes = run * D * sizeof(float);
            bulk_copy(kd + (c * kChunk + row) * D, kh + off, bytes, bar);
            bulk_copy(vd + (c * kChunk + row) * D, vh + off, bytes, bar);
            row += run;
          }
        }
      };

      if (leader)
        for (int s = 0; s < min(kStages, n_stages); ++s) issue(s);
      for (int s = 0; s < n_stages; ++s) {
        const int slot = (uses + s) % kStages;
        mbar_wait(bars + p * kStages + slot, ((uses + s) / kStages) & 1);
        if (live(s, 0) > 0) {  // chunk 0 is the group's first
          const float* kd = kbuf + (slot * kT + p * kS) * D;
          const float* vd = vbuf + (slot * kT + p * kS) * D;
          float sc[kChunks][kTiles];
#pragma unroll
          for (int c = 0; c < kChunks; ++c) {
            const int nvc = live(s, c);
            if (nvc == 0) {  // a chunk past the part: masked
#pragma unroll
              for (int t = 0; t < kTiles; ++t) sc[c][t] = kNegInf;
              continue;
            }
            // this lane's columns of positions pi and pi + 4
            float4 kr[2][kQ];
#pragma unroll
            for (int w = 0; w < 2; ++w)
#pragma unroll
              for (int i = 0; i < kQ; ++i)
                kr[w][i] = reinterpret_cast<const float4*>(
                    kd + (c * kChunk + g8 + 4 * w) * D)[j8 + 8 * i];
#pragma unroll
            for (int t = 0; t < kTiles; ++t) {
              float part[8];  // [row of the tile][w]
#pragma unroll
              for (int rr = 0; rr < kRT; ++rr) {
#pragma unroll
                for (int w = 0; w < 2; ++w) part[2 * rr + w] = 0.f;
#pragma unroll
                for (int i = 0; i < kQ; ++i) {
                  const float4 qv = qat(t, rr, i);
#pragma unroll
                  for (int w = 0; w < 2; ++w)
                    part[2 * rr + w] = dot4(qv, kr[w][i], part[2 * rr + w]);
                }
              }
              const float v = reduce_transpose(part, lane);
              sc[c][t] = pi < nvc ? v : kNegInf;
            }
          }
          // online softmax of each row over the stage's slice
#pragma unroll
          for (int t = 0; t < kTiles; ++t) {
            float mx = kNegInf;
#pragma unroll
            for (int c = 0; c < kChunks; ++c) mx = fmaxf(mx, sc[c][t]);
            const float m_new = fmaxf(m[t], row_max(mx));
            float sum = 0.f;
#pragma unroll
            for (int c = 0; c < kChunks; ++c) {
              const float e =
                  pi < live(s, c) ? expf(sc[c][t] - m_new) : 0.f;
              ws[(t * kRT + rr_l) * kS + c * kChunk + pi] = e;
              sum += e;
            }
            const float alpha = expf(m[t] - m_new);
            l[t] = l[t] * alpha + row_sum(sum);
            m[t] = m_new;
            if (row_lead) wa[t * kRT + rr_l] = alpha;
          }
          __syncwarp();
          // acc = acc * alpha + p @ v: the lane's columns of the warp's rows
#pragma unroll
          for (int r = 0; r < kGW; ++r) LaneT::scale(acc[r], wa[r]);
#pragma unroll
          for (int c = 0; c < kChunks; ++c) {
            const int nvc = live(s, c);
            if (nvc > 0) {
              V vr[kChunk];  // rows past the part were never copied: 0
#pragma unroll
              for (int i = 0; i < kChunk; ++i)
                vr[i] = i < nvc
                            ? reinterpret_cast<const V*>(
                                  vd + (c * kChunk + i) * D)[lane]
                            : LaneT::zero();
#pragma unroll
              for (int r = 0; r < kGW; ++r) {
                const float4 pa =
                    *reinterpret_cast<const float4*>(ws + r * kS + c * kChunk);
                const float4 pb = *reinterpret_cast<const float4*>(
                    ws + r * kS + c * kChunk + 4);
                LaneT::axpy(acc[r], pa.x, vr[0]);
                LaneT::axpy(acc[r], pa.y, vr[1]);
                LaneT::axpy(acc[r], pa.z, vr[2]);
                LaneT::axpy(acc[r], pa.w, vr[3]);
                LaneT::axpy(acc[r], pb.x, vr[4]);
                LaneT::axpy(acc[r], pb.y, vr[5]);
                LaneT::axpy(acc[r], pb.z, vr[6]);
                LaneT::axpy(acc[r], pb.w, vr[7]);
              }
            }
          }
          __syncwarp();  // ws and wa are free again
        }
        group_sync(1 + p, gthreads);  // the slot is free again
        if (leader && s + kStages < n_stages) issue(s + kStages);
      }
    }
    uses += n_stages;

    // every warp's partial into shared memory (the ring is done with)
    __syncthreads();
    if (busy) {
#pragma unroll
      for (int t = 0; t < kTiles; ++t) {
        if (row_lead) {
          pm[p * kCap + gw0 + t * kRT + rr_l] = m[t];
          pl[p * kCap + gw0 + t * kRT + rr_l] = l[t];
        }
      }
#pragma unroll
      for (int r = 0; r < kGW; ++r)
        reinterpret_cast<V*>(pacc + (size_t)(p * kCap + gw0 + r) * D)[lane] =
            acc[r];
    }
    if (C > 1)
      cluster.sync();  // every rank's partials are in and visible
    else
      __syncthreads();
    auto peer = [&](float* x, int r) {
      return C > 1 ? cluster.map_shared_rank(x, r) : x;
    };

    // combine the C x kP partials of a row, a warp a row: the lanes find
    // the common max, then add the rescaled partials in rank order
    const int n = C * kP;  // partials a row, at most 64
    for (int g = rank + C * warp; g < rows; g += C * kWarps) {
      auto acc_of = [&](int i) {  // partial i's numerator, this lane's share
        return i < n ? reinterpret_cast<const V*>(
                           peer(pacc, i / kP) +
                           (size_t)((i % kP) * kCap + g) * D)[lane]
                     : LaneT::zero();
      };
      V a[16];  // the first 16 in flight while the weights are found
#pragma unroll
      for (int k = 0; k < 16; ++k) a[k] = acc_of(k);
      float mi[2], li[2];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int i = lane + 32 * k;
        mi[k] = kNegInf;
        li[k] = 0.f;
        if (i < n) {
          const int off = (i % kP) * kCap + g;
          mi[k] = peer(pm, i / kP)[off];
          li[k] = peer(pl, i / kP)[off];
        }
      }
      const float mx = warp_max(fmaxf(mi[0], mi[1]));
      const float w0 = expf(mi[0] - mx), w1 = expf(mi[1] - mx);
      V num = LaneT::zero();
      float d = 0.f;
      for (int i0 = 0; i0 < n; i0 += 16) {
        if (i0 > 0) {
#pragma unroll
          for (int k = 0; k < 16; ++k) a[k] = acc_of(i0 + k);
        }
#pragma unroll
        for (int k = 0; k < 16; ++k) {
          const int i = i0 + k;
          const float w = __shfl_sync(0xffffffffu, i < 32 ? w0 : w1, i & 31);
          const float lw = __shfl_sync(0xffffffffu, i < 32 ? li[0] : li[1],
                                       i & 31);
          if (i < n) {
            LaneT::axpy(num, w, a[k]);
            d = fmaf(w, lw, d);
          }
        }
      }
      reinterpret_cast<V*>(out + (row0 + g0 + g) * D)[lane] =
          LaneT::div(num, fmaxf(d, 1e-30f));
    }
    if (C > 1)
      cluster.sync();  // no rank reuses or frees what its peers still read
    else
      __syncthreads();
  }
}

template <int D, int kGW, int kR>
cudaError_t launch(const float* q, const float* pages_k, const float* pages_v,
                   const int* page_table, const int* lengths, float* out,
                   int slots, int hkv, int G, int num_pages, int page,
                   int maxp, int cluster, float scale, cudaStream_t stream) {
  size_t smem = sizeof(float) * Layout<D, kGW, kR>::kFloats;
  const bool table_in_smem = smem + sizeof(int) * (size_t)maxp <= kSmemMax;
  if (table_in_smem) smem += sizeof(int) * (size_t)maxp;
  // the attribute is raised on each device to the most asked so far
  static int smem_set[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64 || (int)smem > smem_set[dev]) {
    err = cudaFuncSetAttribute(paged_decode_kernel<D, kGW, kR>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    if (dev < 64) smem_set[dev] = (int)smem;
  }

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(cluster * hkv * slots));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;  // one block a pair: no cluster
  err = cudaLaunchKernelEx(&cfg, paged_decode_kernel<D, kGW, kR>, q, pages_k,
                           pages_v, page_table, lengths, out, hkv, G,
                           num_pages, page, maxp, table_in_smem, scale);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// (kGW, kR) from the group: the fewest rows a warp that still give every
// warp work, with as many position groups as that leaves
template <int D>
cudaError_t launch_group(const float* q, const float* pages_k,
                         const float* pages_v, const int* page_table,
                         const int* lengths, float* out, int slots, int hkv,
                         int G, int num_pages, int page, int maxp,
                         int cluster, float scale, cudaStream_t s) {
#define PAGED_LAUNCH(GW, R)                                                 \
  launch<D, GW, R>(q, pages_k, pages_v, page_table, lengths, out, slots,   \
                   hkv, G, num_pages, page, maxp, cluster, scale, s)
  if (G <= 4) return PAGED_LAUNCH(4, 1);
  if (G <= 8) return PAGED_LAUNCH(8, 1);
  if (G <= 16) return PAGED_LAUNCH(8, 2);
  if (G <= 32) return PAGED_LAUNCH(8, 4);
  if (G <= 48) return PAGED_LAUNCH(12, 4);
  return PAGED_LAUNCH(8, 8);  // passes of 64 rows past 64
#undef PAGED_LAUNCH
}

}  // namespace

// C entry point bound with ctypes. Returns the launch's cudaError_t
// (0 = success); the caller validates shapes, types, contiguity and
// 16-byte alignment, and plans the cluster size (1 to 8) from shapes.
extern "C" int paged_attention_decode_f32(
    const float* q, const float* pages_k, const float* pages_v,
    const int* page_table, const int* lengths, float* out, int slots, int hkv,
    int G, int D, int num_pages, int page, int maxp, int cluster, float scale,
    void* stream) {
  if (G < 1 || cluster < 1 || cluster > kMaxCluster)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return (int)launch_group<64>(q, pages_k, pages_v, page_table, lengths,
                                   out, slots, hkv, G, num_pages, page, maxp,
                                   cluster, scale, s);
    case 128:
      return (int)launch_group<128>(q, pages_k, pages_v, page_table, lengths,
                                    out, slots, hkv, G, num_pages, page, maxp,
                                    cluster, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
