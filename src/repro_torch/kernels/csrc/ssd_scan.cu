// Mamba-2 SSD intra-chunk step for Hopper (sm_90a), float32 in and out,
// all three products on the tensor cores in 3xTF32.
//
// Replaces the TPU kernel `ssd_intra_chunk` of
// src/repro/kernels/ssd_scan.py:62 (Pallas body `_ssd_chunk_kernel`). Per
// (batch, head, chunk), with cs = cumsum(dA) over the chunk:
//
//   y[i, p]     = sum_{j <= i} (C_i . B_j) exp(cs_i - cs_j) xdt[j, p]
//   state[p, n] = sum_q exp(cs_last - cs_q) B[q, n] xdt[q, p]
//
//   xdt    (b, h, c, Q, P)   x * dt
//   dA     (b, h, c, Q)      dt * A, the log-decay
//   B, C   (b, g, c, Q, N)   per group: head h reads group h / (h_count / g)
//   y      (b, h, c, Q, P)
//   states (b, h, c, P, N)
//
// y is causal attention with q = C, k = B and v = xdt, the softmax
// replaced by the decay exp(cs_i - cs_j): no running max, no
// normalisation, and weights that may be negative. So its loop is the
// flash attention kernel's (csrc/flash_attention.cu), and the helpers
// come from the same header (tf32_mma.cuh).
//
// Work split: one launch, several blocks of 4 warps per chunk, in two
// roles chosen by the block index (every y block numbered before every
// state block).
// - y blocks. The chunk's rows are cut into strips of 16, one a warp;
//   with ny = ceil(strips / 4) y blocks a chunk, block j's warp w takes
//   strip w * ny + j. Strip s sees s +
//   1 key tiles of 16 under the causal mask, so interleaving the strips
//   gives every y block the same work. A block stages its warps' C rows
//   once, then walks the key tiles up to its last strip's diagonal: B (N
//   wide) and xdt (P wide), 16 positions a tile, copied with cp.async
//   while the MMAs run on the tile before, zero-filled past Q, N and P,
//   and split once per block into (hi, lo) pairs. A warp skips the tiles
//   that lie wholly above its strip.
//   S = C B^T (3xTF32, A = C split in registers, B = the B pairs); then
//   S times exp(cs_i - cs_j) on and below the diagonal, and exactly 0
//   above it: the exponential is never evaluated there, where cs_i -
//   cs_j > 0 can overflow and inf x 0 would be NaN (the Pallas body
//   computes it everywhere and discards it with a `where`). S feeds S xdt
//   from its accumulator fragments as the A operand: C's columns (2t,
//   2t + 1) are A's k-indices (t, t + 4), and xdt is read to match.
//   The heads of a group share B and C, so where the chunks are many (two
//   waves of y blocks or more) and P <= 64, a y block takes two heads of
//   one group: S is taken once and each head applies its own decay and
//   multiplies by its own xdt, a third fewer MMAs a head. Where the chunks
//   are few (a serve prompt's head) a block takes one head, which spreads
//   them over more blocks.
// - State blocks. ceil(P / 64) a chunk; warp w of block j owns state
//   rows [64 j + 32 (w % 2), + 32) and half the N columns. A = xdt^T read
//   transposed from the xdt pairs (k-index t = position 2t, as above), B
//   = B w split once per block, w = exp(cs_last - cs) <= 1, which the
//   cumsum's warp writes beside cs.
// Every block recomputes its heads' cumsums of dA (Q adds a head, one
// warp each: runs per lane, then a shuffle scan), in the order the kernel
// always used, so the cumsum's rounding, most of this kernel's error
// against the plain version, does not change. At mamba2-130m's serve
// prompt head (1 x 24 heads x 2 chunks of 128) that is 48 x 3 = 144
// blocks for 132 SMs; at its LM forward (4 x 24 x 8 chunks) 768 y blocks
// of two heads and 768 state blocks. A block stages at most 85,760 bytes
// (Q 128, N 128, P 64) and holds at most 255 registers a thread, so two
// blocks share an SM. The tile size, the head pairing, the block order and
// the exponential were chosen on the card (benchmarks/torch_ssd_variants.py
// times the kernel against each alternative).
//
// Precision: 3xTF32. One TF32 product keeps 10 mantissa bits, and the
// y and state errors it gives at mamba2-130m's chunk (about 5e-4 of the
// largest output, tests/test_torch_ssd.py) are fifty times the 1e-5 x
// max|ref| that holds this kernel against its plain version; the split
// into hi and lo parts, three MMAs a product, is f32-accurate (about
// 5e-7).
//
// Bound on this card: operations. A chunk does Q (Q + 1) (N + P) flops
// for the lower triangles of C B^T and of the weighted sum of xdt, and
// 2 Q P N for the state, against (2 Q P + Q) * 4 bytes a head and 2 Q N
// * 4 a group, plus the P N state out. On the tensor cores the 3xTF32
// split issues three TF32 products per product, so the least time is
// the larger of 3 x the flops over 495 TFLOP/s and the bytes over 3.35
// TB/s: at the serve head 0.00153 ms (operations; bytes 0.00149 ms), at
// the LM forward 0.0245 ms (bytes 0.0239 ms). The old f32-SIMT figure,
// the flops over 67 TFLOP/s, is 0.00377 and 0.0604 ms. (Sharing S between
// two heads does less work than this bound counts.)

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "tf32_mma.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBK = 16;        // chunk positions per staged tile
constexpr int kNT = kBK / 8;   // 8-position groups of a tile
constexpr int kMaxQ = 256;     // chunk size
constexpr int kMaxP = 128;     // head dim
constexpr int kMaxN = 128;     // state size

__host__ __device__ constexpr int round4(int x) { return (x + 3) / 4 * 4; }

// cs = cumsum(a[0:Q]) and, where w is given, w = exp(cs[Q-1] - cs).
// Called by one warp.
__device__ __forceinline__ void chunk_cumsum(const float* __restrict__ a,
                                             float* cs, float* w, int Q) {
  const int lane = threadIdx.x % 32;
  const int per = (Q + 31) / 32;
  const int lo = min(lane * per, Q), hi = min(lo + per, Q);
  float run = 0.f;
  for (int q = lo; q < hi; ++q) {
    run += a[q];
    cs[q] = run;
  }
  float incl = run;
  for (int off = 1; off < 32; off <<= 1) {
    const float v = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += v;
  }
  const float excl = incl - run;
  for (int q = lo; q < hi; ++q) cs[q] += excl;
  if (w != nullptr) {
    __syncwarp();
    const float last = cs[Q - 1];
    for (int q = lo; q < hi; ++q) w[q] = expf(last - cs[q]);
  }
}

// Strides and shared memory of the two roles (NB, PB: N and P rounded up
// to their buckets). The strides put the 32 lanes' fragment reads on
// distinct banks.
template <int NB, int PB>
struct Layout {
  static constexpr int SN = NB + 4;   // C / B rows as copied (floats)
  static constexpr int SP = PB + 4;   // xdt rows as copied
  static constexpr int PK = NB + 4;   // B pairs, read at (key g, dim t)
  static constexpr int PKS = NB + 2;  // B w pairs, read at (pos 2t, col g)
  static constexpr int PV = PB + 2;   // xdt pairs, read at (pos 2t, col g)
  // heads a y block can take: two where both heads' y accumulators fit in
  // registers
  static constexpr int kHeads = PB <= 64 ? 2 : 1;
  // y: B pairs, xdt pairs a head, C, staging (B, xdt a head), cs a head
  static size_t y_bytes(int Q) {
    return sizeof(uint2) * kBK * (PK + kHeads * PV) +
           sizeof(float) * (16 * kWarps * SN + kBK * (SN + kHeads * SP) +
                            kHeads * round4(Q));
  }
  // state: B w and xdt pairs, staging, cs and w
  static size_t state_bytes(int Q) {
    return sizeof(uint2) * kBK * (PKS + PV) +
           sizeof(float) * (kBK * (SN + SP) + 2 * round4(Q));
  }
  static size_t bytes(int Q) {
    return y_bytes(Q) > state_bytes(Q) ? y_bytes(Q) : state_bytes(Q);
  }
};

// Split a staged tile (kBK rows of W floats at stride SS) into pairs at
// stride SD. Where `scale` is given, row r is scaled by scale[r] first,
// and rows from `rows` on (past Q: zero-filled, their scale unwritten) by
// 0.
template <int W, int SS, int SD>
__device__ __forceinline__ void split_tile(uint2* dst, const float* src,
                                           const float* scale, int rows) {
  constexpr int n4 = kBK * W / 4;  // float4s of the tile
#pragma unroll
  for (int k = 0; k < (n4 + kThreads - 1) / kThreads; ++k) {
    const int i = threadIdx.x + k * kThreads;
    if (n4 % kThreads && i >= n4) break;
    const int r = i / (W / 4), c = 4 * (i % (W / 4));
    float4 v = *reinterpret_cast<const float4*>(src + r * SS + c);
    if (scale != nullptr) {
      const float s = r < rows ? scale[r] : 0.f;
      v.x *= s;
      v.y *= s;
      v.z *= s;
      v.w *= s;
    }
    split4(reinterpret_cast<uint4*>(dst + r * SD + c), v);
  }
}

// c[a][b0 + b] += A_a B_b for KA x KB m16n8k8 tiles in 3xTF32: every
// lo.hi, then every hi.lo, then every hi.hi, small terms first into each
// accumulator (as mma3 orders them)
template <int KA, int KB, int LD>
__device__ __forceinline__ void mma3_grid(float (*c)[LD][4], int b0,
                                          const uint32_t (&ahi)[KA][4],
                                          const uint32_t (&alo)[KA][4],
                                          const uint32_t (&bhi)[KB][2],
                                          const uint32_t (&blo)[KB][2]) {
#pragma unroll
  for (int a = 0; a < KA; ++a)
#pragma unroll
    for (int b = 0; b < KB; ++b) mma(c[a][b0 + b], alo[a], bhi[b]);
#pragma unroll
  for (int a = 0; a < KA; ++a)
#pragma unroll
    for (int b = 0; b < KB; ++b) mma(c[a][b0 + b], ahi[a], blo[b]);
#pragma unroll
  for (int a = 0; a < KA; ++a)
#pragma unroll
    for (int b = 0; b < KB; ++b) mma(c[a][b0 + b], ahi[a], bhi[b]);
}

// One warp's work on one key tile for the block's nh heads (1 or 2): its
// 16-row strip from row r0 against keys [k0, k0 + 8 JN). The heads share
// a group's B and C, so S = C B^T is taken once for both; each head
// applies its own decay and multiplies by its own xdt.
template <int JN, int NB, int PB>
__device__ __forceinline__ void y_tile(
    float (*o)[PB / 8][4], int nh, const float* cw, const uint2* bp,
    const uint2* const (&xp)[2], const float* const (&cs)[2],
    const float (&cs_row)[Layout<NB, PB>::kHeads][2], int r0, int k0, int Q,
    int g, int t) {
  using L = Layout<NB, PB>;
  constexpr int SN = L::SN, PK = L::PK, PV = L::PV;
  // S = C B^T: rows g, g + 8 of the strip; keys 8jg + 2t, 8jg + 2t + 1.
  // Two sets of accumulators, even and odd k-steps, summed at the end:
  // twice the independent MMAs in flight.
  float s2[2][JN][4];
#pragma unroll
  for (int e = 0; e < 2; ++e)
#pragma unroll
    for (int jg = 0; jg < JN; ++jg)
      s2[e][jg][0] = s2[e][jg][1] = s2[e][jg][2] = s2[e][jg][3] = 0.f;
  const uint2* bw = bp + g * PK + t;
#pragma unroll
  for (int kk = 0; kk < NB / 8; ++kk) {
    uint32_t ahi[1][4], alo[1][4], bhi[JN][2], blo[JN][2];
    split(cw[8 * kk], ahi[0][0], alo[0][0]);
    split(cw[8 * SN + 8 * kk], ahi[0][1], alo[0][1]);
    split(cw[8 * kk + 4], ahi[0][2], alo[0][2]);
    split(cw[8 * SN + 8 * kk + 4], ahi[0][3], alo[0][3]);
#pragma unroll
    for (int jg = 0; jg < JN; ++jg) {
      const uint2 b0 = bw[8 * jg * PK + 8 * kk];
      const uint2 b1 = bw[8 * jg * PK + 8 * kk + 4];
      bhi[jg][0] = b0.x, bhi[jg][1] = b1.x, blo[jg][0] = b0.y, blo[jg][1] = b1.y;
    }
    mma3_grid<1, JN, JN>(s2 + (kk & 1), 0, ahi, alo, bhi, blo);
  }
#pragma unroll
  for (int jg = 0; jg < JN; ++jg)
#pragma unroll
    for (int i = 0; i < 4; ++i) s2[0][jg][i] += s2[1][jg][i];

#pragma unroll
  for (int h = 0; h < L::kHeads; ++h) {
    if (h >= nh) break;
    // the decay on and below the diagonal, 0 above it and past Q, without
    // a branch: the exponent is 0 where the weight is dropped, so exp
    // never sees a positive cs_i - cs_j
    float s[JN][4];
#pragma unroll
    for (int jg = 0; jg < JN; ++jg)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = r0 + g + 8 * (i >> 1);
        const int key = k0 + 8 * jg + 2 * t + (i & 1);
        const bool ok = key <= row && row < Q;
        const float d = ok ? cs_row[h][i >> 1] - cs[h][min(key, Q - 1)] : 0.f;
        const float v = s2[0][jg][i] * expf(d);
        s[jg][i] = ok ? v : 0.f;
      }

    // y += S xdt: S's C fragment is the A fragment with k-index t = key
    // 2t and k-index t + 4 = key 2t + 1; xdt is read to match
    const uint2* xw = xp[h] + 2 * t * PV + g;
    constexpr int K = PB / 8 < 8 ? PB / 8 : 8;  // column tiles a phase
#pragma unroll
    for (int jg = 0; jg < JN; ++jg) {
      uint32_t ahi[1][4], alo[1][4];
      split(s[jg][0], ahi[0][0], alo[0][0]);  // row g,     key 8jg + 2t
      split(s[jg][2], ahi[0][1], alo[0][1]);  // row g + 8, key 8jg + 2t
      split(s[jg][1], ahi[0][2], alo[0][2]);  // row g,     key 8jg + 2t + 1
      split(s[jg][3], ahi[0][3], alo[0][3]);  // row g + 8, key 8jg + 2t + 1
#pragma unroll
      for (int n0 = 0; n0 < PB / 8; n0 += K) {
        uint32_t bhi[K][2], blo[K][2];
#pragma unroll
        for (int n = 0; n < K; ++n) {
          const uint2 b0 = xw[8 * jg * PV + 8 * (n0 + n)];       // key 2t
          const uint2 b1 = xw[8 * jg * PV + PV + 8 * (n0 + n)];  // key + 1
          bhi[n][0] = b0.x, bhi[n][1] = b1.x;
          blo[n][0] = b0.y, blo[n][1] = b1.y;
        }
        mma3_grid<1, K, PB / 8>(o + h, n0, ahi, alo, bhi, blo);
      }
    }
  }
}

// A y block: nh heads (1, or 2 of one group) of one chunk, and the strips
// of 16 rows its warps take: strip w * ny + j for warp w of block j.
template <int NB, int PB>
__device__ __forceinline__ void y_block(
    const float* const (&x_in)[2], const float* const (&a_in)[2],
    const float* __restrict__ b_in, const float* __restrict__ c_in,
    float* const (&y_out)[2], int nh, int Q, int P, int N, int ny, int j,
    bool vecn, bool vecp, float* smem) {
  using L = Layout<NB, PB>;
  constexpr int SN = L::SN, SP = L::SP, PK = L::PK, PV = L::PV;
  constexpr int kH = L::kHeads;
  // B pairs, then a head's xdt pairs, C, B and a head's xdt as copied, a
  // head's cs (head 1's buffers alias head 0's where a block takes one)
  constexpr int h1 = kH - 1;
  uint2* bp = reinterpret_cast<uint2*>(smem);            // kBK x PK
  uint2* const xpw[2] = {bp + kBK * PK, bp + kBK * (PK + h1 * PV)};
  const uint2* const xp[2] = {xpw[0], xpw[1]};           // kBK x PV
  float* cm = reinterpret_cast<float*>(bp + kBK * (PK + kH * PV));
  float* bs = cm + 16 * kWarps * SN;                     // kBK x SN
  float* const xs[2] = {bs + kBK * SN, bs + kBK * (SN + h1 * SP)};
  float* const csw[2] = {bs + kBK * (SN + kH * SP),
                         bs + kBK * (SN + kH * SP) + h1 * round4(Q)};
  const float* const cs[2] = {csw[0], csw[1]};

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int ns = (Q + 15) / 16;
  auto first_row = [&](int w) { return 16 * (w * ny + j); };
  const int r0 = first_row(warp);
  const bool busy = r0 < Q;
  // the block's last strip ends its key tiles
  const int last = 16 * (j + ny * ((ns - 1 - j) / ny));
  const int kt1 = (min(Q, last + 16) + kBK - 1) / kBK;

  auto stage = [&](int kt) {
    stage_tile<kBK, kThreads, NB, SN>(bs, b_in, kt * kBK, Q, N, vecn);
#pragma unroll
    for (int h = 0; h < kH; ++h)
      if (h < nh)
        stage_tile<kBK, kThreads, PB, SP>(xs[h], x_in[h], kt * kBK, Q, P,
                                          vecp);
  };
  for (int w = 0; w < kWarps; ++w)
    stage_tile<16, kThreads, NB, SN>(cm + 16 * w * SN, c_in, first_row(w), Q,
                                     N, vecn);
  stage(0);
  cp_async_commit();
  if (warp == 0)  // the heads' cumsums, one warp each
    chunk_cumsum(a_in[0], csw[0], nullptr, Q);
  else if (warp == 1 && nh == 2)
    chunk_cumsum(a_in[1], csw[1], nullptr, Q);

  float o[kH][PB / 8][4];
#pragma unroll
  for (int h = 0; h < kH; ++h)
#pragma unroll
    for (int n = 0; n < PB / 8; ++n)
      o[h][n][0] = o[h][n][1] = o[h][n][2] = o[h][n][3] = 0.f;
  const float* cw = cm + (16 * warp + g) * SN + t;
  float cs_row[kH][2];  // cs of rows g and g + 8, once cs has landed

  for (int kt = 0; kt < kt1; ++kt) {
    cp_async_wait<0>();
    __syncthreads();  // tile kt (C and cs too) landed; pairs of kt - 1 read
    split_tile<NB, SN, PK>(bp, bs, nullptr, 0);
#pragma unroll
    for (int h = 0; h < kH; ++h)
      if (h < nh)
        split_tile<PB, SP, PV>(xpw[h], xs[h], nullptr, 0);
    __syncthreads();  // pairs ready, staging free
    if (kt + 1 < kt1) {
      stage(kt + 1);
      cp_async_commit();
    }
    const int k0 = kt * kBK;  // a tile wholly above the strip is skipped
    if (!busy || k0 > r0 + 15) continue;
    if (kt == 0)
#pragma unroll
      for (int h = 0; h < kH; ++h) {
        cs_row[h][0] = cs[h][min(r0 + g, Q - 1)];
        cs_row[h][1] = cs[h][min(r0 + g + 8, Q - 1)];
      }
    y_tile<kNT, NB, PB>(o, nh, cw, bp, xp, cs, cs_row, r0, k0, Q, g, t);
  }

  if (!busy) return;
#pragma unroll
  for (int h = 0; h < kH; ++h) {
    if (h >= nh) break;
#pragma unroll
    for (int n = 0; n < PB / 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = r0 + g + 8 * (i >> 1);
        const int col = 8 * n + 2 * t + (i & 1);
        if (row < Q && col < P)
          y_out[h][(size_t)row * P + col] = o[h][n][i];
      }
  }
}

template <int NB, int PB>
__device__ __forceinline__ void state_block(
    const float* __restrict__ x_in, const float* __restrict__ a_in,
    const float* __restrict__ b_in, float* __restrict__ st_out, int Q, int P,
    int N, int j, bool vecn, bool vecp, float* smem) {
  using L = Layout<NB, PB>;
  constexpr int SN = L::SN, SP = L::SP, PKS = L::PKS, PV = L::PV;
  static_assert(kWarps == 4, "a state block is 2 x 2 warps");
  uint2* bp = reinterpret_cast<uint2*>(smem);  // kBK x PKS: B w pairs
  uint2* xp = bp + kBK * PKS;                  // kBK x PV
  float* bs = reinterpret_cast<float*>(xp + kBK * PV);  // kBK x SN
  float* xs = bs + kBK * SN;                   // kBK x SP
  float* cs = xs + kBK * SP;                   // Q
  float* w = cs + round4(Q);                   // Q: exp(cs_last - cs)

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  // the block's 64 state rows, the warp's 32 of them (two 16-row strips,
  // the second only where P reaches it) and its half of the NB columns
  constexpr int NW = NB / 2;
  const int p0 = 64 * j + 32 * (warp % 2);
  const int n_0 = NW * (warp / 2);
  const bool busy = p0 < P;
  const int nkt = (Q + kBK - 1) / kBK;

  stage_tile<kBK, kThreads, NB, SN>(bs, b_in, 0, Q, N, vecn);
  stage_tile<kBK, kThreads, PB, SP>(xs, x_in, 0, Q, P, vecp);
  cp_async_commit();
  if (warp == 0) chunk_cumsum(a_in, cs, w, Q);

  float st[2][NW / 8][4];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int n = 0; n < NW / 8; ++n)
      st[a][n][0] = st[a][n][1] = st[a][n][2] = st[a][n][3] = 0.f;

  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * kBK;
    cp_async_wait<0>();
    __syncthreads();  // tile kt (and w) landed; pairs of kt - 1 read
    split_tile<NB, SN, PKS>(bp, bs, w + k0, Q - k0);  // B w
    split_tile<PB, SP, PV>(xp, xs, nullptr, 0);
    __syncthreads();
    if (kt + 1 < nkt) {
      stage_tile<kBK, kThreads, NB, SN>(bs, b_in, k0 + kBK, Q, N, vecn);
      stage_tile<kBK, kThreads, PB, SP>(xs, x_in, k0 + kBK, Q, P, vecp);
      cp_async_commit();
    }
    if (!busy) continue;

    // state += xdt^T (B w): A's k-index t = position 2t, t + 4 = 2t + 1
    const uint2* xw = xp + 2 * t * PV + g;
    const uint2* bw = bp + 2 * t * PKS + n_0 + g;
    constexpr int K = NW / 8 < 8 ? NW / 8 : 8;  // column tiles a phase
#pragma unroll
    for (int kk = 0; kk < kNT; ++kk) {
      uint32_t ahi[2][4], alo[2][4];
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        const uint2* xa = xw + 8 * kk * PV + p0 + 16 * a;
        const uint2 a0 = xa[0], a1 = xa[8], a2 = xa[PV], a3 = xa[PV + 8];
        ahi[a][0] = a0.x, ahi[a][1] = a1.x, ahi[a][2] = a2.x, ahi[a][3] = a3.x;
        alo[a][0] = a0.y, alo[a][1] = a1.y, alo[a][2] = a2.y, alo[a][3] = a3.y;
      }
#pragma unroll
      for (int n0 = 0; n0 < NW / 8; n0 += K) {
        uint32_t bhi[K][2], blo[K][2];
#pragma unroll
        for (int n = 0; n < K; ++n) {
          const uint2 b0 = bw[8 * kk * PKS + 8 * (n0 + n)];        // pos 2t
          const uint2 b1 = bw[8 * kk * PKS + PKS + 8 * (n0 + n)];  // pos + 1
          bhi[n][0] = b0.x, bhi[n][1] = b1.x;
          blo[n][0] = b0.y, blo[n][1] = b1.y;
        }
        mma3_grid<2, K, NW / 8>(st, n0, ahi, alo, bhi, blo);
      }
    }
  }

  if (!busy) return;
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int n = 0; n < NW / 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int p = p0 + 16 * a + g + 8 * (i >> 1);
        const int col = n_0 + 8 * n + 2 * t + (i & 1);
        if (p < P && col < N) st_out[(size_t)p * N + col] = st[a][n][i];
      }
}

// Block x of the grid: the y blocks first, role-major (block j of every
// y unit, then block j + 1, ...), then the state blocks the same way. A y
// unit is (batch, group, hb heads of the group, chunk), a state unit
// (batch, head, chunk).
// Two blocks an SM: without the hint ptxas caps some instantiations at
// 128 registers and spills.
template <int NB, int PB>
__global__ void __launch_bounds__(kThreads, 2)
ssd_chunk_kernel(const float* __restrict__ xdt, const float* __restrict__ dA,
                 const float* __restrict__ Bg, const float* __restrict__ Cg,
                 float* __restrict__ y, float* __restrict__ states, int H,
                 int G, int nc, int hb, int y_units, int units, int Q, int P,
                 int N, int ny, int vecn, int vecp) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int hg = H / G;  // heads a group
  const int x = blockIdx.x;
  if (x < ny * y_units) {
    const int j = x / y_units, u = x % y_units;
    const int ci = u % nc, hp = (u / nc) % (hg / hb);
    const int gi = (u / (nc * (hg / hb))) % G, b = u / (nc * (hg / hb) * G);
    const int h0 = gi * hg + hp * hb;
    const size_t grp = ((size_t)b * G + gi) * nc + ci;
    const size_t hd0 = ((size_t)b * H + h0) * nc + ci;
    const size_t hd1 = hd0 + (hb == 2 ? nc : 0);  // the group's next head
    const float* const x_in[2] = {xdt + hd0 * Q * P, xdt + hd1 * Q * P};
    const float* const a_in[2] = {dA + hd0 * Q, dA + hd1 * Q};
    float* const y_out[2] = {y + hd0 * Q * P, y + hd1 * Q * P};
    y_block<NB, PB>(x_in, a_in, Bg + grp * Q * N, Cg + grp * Q * N, y_out,
                    hb, Q, P, N, ny, j, vecn, vecp, smem);
    return;
  }
  const int r = x - ny * y_units;
  const int j = r / units, head = r % units;  // (b * H + h) * nc + c
  const int ci = head % nc, h = (head / nc) % H, b = head / (nc * H);
  const size_t grp = ((size_t)b * G + h / hg) * nc + ci;
  state_block<NB, PB>(xdt + (size_t)head * Q * P, dA + (size_t)head * Q,
                      Bg + grp * Q * N, states + (size_t)head * P * N, Q, P,
                      N, j, vecn, vecp, smem);
}

int y_blocks(int Q) { return ((Q + 15) / 16 + kWarps - 1) / kWarps; }
int state_blocks(int P) { return (P + 63) / 64; }

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms < 1) sms = 132;
  }
  return sms;
}

template <int NB, int PB>
int launch(const float* xdt, const float* dA, const float* B, const float* C,
           float* y, float* states, int b, int h, int g, int c, int Q, int P,
           int N, cudaStream_t stream) {
  const size_t smem = Layout<NB, PB>::bytes(Q);
  const cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_kernel<NB, PB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long units = (long long)b * h * c;
  const int ny = y_blocks(Q);
  // two heads of a group a y block where the group has an even count and
  // the y blocks still fill the card twice over; else one, which spreads
  // a few chunks over more blocks
  const int hb = Layout<NB, PB>::kHeads == 2 && (h / g) % 2 == 0 &&
                         units * ny / 2 >= 2LL * sm_count()
                     ? 2
                     : 1;
  const long long y_units = units / hb;
  const long long blocks = y_units * ny + units * state_blocks(P);
  if (blocks > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  const int vecn = N % 4 == 0 && ((reinterpret_cast<uintptr_t>(B) |
                                   reinterpret_cast<uintptr_t>(C)) % 16) == 0;
  const int vecp = P % 4 == 0 && reinterpret_cast<uintptr_t>(xdt) % 16 == 0;
  ssd_chunk_kernel<NB, PB><<<(unsigned)blocks, kThreads, smem, stream>>>(
      xdt, dA, B, C, y, states, h, g, c, hb, (int)y_units, (int)units, Q, P,
      N, ny, vecn, vecp);
  return (int)cudaGetLastError();
}

template <int NB>
int launch_p(const float* xdt, const float* dA, const float* B,
             const float* C, float* y, float* states, int b, int h, int g,
             int c, int Q, int P, int N, cudaStream_t st) {
  if (P <= 32)
    return launch<NB, 32>(xdt, dA, B, C, y, states, b, h, g, c, Q, P, N, st);
  if (P <= 64)
    return launch<NB, 64>(xdt, dA, B, C, y, states, b, h, g, c, Q, P, N, st);
  return launch<NB, 128>(xdt, dA, B, C, y, states, b, h, g, c, Q, P, N, st);
}

int bucket(int x) { return x <= 16 ? 16 : x <= 32 ? 32 : x <= 64 ? 64 : 128; }

}  // namespace

// Dynamic shared memory of one block, in bytes, at these shapes.
extern "C" long long ssd_intra_chunk_smem_bytes(int Q, int P, int N) {
  const int nb = bucket(N), pb = P <= 32 ? 32 : P <= 64 ? 64 : 128;
  switch (nb * 1000 + pb) {
#define SSD_SMEM(NB, PB) \
  case NB * 1000 + PB:   \
    return (long long)Layout<NB, PB>::bytes(Q);
#define SSD_SMEM_P(NB) SSD_SMEM(NB, 32) SSD_SMEM(NB, 64) SSD_SMEM(NB, 128)
    SSD_SMEM_P(16) SSD_SMEM_P(32) SSD_SMEM_P(64) SSD_SMEM_P(128)
#undef SSD_SMEM_P
#undef SSD_SMEM
    default:
      return -1;
  }
}

// C entry point bound with ctypes. Returns the launch's cudaError_t
// (0 = success); the caller validates devices, types, contiguity and the
// limits (Q <= 256, P <= 128, N <= 128).
extern "C" int ssd_intra_chunk_f32(const float* xdt, const float* dA,
                                   const float* B, const float* C, float* y,
                                   float* states, int b, int h, int g, int c,
                                   int Q, int P, int N, void* stream) {
  if (b < 1 || h < 1 || g < 1 || h % g || c < 1 || Q < 1 || Q > kMaxQ ||
      P < 1 || P > kMaxP || N < 1 || N > kMaxN)
    return (int)cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  switch (bucket(N)) {  // N rounded up to 16, 32, 64 or 128
    case 16:
      return launch_p<16>(xdt, dA, B, C, y, states, b, h, g, c, Q, P, N, st);
    case 32:
      return launch_p<32>(xdt, dA, B, C, y, states, b, h, g, c, Q, P, N, st);
    case 64:
      return launch_p<64>(xdt, dA, B, C, y, states, b, h, g, c, Q, P, N, st);
    default:
      return launch_p<128>(xdt, dA, B, C, y, states, b, h, g, c, Q, P, N, st);
  }
}
