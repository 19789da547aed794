// Causal / windowed flash attention (forward) for Hopper (sm_90a), float32
// in and out, both products on the tensor cores in 3xTF32.
//
// Replaces the TPU kernel `flash_attention_bhsd` of
// src/repro/kernels/flash_attention.py:89 (Pallas body `_attn_kernel`):
//
//   q    (B, Hq, S, D)    f32
//   k, v (B, Hkv, T, D)   f32; query head h reads kv head h / (Hq / Hkv)
//   out  (B, Hq, S, D)    f32
//
// out = softmax(q k^T / sqrt(D) + mask) v with the causal mask (key <=
// query) and, when window > 0, the sliding window (key > query - window);
// masked scores are -1e30 and the denominator is clamped at 1e-30, as in
// the reference. The reference also has a non-causal mode, which its only
// caller (the split LM's forward) never takes, so this kernel is causal
// always. Any head_dim up to 128 is taken (the reference pads it to the
// TPU's 128 lanes instead, which gives the same function).
//
// Bound on this card: operations. Causal attention does 4 D flops (q.k
// and p.v) per query head for each key the masks let through against
// (2 S + 2 T) D * 4 bytes of q, k, v and out: at granite-8b's S = 2048
// that is 34.4 GFLOP for 50 MB, ~680 flop/byte. In plain f32 the least
// time is the flops over the SIMT rate (67 TFLOP/s, 0.513 ms); on the
// tensor cores the f32-accurate split below issues 3 TF32 products per
// product, so the least time is 3 x the flops over 495 TFLOP/s, 0.208 ms.
//
// Precision. One TF32 product keeps 10 mantissa bits: score errors of
// 1e-4..1e-3, far outside the 2e-5 that holds this kernel against its
// plain version. So both products run in the 3xTF32 split of
// tf32_mma.cuh (hi and lo parts of each operand, three MMAs a product,
// f32-accurate); `cvt` rounding made the kernel slower on the card.
//
// Design (FlashAttention-2's warp layout with mma.sync; not wgmma, whose
// TF32 form wants both operands K-major and so a transposed V):
// - One block of 8 warps per (batch x query head, 128-query tile); each
//   warp owns 16 query rows. Blocks are numbered so that the last query
//   tiles, which see the most keys under the causal mask, start first.
// - The key-tile loop (32 keys a tile) stays in the block and ends at the
//   diagonal; tiles wholly before the window are skipped, and a warp
//   skips a tile that is masked for all its 16 rows. Skipping a wholly
//   masked tile changes nothing: its weights exp(-1e30 - m) are exact
//   zeros once any key of the row has been seen, and otherwise the next
//   tile's rescale exp(-1e30 - m) wipes them.
// - K and V tiles are copied with cp.async (16 bytes a lane where rows are
//   16-byte aligned, else 4) into a staging buffer; the copy of tile j + 1
//   is in flight while the MMAs run on tile j. A ragged last tile and the
//   head dims past D (up to a multiple of 8) are zero-filled through
//   cp.async's source size, so 0 x garbage never makes a NaN. Once a tile
//   has landed, the block splits it once into (hi, lo) pairs for all 8
//   warps, so that no warp splits K or V itself.
// - S = Q K^T with mma.sync m16n8k8 (A = Q from shared memory, scaled by
//   1/sqrt(D) as it is staged, as the reference scales q; B = K pairs).
//   The scores stay in the m16n8 accumulator fragments; row max and row
//   sum come from the 4 lanes that share a row (__shfl_xor_sync 1, 2).
//   m, the per-lane partial l and the 16 x D output accumulator (64
//   floats a lane at D = 128) stay in registers.
// - P feeds P V as the A operand straight from registers. The C fragment
//   gives lane (g = lane / 4, t = lane % 4) the keys 2t and 2t + 1 of
//   each 8-key group; the A fragment wants k-indices t and t + 4. The sum
//   over keys does not care about their order, so k-index t is taken to
//   be key 2t and k-index t + 4 key 2t + 1, and the V fragment is read to
//   match: b0 from key 2t, b1 from key 2t + 1 (not t and t + 4). A wrong
//   pairing moves the output by order one; the card test with one-hot V
//   rows (tests/test_torch_cuda.py) catches it.
// - Shared memory at D = 128: Q 128 rows and the K and V staging 32 rows
//   each of D + 4 floats, the K and V pairs 32 rows each of D + 4 and D +
//   2 pairs: 164.5 KB, one block (8 warps) an SM. The strides put the 32
//   lanes' fragment reads on distinct banks.

#include <cuda_runtime.h>

#include <cstdint>

#include "tf32_mma.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kBQ = 16 * kWarps;  // queries per block, 16 a warp
constexpr int kBK = 32;           // keys per tile
constexpr int kNT = kBK / 8;      // 8-key groups of a tile
constexpr int kMaxD = 128;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// kND = ceil(head_dim / 8): the 8-dim groups of the buffers and MMAs
template <int kND>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out, int Hq,
                 int Hkv, int S, int T, int D, int window, float scale,
                 int vec) {
  extern __shared__ float4 smem4[];
  constexpr int DP = 8 * kND;
  // Row strides chosen for the banks: Q's 4-byte reads by lanes (g, t) at
  // g * SD + t, K's 8-byte pair reads at g * PK + t and V's at 2t * PV + g
  // each land on distinct banks within a half-warp.
  constexpr int SD = DP + 4, PK = DP + 4, PV = DP + 2;
  float* qs = reinterpret_cast<float*>(smem4);  // kBQ x SD, q / sqrt(D)
  float* ks = qs + kBQ * SD;                    // kBK x SD, K as copied
  float* vs = ks + kBK * SD;                    // kBK x SD, V as copied
  uint2* kp = reinterpret_cast<uint2*>(vs + kBK * SD);  // kBK x PK (hi, lo)
  uint2* vp = kp + kBK * PK;                             // kBK x PV (hi, lo)

  const int bh = blockIdx.x;
  const int b = bh / Hq, h = bh % Hq;
  const int hk = h / (Hq / Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // heavy tiles first
  const float* qb = q + ((size_t)b * Hq + h) * S * D;
  const float* kb = k + ((size_t)b * Hkv + hk) * T * D;
  const float* vb = v + ((size_t)b * Hkv + hk) * T * D;
  float* ob = out + ((size_t)b * Hq + h) * S * D;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;

  // key tiles [kt0, kt1): up to the diagonal, from the window's start
  const int kt1 = (min(T, q0 + kBQ) + kBK - 1) / kBK;
  int kt0 = 0;
  if (window > 0 && q0 - window + 1 > 0) kt0 = (q0 - window + 1) / kBK;

  if (kt0 < kt1) {
    stage_tile<kBK, kThreads, DP, SD>(ks, kb, kt0 * kBK, T, D, vec);
    stage_tile<kBK, kThreads, DP, SD>(vs, vb, kt0 * kBK, T, D, vec);
  }
  cp_async_commit();
  // Q once, scaled as the reference scales it, zero past S and D
  for (int i = tid; i < kBQ * DP; i += kThreads) {
    const int r = i / DP, c = i % DP;
    qs[r * SD + c] =
        (q0 + r < S && c < D) ? qb[(size_t)(q0 + r) * D + c] * scale : 0.f;
  }

  const int r0 = q0 + 16 * warp;  // the warp's first query row
  float o[kND][4];
#pragma unroll
  for (int n = 0; n < kND; ++n)
    o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {kNegInf, kNegInf};  // rows g and g + 8
  float l[2] = {0.f, 0.f};          // this lane's share of the row sums
  const float* qw = qs + (16 * warp + g) * SD + t;

  for (int kt = kt0; kt < kt1; ++kt) {
    cp_async_wait<0>();
    __syncthreads();  // tile kt (and Q) landed; the pairs of kt - 1 all read
    // split the tile once for all warps, then copy the next one meanwhile
    for (int i = tid; i < kBK * DP / 4; i += kThreads) {
      const int rr = i / (DP / 4), c = 4 * (i % (DP / 4));
      split4(reinterpret_cast<uint4*>(kp + rr * PK + c),
             *reinterpret_cast<const float4*>(ks + rr * SD + c));
      split4(reinterpret_cast<uint4*>(vp + rr * PV + c),
             *reinterpret_cast<const float4*>(vs + rr * SD + c));
    }
    __syncthreads();  // pairs ready, staging free
    if (kt + 1 < kt1) {
      stage_tile<kBK, kThreads, DP, SD>(ks, kb, (kt + 1) * kBK, T, D, vec);
      stage_tile<kBK, kThreads, DP, SD>(vs, vb, (kt + 1) * kBK, T, D, vec);
      cp_async_commit();
    }

    const int k0 = kt * kBK;
    const bool live = k0 <= r0 + 15 &&
                      !(window > 0 && k0 + kBK - 1 <= r0 - window);
    if (live) {
      const uint2* kw = kp + g * PK + t;
      const uint2* vw = vp + 2 * t * PV + g;

      // S = Q K^T: rows g, g + 8 of the warp; keys 8j + 2t, 8j + 2t + 1
      float s[kNT][4];
#pragma unroll
      for (int j = 0; j < kNT; ++j)
        s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kND; ++kk) {
        uint32_t ahi[4], alo[4];
        split(qw[8 * kk], ahi[0], alo[0]);
        split(qw[8 * SD + 8 * kk], ahi[1], alo[1]);
        split(qw[8 * kk + 4], ahi[2], alo[2]);
        split(qw[8 * SD + 8 * kk + 4], ahi[3], alo[3]);
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          const uint2 b0 = kw[8 * j * PK + 8 * kk];
          const uint2 b1 = kw[8 * j * PK + 8 * kk + 4];
          const uint32_t bhi[2] = {b0.x, b1.x}, blo[2] = {b0.y, b1.y};
          mma3(s[j], ahi, alo, bhi, blo);
        }
      }

      // masks, where this tile crosses the diagonal, T or the window
      if (k0 + kBK - 1 > r0 || k0 + kBK > T ||
          (window > 0 && k0 <= r0 + 15 - window)) {
#pragma unroll
        for (int j = 0; j < kNT; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int row = r0 + g + 8 * (i >> 1);
            const int key = k0 + 8 * j + 2 * t + (i & 1);
            bool ok = key < T && key <= row;
            if (window > 0) ok = ok && key > row - window;
            if (!ok) s[j][i] = kNegInf;
          }
      }

      // online softmax, rows g (i = 0, 1) and g + 8 (i = 2, 3)
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      }
      float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        alpha[r] = exp2f((m[r] - mx[r]) * kLog2e);
        m[r] = mx[r];
      }
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          s[j][i] = exp2f((s[j][i] - mx[i >> 1]) * kLog2e);
          sum[i >> 1] += s[j][i];
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + sum[r];
#pragma unroll
      for (int n = 0; n < kND; ++n) {
        o[n][0] *= alpha[0];
        o[n][1] *= alpha[0];
        o[n][2] *= alpha[1];
        o[n][3] *= alpha[1];
      }

      // O += P V: P's C fragment is the A fragment with k-index t = key
      // 2t and k-index t + 4 = key 2t + 1; V is read to match
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        uint32_t ahi[4], alo[4];
        split(s[j][0], ahi[0], alo[0]);  // row g,     key 8j + 2t
        split(s[j][2], ahi[1], alo[1]);  // row g + 8, key 8j + 2t
        split(s[j][1], ahi[2], alo[2]);  // row g,     key 8j + 2t + 1
        split(s[j][3], ahi[3], alo[3]);  // row g + 8, key 8j + 2t + 1
#pragma unroll
        for (int n = 0; n < kND; ++n) {
          const uint2 b0 = vw[8 * j * PV + 8 * n];       // key 8j + 2t
          const uint2 b1 = vw[8 * j * PV + PV + 8 * n];  // key 8j + 2t + 1
          const uint32_t bhi[2] = {b0.x, b1.x}, blo[2] = {b0.y, b1.y};
          mma3(o[n], ahi, alo, bhi, blo);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = fmaxf(l[r], 1e-30f);
  }
#pragma unroll
  for (int n = 0; n < kND; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = r0 + g + 8 * (i >> 1);
      const int c = 8 * n + 2 * t + (i & 1);
      if (qp < S && c < D) ob[(size_t)qp * D + c] = o[n][i] / l[i >> 1];
    }
}

template <int kND>
int launch(const float* q, const float* k, const float* v, float* out, int B,
           int Hq, int Hkv, int S, int T, int D, int window, float scale,
           cudaStream_t stream) {
  constexpr int DP = 8 * kND;
  constexpr size_t smem = sizeof(float) * (size_t)(kBQ + 2 * kBK) * (DP + 4) +
                          sizeof(uint2) * (size_t)kBK * (2 * DP + 6);
  const int vec = D % 4 == 0 &&
                  ((reinterpret_cast<uintptr_t>(k) |
                    reinterpret_cast<uintptr_t>(v)) % 16) == 0;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<kND>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int nq = (S + kBQ - 1) / kBQ;
  flash_fwd_kernel<kND><<<dim3(B * Hq, nq), kThreads, smem, stream>>>(
      q, k, v, out, Hq, Hkv, S, T, D, window, scale, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry point bound with ctypes. window <= 0 means no window. Returns
// the launch's cudaError_t (0 = success); the caller validates devices,
// types and contiguity.
extern "C" int flash_attention_f32(const float* q, const float* k,
                                   const float* v, float* out, int B, int Hq,
                                   int Hkv, int S, int T, int D, int window,
                                   float scale, void* stream) {
  if (B < 1 || Hkv < 1 || Hq % Hkv || S < 1 || T < 1 || D < 1 || D > kMaxD)
    return (int)cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  switch ((D + 7) / 8) {  // buffers and MMAs D rounded up to 8 wide
    case 1:
      return launch<1>(q, k, v, out, B, Hq, Hkv, S, T, D, window, scale, st);
    case 2:
      return launch<2>(q, k, v, out, B, Hq, Hkv, S, T, D, window, scale, st);
    case 3:
      return launch<3>(q, k, v, out, B, Hq, Hkv, S, T, D, window, scale, st);
    case 4:
      return launch<4>(q, k, v, out, B, Hq, Hkv, S, T, D, window, scale, st);
    case 5:
      return launch<5>(q, k, v, out, B, Hq, Hkv, S, T, D, window, scale, st);
    case 6:
      return launch<6>(q, k, v, out, B, Hq, Hkv, S, T, D, window, scale, st);
    case 7:
      return launch<7>(q, k, v, out, B, Hq, Hkv, S, T, D, window, scale, st);
    case 8:
      return launch<8>(q, k, v, out, B, Hq, Hkv, S, T, D, window, scale, st);
    case 9:
      return launch<9>(q, k, v, out, B, Hq, Hkv, S, T, D, window, scale, st);
    case 10:
      return launch<10>(q, k, v, out, B, Hq, Hkv, S, T, D, window, scale, st);
    case 11:
      return launch<11>(q, k, v, out, B, Hq, Hkv, S, T, D, window, scale, st);
    case 12:
      return launch<12>(q, k, v, out, B, Hq, Hkv, S, T, D, window, scale, st);
    case 13:
      return launch<13>(q, k, v, out, B, Hq, Hkv, S, T, D, window, scale, st);
    case 14:
      return launch<14>(q, k, v, out, B, Hq, Hkv, S, T, D, window, scale, st);
    case 15:
      return launch<15>(q, k, v, out, B, Hq, Hkv, S, T, D, window, scale, st);
    default:
      return launch<16>(q, k, v, out, B, Hq, Hkv, S, T, D, window, scale, st);
  }
}
