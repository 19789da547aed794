// Causal / windowed flash attention (forward) for Hopper (sm_90a), float32.
//
// Replaces the TPU kernel `flash_attention_bhsd` of
// src/repro/kernels/flash_attention.py (Pallas body `_attn_kernel`):
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
// always.
//
// Design. The TPU grid walks the key tiles of a query tile as its last,
// sequential axis and carries the online-softmax state (m, l, acc) in VMEM
// scratch from one grid step to the next. Hopper blocks run in no order
// and share nothing, so one block owns one (batch, query head, 64-query
// tile) and loops over the 64-key tiles itself: m and l in shared memory,
// the output accumulator in registers (a thread holds one column of 32
// rows). Tiles wholly above the diagonal end the loop; tiles wholly
// before the window are skipped, as the Pallas body's `pl.when` skips
// them. K is staged transposed with rows padded to 65 floats, so the
// score loop reads it without bank conflicts while the 32 lanes of a warp
// share (broadcast) each query row. Any head_dim up to 128 is taken as it
// is (rows padded to a multiple of 4 with zeros in shared memory); the
// reference pads head_dim to the TPU's 128-lane width instead, which
// gives the same function. A ragged last tile is masked here, so S and T
// need not divide the tile. Dynamic shared memory: about 116 KB at
// head_dim 128.
//
// Bound on this card: operations. Causal attention over S queries does
// about 2 S^2 D flops per head (the lower halves of q k^T and p v) against
// (2 S + 2 T) D * 4 bytes of q, k, v and out, i.e. S / 4 flop/byte: at
// granite-8b's S = 2048 that is 512, far above the f32 balance point of
// 20, so the least time is the flops over the f32 rate without tensor
// cores (67 TFLOP/s). This kernel is written simple and right, in f32
// FMAs: wgmma (TF32, bf16), TMA, double-buffered tiles and a warp-level
// softmax in registers are left for later work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;     // queries per block
constexpr int kBK = 64;     // keys per tile
constexpr int kMaxD = 128;
constexpr int kScoreRows = kBQ * kBK / kThreads;  // 16 scores a thread
constexpr int kAccRows = kBQ * kMaxD / kThreads;  // 32 output rows a thread
constexpr float kNegInf = -1e30f;

__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out, int Hq,
                 int Hkv, int S, int T, int D, int window,
                 float scale) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int DP = (D + 3) & ~3;       // row stride, a multiple of 4
  constexpr int KS = kBK + 1;        // padded row of K^T
  float* qs = smem;                  // kBQ * DP: q * scale
  float* kt = qs + kBQ * DP;         // DP * KS:  K^T of the tile
  float* vs = kt + DP * KS;          // kBK * DP: V of the tile
  float* ps = vs + kBK * DP;         // kBQ * kBK: scores, then probabilities
  float* m_s = ps + kBQ * kBK;       // kBQ running max
  float* l_s = m_s + kBQ;            // kBQ running denominator
  float* a_s = l_s + kBQ;            // kBQ rescale factor of this tile

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int q0 = qt * kBQ;
  const float* qb = q + ((size_t)b * Hq + h) * S * D;
  const float* kb = k + ((size_t)b * Hkv + hk) * T * D;
  const float* vb = v + ((size_t)b * Hkv + hk) * T * D;
  float* ob = out + ((size_t)b * Hq + h) * S * D;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;

  for (int i = tid; i < kBQ * DP; i += kThreads) {
    const int r = i / DP, d = i % DP;
    qs[i] = (q0 + r < S && d < D) ? qb[(size_t)(q0 + r) * D + d] * scale
                                  : 0.f;
  }
  for (int r = tid; r < kBQ; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }

  const int sj = tid % kBK, sr = tid / kBK;      // score: column, first row
  const int col = tid % kMaxD, rg = tid / kMaxD;  // output: column, first row
  float acc[kAccRows];
#pragma unroll
  for (int r = 0; r < kAccRows; ++r) acc[r] = 0.f;

  const int nk = (T + kBK - 1) / kBK;
  for (int kti = 0; kti < nk; ++kti) {
    const int k0 = kti * kBK;
    if (k0 > q0 + kBQ - 1) break;  // this and later tiles masked
    if (window > 0 && k0 + kBK - 1 < q0 - window + 1) continue;
    __syncthreads();  // the previous tile's reads of kt, vs, ps are done
    for (int i = tid; i < kBK * DP; i += kThreads) {
      const int r = i / DP, d = i % DP;
      const bool ok = k0 + r < T && d < D;
      kt[d * KS + r] = ok ? kb[(size_t)(k0 + r) * D + d] : 0.f;
      vs[i] = ok ? vb[(size_t)(k0 + r) * D + d] : 0.f;
    }
    __syncthreads();

    float s[kScoreRows];
#pragma unroll
    for (int r = 0; r < kScoreRows; ++r) s[r] = 0.f;
    for (int d = 0; d < DP; d += 4) {
      const float k0v = kt[d * KS + sj], k1v = kt[(d + 1) * KS + sj];
      const float k2v = kt[(d + 2) * KS + sj], k3v = kt[(d + 3) * KS + sj];
#pragma unroll
      for (int r = 0; r < kScoreRows; ++r) {
        const float4 q4 = *reinterpret_cast<const float4*>(
            qs + (sr + 4 * r) * DP + d);
        s[r] = fmaf(q4.x, k0v, s[r]);
        s[r] = fmaf(q4.y, k1v, s[r]);
        s[r] = fmaf(q4.z, k2v, s[r]);
        s[r] = fmaf(q4.w, k3v, s[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < kScoreRows; ++r) {
      const int i = sr + 4 * r;
      const int qp = q0 + i, kp = k0 + sj;
      bool ok = kp < T && kp <= qp;
      if (window > 0) ok = ok && kp > qp - window;
      ps[i * kBK + sj] = ok ? s[r] : kNegInf;
    }
    __syncthreads();

    // online-softmax update: one warp per row, two scores a lane
    for (int i = warp; i < kBQ; i += kThreads / 32) {
      float* pr = ps + i * kBK;
      const float s0 = pr[lane], s1 = pr[lane + 32];
      float mx = fmaxf(s0, s1);
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = m_s[i];
      const float m_new = fmaxf(m_prev, mx);
      const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
      pr[lane] = p0;
      pr[lane + 32] = p1;
      float sum = p0 + p1;
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        l_s[i] = l_s[i] * alpha + sum;
        m_s[i] = m_new;
        a_s[i] = alpha;
      }
    }
    __syncthreads();

    // acc = acc * alpha + p @ v for this thread's column
    if (col < D) {
#pragma unroll
      for (int r = 0; r < kAccRows; ++r) acc[r] *= a_s[rg + 2 * r];
      for (int j = 0; j < kBK; j += 4) {
        const float v0 = vs[j * DP + col], v1 = vs[(j + 1) * DP + col];
        const float v2 = vs[(j + 2) * DP + col], v3 = vs[(j + 3) * DP + col];
#pragma unroll
        for (int r = 0; r < kAccRows; ++r) {
          const float4 p4 = *reinterpret_cast<const float4*>(
              ps + (rg + 2 * r) * kBK + j);
          acc[r] = fmaf(p4.x, v0, acc[r]);
          acc[r] = fmaf(p4.y, v1, acc[r]);
          acc[r] = fmaf(p4.z, v2, acc[r]);
          acc[r] = fmaf(p4.w, v3, acc[r]);
        }
      }
    }
  }
  __syncthreads();  // l_s is final

  if (col < D) {
#pragma unroll
    for (int r = 0; r < kAccRows; ++r) {
      const int i = rg + 2 * r;
      if (q0 + i < S)
        ob[(size_t)(q0 + i) * D + col] = acc[r] / fmaxf(l_s[i], 1e-30f);
    }
  }
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
  const int DP = (D + 3) & ~3;
  const size_t smem =
      sizeof(float) * ((size_t)kBQ * DP + (size_t)DP * (kBK + 1) +
                       (size_t)kBK * DP + (size_t)kBQ * kBK + 3 * kBQ);
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int nq = (S + kBQ - 1) / kBQ;
  flash_fwd_kernel<<<dim3(nq, Hq, B), kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      q, k, v, out, Hq, Hkv, S, T, D, window, scale);
  return (int)cudaGetLastError();
}
