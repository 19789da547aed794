// Mamba-2 SSD intra-chunk step for Hopper (sm_90a), float32.
//
// Replaces the TPU kernel `ssd_intra_chunk` of
// src/repro/kernels/ssd_scan.py (Pallas body `_ssd_chunk_kernel`). Per
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
// Design. One block owns one (batch, head, chunk), as one grid step does
// on the TPU, and stages the chunk in shared memory: B transposed (its
// rows padded to Q + 1 floats, so that both the score loop, which walks
// it along q, and the state loop, which walks it along n, read without
// bank conflicts), C, xdt and the Q x Q masked, decayed scores. At the
// Mamba-2 shapes (Q 128, N 128, P 64) that is 230,912 bytes, within the
// 227 KB a block may have, so one block runs on an SM at a time; the
// launch raises the dynamic shared memory limit first and returns the
// error if the card refuses it. Warp 0 takes the cumsum (runs per lane,
// then a shuffle scan). The scores are built on and below the diagonal
// only: exp(cs_i - cs_j) is never evaluated above it, where cs_i - cs_j
// is positive and the exponential can overflow (the Pallas body computes
// it there and discards it with a `where`; here inf times 0 would be NaN).
// The y loop stops at each row strip's last row, since the scores above
// the diagonal are zero. Each thread keeps a strip of 8 rows in
// registers, so every shared-memory load of B or xdt feeds 8 FMAs.
//
// Bound on this card: the work per chunk is about Q^2 (N + P) + 2 Q P N
// flops (the lower triangles of C B^T and of the score-weighted sum, and
// the state) against (2 Q P + 2 Q N + P N + Q) * 4 bytes, i.e. about 40
// flop/byte at the Mamba-2 shapes: above the H100's f32 balance point
// (67 TFLOP/s / 3.35 TB/s = 20), so it is operation-bound without tensor
// cores. A serve prompt's head has b * h * c = 48 blocks for 132 SMs, so
// most SMs idle there; the training forward has hundreds. This kernel is
// written simple and right: wgmma on the two Q x Q products, TMA and a
// split of a chunk across blocks are left for later work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 8;  // rows of a thread's register strip

__global__ void __launch_bounds__(kThreads)
ssd_chunk_kernel(const float* __restrict__ xdt, const float* __restrict__ dA,
                 const float* __restrict__ Bg, const float* __restrict__ Cg,
                 float* __restrict__ y, float* __restrict__ states, int H,
                 int G, int nc, int Q, int P, int N) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int QS = Q + 1;          // padded row of B^T
  float* bt = smem;              // N * QS: B^T, bt[n * QS + q]
  float* cm = bt + N * QS;       // Q * N:  C
  float* xs = cm + Q * N;        // Q * P:  xdt
  float* ss = xs + Q * P;        // Q * Q:  (C B^T) * L, zero above diagonal
  float* cs = ss + Q * Q;        // Q:      cumsum of dA
  float* w = cs + Q;             // Q:      exp(cs_last - cs)

  const int ci = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (H / G);
  const size_t head = ((size_t)b * H + h) * nc + ci;
  const size_t grp = ((size_t)b * G + g) * nc + ci;
  const float* x_in = xdt + head * Q * P;
  const float* a_in = dA + head * Q;
  const float* b_in = Bg + grp * Q * N;
  const float* c_in = Cg + grp * Q * N;
  float* y_out = y + head * Q * P;
  float* st_out = states + head * P * N;
  const int tid = threadIdx.x;

  for (int i = tid; i < Q * N; i += kThreads) {
    bt[(i % N) * QS + i / N] = b_in[i];
    cm[i] = c_in[i];
  }
  for (int i = tid; i < Q * P; i += kThreads) xs[i] = x_in[i];
  if (tid < 32) {  // cumsum: each lane a run, then a scan of the run totals
    const int per = (Q + 31) / 32;
    const int lo = min(tid * per, Q), hi = min(lo + per, Q);
    float run = 0.f;
    for (int q = lo; q < hi; ++q) {
      run += a_in[q];
      cs[q] = run;
    }
    float incl = run;
    for (int off = 1; off < 32; off <<= 1) {
      const float v = __shfl_up_sync(0xffffffffu, incl, off);
      if (tid >= off) incl += v;
    }
    const float excl = incl - run;
    for (int q = lo; q < hi; ++q) cs[q] += excl;
  }
  __syncthreads();
  const float cs_last = cs[Q - 1];
  for (int q = tid; q < Q; q += kThreads) w[q] = expf(cs_last - cs[q]);

  // scores: a thread owns column j and rows i0 .. i0 + kRows - 1
  const int row_strips = (Q + kRows - 1) / kRows;
  for (int t = tid; t < row_strips * Q; t += kThreads) {
    const int j = t % Q, i0 = (t / Q) * kRows;
    float acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
    if (i0 + kRows - 1 >= j) {  // some row of the strip is on or below it
      for (int n = 0; n < N; n += 4) {
        const float b0 = bt[n * QS + j], b1 = bt[(n + 1) * QS + j];
        const float b2 = bt[(n + 2) * QS + j], b3 = bt[(n + 3) * QS + j];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const int i = min(i0 + r, Q - 1);
          const float4 c4 = *reinterpret_cast<const float4*>(cm + i * N + n);
          acc[r] = fmaf(c4.x, b0, acc[r]);
          acc[r] = fmaf(c4.y, b1, acc[r]);
          acc[r] = fmaf(c4.z, b2, acc[r]);
          acc[r] = fmaf(c4.w, b3, acc[r]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int i = i0 + r;
      if (i < Q) ss[i * Q + j] = (j <= i) ? acc[r] * expf(cs[i] - cs[j]) : 0.f;
    }
  }
  __syncthreads();

  // y: a thread owns column p and rows i0 .. i0 + kRows - 1
  for (int t = tid; t < row_strips * P; t += kThreads) {
    const int p = t % P, i0 = (t / P) * kRows;
    const int jend = min(i0 + kRows, Q);  // scores past the strip are zero
    float acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
    for (int j = 0; j < jend; j += 4) {
      const float x0 = xs[j * P + p], x1 = xs[(j + 1) * P + p];
      const float x2 = xs[(j + 2) * P + p], x3 = xs[(j + 3) * P + p];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int i = min(i0 + r, Q - 1);
        const float4 s4 = *reinterpret_cast<const float4*>(ss + i * Q + j);
        acc[r] = fmaf(s4.x, x0, acc[r]);
        acc[r] = fmaf(s4.y, x1, acc[r]);
        acc[r] = fmaf(s4.z, x2, acc[r]);
        acc[r] = fmaf(s4.w, x3, acc[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int i = i0 + r;
      if (i < Q) y_out[(size_t)i * P + p] = acc[r];
    }
  }

  // state: a thread owns column n and rows p0 .. p0 + kRows - 1
  const int p_strips = (P + kRows - 1) / kRows;
  for (int t = tid; t < p_strips * N; t += kThreads) {
    const int n = t % N, p0 = (t / N) * kRows;
    float acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
    for (int q = 0; q < Q; ++q) {
      const float bw = bt[n * QS + q] * w[q];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        acc[r] = fmaf(xs[q * P + min(p0 + r, P - 1)], bw, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int p = p0 + r;
      if (p < P) st_out[(size_t)p * N + n] = acc[r];
    }
  }
}

}  // namespace

// Dynamic shared memory of one block, in bytes: B^T (rows padded to Q + 1),
// C, xdt, the Q x Q scores and two rows of Q (cs and the decays).
extern "C" long long ssd_intra_chunk_smem_bytes(int Q, int P, int N) {
  return (long long)sizeof(float) *
         ((long long)N * (Q + 1) + (long long)Q * N + (long long)Q * P +
          (long long)Q * Q + 2LL * Q);
}

// C entry point bound with ctypes. Returns the launch's cudaError_t
// (0 = success); the caller validates devices, types and contiguity.
extern "C" int ssd_intra_chunk_f32(const float* xdt, const float* dA,
                                   const float* B, const float* C, float* y,
                                   float* states, int b, int h, int g, int c,
                                   int Q, int P, int N, void* stream) {
  if (b < 1 || h < 1 || g < 1 || h % g || c < 1 || Q < 4 || Q % 4 ||
      P < 1 || N < 4 || N % 4)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)ssd_intra_chunk_smem_bytes(Q, P, N);
  const cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  ssd_chunk_kernel<<<dim3(c, h, b), kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(xdt, dA, B, C, y,
                                                          states, h, g, c, Q,
                                                          P, N);
  return (int)cudaGetLastError();
}
