// M1: the combine of the mixture-of-experts layer (models/moe.py): each
// token's k expert outputs taken from the expert products' rows, weighted
// by their gates and summed, and its backward.
//
//   forward   y[t]        = sum_{j < k, slot[t,j] kept} gates[t,j] ye[slot[t,j]]
//   backward  dye[r]      = gates[t,j] dy[t]   for the pair (t, j) that owns
//                                              row r, 0 for a row no pair owns
//             dgates[t,j] = <dy[t], ye[slot[t,j]]>, 0 for a skipped pair
//
// ye is the expert products' output viewed as (R, d) rows with no copy;
// slot (T, k) int64 names the row of each (token, choice). A pair whose
// slot lies outside [0, R) (the layer's drops and the pairs routed to
// experts held elsewhere carry R) is skipped.
//
// Replaces no TPU kernel: on the TPU this was XLA's gather and einsum. On
// the card PyTorch ran it as a copy of the rows with a zero row appended,
// a gather into a (T k, d) tensor and a batched product, and the gather's
// backward as `index_put_(accumulate=True)`, which sorts the indices and
// walks each run of equal ones in one warp: the slack row's tens of
// thousands of repeats in series (~208 ms of a 1,365 ms granite-4.0-h
// step, PERF.md).
//
// Bound on an H100: bytes, at 3.35 TB/s. The forward reads the kept rows
// once and writes y once; the backward reads dy and ye once for each kept
// row and writes every row of dye once (~0.045 and ~0.08 ms at the
// granite-4.0-h server's T 4,096, k 10, R 6,408, d 4,096).
//
// Design. Memory-bound, so full rows move as 16-byte loads and stores and
// nothing transient reaches device memory but an R-entry inverse map.
//   - forward: one block a token. Warp 0 reads the token's k slots and
//     gates and keeps the kept ones in shared memory in choice order
//     (a ballot). Each thread then holds kCols float4 columns in flight a
//     pass and adds the kept rows into them in that order with fmaf: the
//     sum over choices has one fixed order, and each y element is written
//     once.
//   - backward: an inverse map row -> pair (memset to -1, then written
//     from the kept slots, which are unique: one pair a row), then one
//     block a row. A row no pair owns is written with zeros; an owned row
//     writes gates * dy and reduces <dy, ye> in registers, across the
//     warp by shuffles and across the block's warps in shared memory, in
//     a fixed order; one thread writes dgates. The same blocks write the
//     skipped pairs' dgates zeros, one thread a pair. So every output
//     element is written exactly once: no sort, no atomics, no separate
//     memset of an output, and two launches give the same bits.
//
// Shapes: any R, T, k <= kMaxK and d a multiple of 4; rows 16-byte
// aligned. The wrapper (kernels/moe_combine.py) checks them and raises.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 4;   // float4 columns a thread keeps in flight
constexpr int kMaxK = 32;  // choices a token: one warp reads them

__device__ __forceinline__ bool kept(long long s, long long R) {
  return s >= 0 && s < R;
}

__device__ __forceinline__ float4 fma4(float g, float4 v, float4 acc) {
  acc.x = fmaf(g, v.x, acc.x);
  acc.y = fmaf(g, v.y, acc.y);
  acc.z = fmaf(g, v.z, acc.z);
  acc.w = fmaf(g, v.w, acc.w);
  return acc;
}

__global__ void __launch_bounds__(kThreads) m1_combine_fwd(
    const float4* __restrict__ ye, const long long* __restrict__ slot,
    const float* __restrict__ gates, float4* __restrict__ y, long long R,
    int d4, int k) {
  __shared__ long long s_row[kMaxK];
  __shared__ float s_gate[kMaxK];
  __shared__ int s_n;
  const long long t = blockIdx.x;
  if (threadIdx.x < 32) {
    const int j = threadIdx.x;
    long long s = -1;
    float g = 0.f;
    if (j < k) {
      s = slot[t * k + j];
      g = gates[t * k + j];
    }
    const bool keep = j < k && kept(s, R);
    const unsigned mask = __ballot_sync(0xffffffffu, keep);
    if (keep) {
      const int at = __popc(mask & ((1u << j) - 1u));
      s_row[at] = s;
      s_gate[at] = g;
    }
    if (j == 0) s_n = __popc(mask);
  }
  __syncthreads();
  const int n = s_n;
  float4* out = y + t * d4;
  for (int c0 = threadIdx.x; c0 < d4; c0 += kThreads * kCols) {
    float4 acc[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[c] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 2
    for (int j = 0; j < n; ++j) {
      const float4* row = ye + s_row[j] * d4;
      const float g = s_gate[j];
      float4 v[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int i = c0 + c * kThreads;
        v[c] = i < d4 ? __ldg(row + i) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[c] = fma4(g, v[c], acc[c]);
    }
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int i = c0 + c * kThreads;
      if (i < d4) out[i] = acc[c];
    }
  }
}

__global__ void m1_combine_inverse(const long long* __restrict__ slot,
                                   int* __restrict__ inv, long long R,
                                   long long pairs) {
  const long long p = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (p < pairs) {
    const long long s = slot[p];
    if (kept(s, R)) inv[s] = static_cast<int>(p);
  }
}

__global__ void __launch_bounds__(kThreads) m1_combine_bwd(
    const float4* __restrict__ dy, const float4* __restrict__ ye,
    const long long* __restrict__ slot, const float* __restrict__ gates,
    const int* __restrict__ inv, float4* __restrict__ dye,
    float* __restrict__ dgates, long long R, int d4, int k,
    long long pairs) {
  // the skipped pairs' dgates, one thread a pair over the whole grid
  for (long long p = blockIdx.x * static_cast<long long>(kThreads) +
                     threadIdx.x;
       p < pairs; p += static_cast<long long>(gridDim.x) * kThreads)
    if (!kept(slot[p], R)) dgates[p] = 0.f;
  const long long r = blockIdx.x;
  if (r >= R) return;  // uniform over the block
  float4* out = dye + r * d4;
  const int p = inv[r];
  if (p < 0) {  // no pair owns the row: uniform over the block
    for (int i = threadIdx.x; i < d4; i += kThreads)
      out[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    return;
  }
  const float g = gates[p];
  const float4* dyr = dy + static_cast<long long>(p / k) * d4;
  const float4* yer = ye + r * d4;
  float dot = 0.f;
  for (int c0 = threadIdx.x; c0 < d4; c0 += kThreads * kCols) {
    float4 a[kCols], b[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int i = c0 + c * kThreads;
      a[c] = i < d4 ? __ldg(dyr + i) : make_float4(0.f, 0.f, 0.f, 0.f);
      b[c] = i < d4 ? __ldg(yer + i) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int i = c0 + c * kThreads;
      if (i < d4)
        out[i] = make_float4(g * a[c].x, g * a[c].y, g * a[c].z, g * a[c].w);
      dot = fmaf(a[c].x, b[c].x, dot);
      dot = fmaf(a[c].y, b[c].y, dot);
      dot = fmaf(a[c].z, b[c].z, dot);
      dot = fmaf(a[c].w, b[c].w, dot);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    dot += __shfl_xor_sync(0xffffffffu, dot, o);
  __shared__ float s_part[kWarps];
  if ((threadIdx.x & 31) == 0) s_part[threadIdx.x >> 5] = dot;
  __syncthreads();
  if (threadIdx.x == 0) {
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += s_part[w];
    dgates[p] = sum;
  }
}

}  // namespace

extern "C" int m1_combine_forward(const float* ye, const long long* slot,
                                  const float* gates, float* y, long long R,
                                  long long T, int d, int k, void* stream) {
  if (T <= 0) return 0;
  if (k < 1 || k > kMaxK || d % 4 || T > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  m1_combine_fwd<<<static_cast<unsigned>(T), kThreads, 0, st>>>(
      reinterpret_cast<const float4*>(ye), slot, gates,
      reinterpret_cast<float4*>(y), R, d / 4, k);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int m1_combine_backward(const float* dy, const float* ye,
                                   const long long* slot, const float* gates,
                                   int* inv, float* dye, float* dgates,
                                   long long R, long long T, int d, int k,
                                   void* stream) {
  const long long pairs = T * k;
  if (k < 1 || k > kMaxK || d % 4 || R > 0x7fffffffLL ||
      pairs > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (R <= 0 && pairs <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (R > 0) {
    cudaError_t err = cudaMemsetAsync(inv, 0xff, R * sizeof(int), st);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (pairs > 0) {
      m1_combine_inverse<<<static_cast<unsigned>((pairs + kThreads - 1) /
                                                 kThreads),
                           kThreads, 0, st>>>(slot, inv, R, pairs);
      err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
  }
  const long long blocks = R > 0 ? R : 1;
  m1_combine_bwd<<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
      reinterpret_cast<const float4*>(dy), reinterpret_cast<const float4*>(ye),
      slot, gates, inv, reinterpret_cast<float4*>(dye), dgates, R, d / 4, k,
      pairs);
  return static_cast<int>(cudaGetLastError());
}
