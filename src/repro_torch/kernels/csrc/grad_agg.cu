// rho-weighted aggregation of per-client gradients (paper eq. 5) for
// Hopper (sm_90a), float32.
//
// Replaces the TPU kernel `grad_agg_reduce` of
// src/repro/kernels/grad_agg.py (Pallas body `_grad_agg_kernel`):
//
//   g    (N, M)  f32, contiguous: N clients, M elements each
//   rho  (N,)    f32 weights
//   out  (M,)    f32, out[m] = sum_n rho[n] * g[n, m]
//
// Design. The TPU kernel cuts (T, D) into (bt, bd) tiles and keeps the
// whole client axis of a tile in VMEM; the tile shape was the TPU's
// tiling, not the function. Here one thread owns one output element (four
// adjacent ones, as a float4, when M and both pointers allow 16-byte
// loads) and walks n = 0..N-1 in order with an f32 accumulator, so any
// (N, M) works and no element is read twice. Each step is a separate
// IEEE multiply and add (__fmul_rn, __fadd_rn, no FMA contraction), the
// same two roundings as the plain PyTorch version's `acc + rho[n] * g[n]`,
// so kernel and plain version agree bit for bit. A grid-stride loop covers
// any M with a bounded grid.
//
// Bound on this card: memory. Each input element is used once in one
// multiply-add, 0.25 flop/byte, so the least time is (N + 1) * M * 4
// bytes (g read once, out written once) over the 3.35 TB/s HBM rate:
// about 26 us for the paper CNN's cut-1 gradients (10 x 200,704 f32).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132 * 16;  // 16 resident blocks per SM

__global__ void __launch_bounds__(kThreads)
grad_agg_vec4(const float4* __restrict__ g, const float* __restrict__ rho,
              float4* __restrict__ out, int n, long long m4) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < m4; i += stride) {
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int k = 0; k < n; ++k) {
      const float r = __ldg(rho + k);
      const float4 v = __ldg(g + k * m4 + i);
      acc.x = __fadd_rn(acc.x, __fmul_rn(r, v.x));
      acc.y = __fadd_rn(acc.y, __fmul_rn(r, v.y));
      acc.z = __fadd_rn(acc.z, __fmul_rn(r, v.z));
      acc.w = __fadd_rn(acc.w, __fmul_rn(r, v.w));
    }
    out[i] = acc;
  }
}

__global__ void __launch_bounds__(kThreads)
grad_agg_scalar(const float* __restrict__ g, const float* __restrict__ rho,
                float* __restrict__ out, int n, long long m) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < m; i += stride) {
    float acc = 0.f;
    for (int k = 0; k < n; ++k) {
      acc = __fadd_rn(acc, __fmul_rn(__ldg(rho + k), __ldg(g + k * m + i)));
    }
    out[i] = acc;
  }
}

long long grid_for(long long work) {
  const long long blocks = (work + kThreads - 1) / kThreads;
  return blocks < kMaxBlocks ? blocks : kMaxBlocks;
}

}  // namespace

// Returns the CUDA error of the launch (0 on success). Launches on
// `stream` without synchronizing.
extern "C" int grad_agg_f32(const float* g, const float* rho, float* out,
                            int n, long long m, void* stream) {
  if (m <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = m % 4 == 0 &&
      ((reinterpret_cast<uintptr_t>(g) | reinterpret_cast<uintptr_t>(out))
       % 16) == 0;
  if (vec) {
    const long long m4 = m / 4;
    grad_agg_vec4<<<(unsigned)grid_for(m4), kThreads, 0, s>>>(
        reinterpret_cast<const float4*>(g), rho,
        reinterpret_cast<float4*>(out), n, m4);
  } else {
    grad_agg_scalar<<<(unsigned)grid_for(m), kThreads, 0, s>>>(
        g, rho, out, n, m);
  }
  return static_cast<int>(cudaGetLastError());
}
