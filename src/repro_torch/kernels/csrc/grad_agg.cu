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
// The TPU kernel cuts (T, D) into (bt, bd) tiles and keeps the whole
// client axis of a tile in VMEM; the tile shape was the TPU's tiling, not
// the function, so any (N, M) is taken here.
//
// Arithmetic, on every path: the accumulator starts from 0 and adds the
// clients in order n = 0..N-1, each step one __fmul_rn and one __fadd_rn
// (no FMA contraction, no reordering). Those are the two roundings of the
// plain PyTorch version's `acc + rho[n] * g[n]`, so kernel and plain
// version agree bit for bit. The paths below change only where values
// come from and who sums them.
//
// Bound on this card: memory. Each input element is used once in one
// multiply-add, 0.25 flop/byte, so the least time is (N + 1) * M * 4
// bytes (g read once, out written once) over the 3.35 TB/s HBM rate. At
// chip_smoke.py phase 3b's shapes: the paper CNN's cut-2 gradients (10 x
// 100,352) 4.4 MB, 0.00132 ms; cut 1 (10 x 200,704) 8.8 MB, 0.00264 ms;
// an LM boundary (8 x 2048 x 4096) 302 MB, 0.0901 ms; one client of
// 4,096 (the launch floor) 33 KB, 0.00001 ms.
//
// Design. The host plans the path from shapes and alignment alone
// (`grad_agg_plan` in ../grad_agg.py) and passes it in. On the wave and
// stream paths N <= 16 is a template parameter, every access is a 16-byte
// unit of 4 f32 (a float4), offsets are 32-bit (N * M < 2^31), and each
// thread reads rho into registers once.
// * wave (the cut-layer payloads): blocks of 128 threads, one unit of
//   every client a thread (neighbouring threads on neighbouring
//   addresses); a thread issues all N loads before its first add, so the
//   payload is in flight in one trip. `__launch_bounds__` holds each
//   instance to the residency the plan counts on (`wave_blocks_per_sm`).
//   Cut 2 is 196 blocks, cut 1 392 (the single-path walk this replaces:
//   98 and 196 blocks of 256 threads, a client loop of a runtime trip
//   count reloading rho[n] a step). Two or four units a thread (fewer,
//   larger blocks) were tried and were no faster at the payloads the
//   plan gives this path; past one wave the stream path was the faster
//   with the harness's cold L2. What holds it back: the launch and one
//   cold trip to HBM (one client of 4,096 takes about 0.0054 ms in the
//   same harness), and the write-back of dirty L2 lines the harness's
//   flush leaves, not bandwidth.
// * stream (payloads past the wave path's): a persistent grid of 2 blocks
//   of 256 threads an SM walks tiles of 256 * K units, K = 16 / N rounded
//   down to {1, 2, 4}, tile b, b + grid, ...; each thread loads its N * K
//   units of a tile with L1::no_allocate and an L2 evict-first policy,
//   sums, and writes with a streaming store (__stcs). A ring of bulk
//   copies (cp.async.bulk on mbarriers) in shared memory was tried in its
//   place and was within 1 % of it, either way, at every shape tried.
//   What holds it back: HBM's sustained rate for N read streams and one
//   write stream (94 % of the bound with a clean L2), and in the harness
//   the write-back of the dirty lines its flush leaves in L2, which a
//   same-bytes `g.sum(0)` pays too.
// * general (N > 16, M % 4 != 0, an unaligned view, or N * M >= 2^31):
//   the earlier grid-stride walk, one float4 (where M % 4 == 0 and g and
//   out are 16-byte aligned) or one f32 a thread a step, 64-bit offsets,
//   rho[n] read through L1 each step. What holds it back: a client loop
//   of a runtime trip count, so a thread has only as many loads in flight
//   as the compiler unrolls.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

enum Path { kGeneral = 0, kWave = 1, kStream = 2 };  // grad_agg_plan's

constexpr int kMaxClients = 16;   // wave and stream: N a template parameter
constexpr int kWaveThreads = 128;
constexpr int kStreamThreads = 256;
constexpr int kStreamLoads = 16;  // stream: N * K units a thread a tile
constexpr int kThreads = 256;     // general

// Blocks of 128 threads an SM can hold when a thread keeps `loads` units
// in registers: 4 registers a unit and 32 for the rest, rounded to the
// allocation granule of 8, out of 65,536 registers (512 a thread of a
// block), and at most 16 blocks (2,048 threads). `__launch_bounds__`
// holds each wave kernel to it; the plan counts on it.
__host__ __device__ constexpr int wave_blocks_per_sm(int loads) {
  return 512 / ((4 * loads + 32 + 7) / 8 * 8) < 16
             ? 512 / ((4 * loads + 32 + 7) / 8 * 8)
             : 16;
}

// stream: units a thread a tile, the most of {4, 2, 1} with N * K <= 16
__host__ __device__ constexpr int stream_units(int n) {
  return n * 4 <= kStreamLoads ? 4 : n * 2 <= kStreamLoads ? 2 : 1;
}

__device__ __forceinline__ float4 axpy(float4 acc, float r, float4 v) {
  acc.x = __fadd_rn(acc.x, __fmul_rn(r, v.x));
  acc.y = __fadd_rn(acc.y, __fmul_rn(r, v.y));
  acc.z = __fadd_rn(acc.z, __fmul_rn(r, v.z));
  acc.w = __fadd_rn(acc.w, __fmul_rn(r, v.w));
  return acc;
}

__device__ __forceinline__ float axpy(float acc, float r, float v) {
  return __fadd_rn(acc, __fmul_rn(r, v));
}

// an L2 policy that evicts these lines first
__device__ __forceinline__ uint64_t evict_first_policy() {
  uint64_t policy;
  asm("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
      : "=l"(policy));
  return policy;
}

// a 16-byte load that allocates no L1 line and is evicted first from L2
__device__ __forceinline__ float4 load_stream(const float4* p,
                                              uint64_t policy) {
  float4 v;
  asm("ld.global.nc.L1::no_allocate.L2::cache_hint.v4.f32 "
      "{%0, %1, %2, %3}, [%4], %5;\n"
      : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
      : "l"(p), "l"(policy));
  return v;
}

template <int N>
__device__ __forceinline__ void load_rho(const float* __restrict__ rho,
                                         float (&r)[N]) {
#pragma unroll
  for (int n = 0; n < N; ++n) r[n] = __ldg(rho + n);
}

// wave path: unit blockIdx.x * 128 + threadIdx.x of every client in one
// trip
template <int N>
__global__ void __launch_bounds__(kWaveThreads, wave_blocks_per_sm(N))
wave_kernel(const float4* __restrict__ g, const float* __restrict__ rho,
            float4* __restrict__ out, int m4) {
  const int u = blockIdx.x * kWaveThreads + threadIdx.x;
  if (u >= m4) return;
  float4 v[N];
#pragma unroll
  for (int n = 0; n < N; ++n) v[n] = __ldg(g + n * m4 + u);
  float r[N];
  load_rho(rho, r);
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int n = 0; n < N; ++n) acc = axpy(acc, r[n], v[n]);
  out[u] = acc;
}

// stream path: tiles of 256 * K units, tile t holding units t * 256 K +
// j * 256 + thread, j < K
template <int N>
__global__ void __launch_bounds__(kStreamThreads, 2)
stream_kernel(const float4* __restrict__ g, const float* __restrict__ rho,
              float4* __restrict__ out, int m4) {
  constexpr int K = stream_units(N);
  constexpr int kTile = kStreamThreads * K;
  const uint64_t policy = evict_first_policy();
  float r[N];
  load_rho(rho, r);
  for (int t0 = blockIdx.x * kTile; t0 < m4; t0 += gridDim.x * kTile) {
    const int base = t0 + threadIdx.x;
    float4 v[N][K];
#pragma unroll
    for (int n = 0; n < N; ++n)
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const int u = base + j * kStreamThreads;
        if (u < m4) v[n][j] = load_stream(g + n * m4 + u, policy);
      }
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int u = base + j * kStreamThreads;
      if (u < m4) {
        float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int n = 0; n < N; ++n) acc = axpy(acc, r[n], v[n][j]);
        __stcs(out + u, acc);
      }
    }
  }
}

// general path, the earlier walk: W = 4 walks float4 units, W = 1 single
// floats; 64-bit offsets; rho[n] through L1 a step (staging rho in shared
// memory first put its round trip and a barrier before the first load of
// g, 0.0004 ms more at cut 2)
template <int W>
__global__ void __launch_bounds__(kThreads)
general_kernel(const float* __restrict__ g_, const float* __restrict__ rho,
               float* __restrict__ out_, int n, long long m) {
  using T = typename std::conditional<W == 4, float4, float>::type;
  const T* __restrict__ g = reinterpret_cast<const T*>(g_);
  T* __restrict__ out = reinterpret_cast<T*>(out_);
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < m;
       i += stride) {
    T acc{};
    for (int k = 0; k < n; ++k)
      acc = axpy(acc, __ldg(rho + k), __ldg(g + k * m + i));
    out[i] = acc;
  }
}

template <int N>
cudaError_t launch_clients(const float4* g, const float* rho, float4* out,
                           int m4, int path, int grid, cudaStream_t s) {
  if (path == kWave) {
    // one unit a thread and no stride: the grid must cover every unit
    if ((long long)grid * kWaveThreads < m4) return cudaErrorInvalidValue;
    wave_kernel<N><<<grid, kWaveThreads, 0, s>>>(g, rho, out, m4);
  } else {
    stream_kernel<N><<<grid, kStreamThreads, 0, s>>>(g, rho, out, m4);
  }
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// out[i] = sum_n rho[n] * g[n, i] on the path of grad_agg_plan: `path`
// (0 general, 1 wave, 2 stream) in `grid` blocks. Returns the CUDA error
// of the launch (0 on success, cudaErrorInvalidValue for a plan this
// source does not hold: a grid of no block, a wave grid that does not
// cover M / 4 units, or the wave or stream path where M % 4 != 0, N is
// not 1..16 or N * M >= 2^31). Launches on `stream` without
// synchronizing.
extern "C" int grad_agg_f32(const float* g, const float* rho, float* out,
                            int n, long long m, int path, int grid,
                            void* stream) {
  if (m <= 0) return 0;
  if (grid < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (path == kGeneral) {
    if (m % 4 == 0 && aligned16(g) && aligned16(out))
      general_kernel<4><<<grid, kThreads, 0, s>>>(g, rho, out, n, m / 4);
    else
      general_kernel<1><<<grid, kThreads, 0, s>>>(g, rho, out, n, m);
    return static_cast<int>(cudaGetLastError());
  }
  if ((path != kWave && path != kStream) || n < 1 || n > kMaxClients ||
      m % 4 != 0 || (long long)n * m >= (1ll << 31) || !aligned16(g) ||
      !aligned16(out))
    return static_cast<int>(cudaErrorInvalidValue);
  const float4* g4 = reinterpret_cast<const float4*>(g);
  float4* o4 = reinterpret_cast<float4*>(out);
  const int m4 = static_cast<int>(m / 4);
  cudaError_t err = cudaErrorInvalidValue;
  switch (n) {
#define GRAD_AGG_CLIENTS(N)                                           \
  case N:                                                             \
    err = launch_clients<N>(g4, rho, o4, m4, path, grid, s);          \
    break;
    GRAD_AGG_CLIENTS(1) GRAD_AGG_CLIENTS(2) GRAD_AGG_CLIENTS(3)
    GRAD_AGG_CLIENTS(4) GRAD_AGG_CLIENTS(5) GRAD_AGG_CLIENTS(6)
    GRAD_AGG_CLIENTS(7) GRAD_AGG_CLIENTS(8) GRAD_AGG_CLIENTS(9)
    GRAD_AGG_CLIENTS(10) GRAD_AGG_CLIENTS(11) GRAD_AGG_CLIENTS(12)
    GRAD_AGG_CLIENTS(13) GRAD_AGG_CLIENTS(14) GRAD_AGG_CLIENTS(15)
    GRAD_AGG_CLIENTS(16)
#undef GRAD_AGG_CLIENTS
  }
  return static_cast<int>(err);
}
