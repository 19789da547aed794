// Cut-layer int8/int4 codec for Hopper (sm_90a): quantize+pack and
// dequantize+aggregate.
//
// Replaces the two TPU kernels of src/repro/kernels/quantize.py:
//
// * `quantize_pack` (Pallas body `_quantize_kernel`, hash `hash_uniform`):
//     g       (N, T, D)          f32
//     q       (N, T, D*bits/8)   int8; int4 packs pairs, even d in the
//                                low nibble
//     scales  (N, T/bt, D/bd)    f32, one per (client, bt x bd tile)
//   scale = absmax * f32(1/qmax), or 1 where the tile is all zero;
//   q = clamp(floor(g / scale + u), -qmax, qmax), u from a uint32 counter
//   hash of (n, t, d, seed) (stochastic) or 0.5 (nearest).
//   The entry point generalizes the seed: with `seeds` null every client
//   hashes (n, t, d, seed), which is the TPU kernel; with `seeds` given,
//   client n hashes (0, t, d, seeds[n]). The second form is the
//   simulator's per-client channel -- K clients, each encoding its own
//   payload with its own seed, as K separate codec calls would -- in one
//   launch; one seed word cannot express it.
// * `dequant_agg_reduce` (Pallas body `_dequant_agg_kernel`, unpack
//   `_unpack_int4`):
//     out[t, d] = sum_n rho[n] * scale[n, t/bt, d/bd] * q[n, t, d]   f32
//   At N = 1 and rho = 1 this is the codec's decode.
//
// Design. B2: one block per scale tile. The TPU kernel holds an
// (N, bt, bd) slab in VMEM and reduces each client's tile there; here a
// block of 256 threads reads its tile once for the absmax (a strided max,
// then a warp-shuffle and shared-memory reduction) and once more to
// quantize it (the second read hits L1/L2 for the codec's 1 KiB tiles).
// Bit parity with the reference needs IEEE arithmetic in its op order:
// __fmul_rn for the scale, __fdiv_rn and __fadd_rn for g / scale + u, no
// FMA contraction and no fast-math reciprocal. The hash is the
// reference's uint32 arithmetic, native here. For int4 each thread packs
// one pair of neighbours into one byte.
// B3: one thread per output element loops n = 0..N-1, unpacks the nibble
// with sign extension, and accumulates rho[n] * (q * scale) in f32 with
// separate IEEE multiplies and adds, so no per-client tensor is ever
// written.
//
// Bound on this card: memory. Both kernels do a few operations per byte.
// B2 reads g once (4 B/elem) and writes q (1 or 0.5 B/elem) and the
// scales; B3 reads N payloads (1 or 0.5 B/elem each) and writes 4 B/elem.
// For the paper CNN's cut-1 uplink (10 x 200,704 f32) B2 moves 10 MB, a
// bound of about 3 us at 3.35 TB/s.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132 * 16;

__device__ __forceinline__ float hash_uniform(uint32_t n, uint32_t t,
                                              uint32_t d, uint32_t seed) {
  uint32_t h = (n * 0x9E3779B1u) ^ (t * 0x85EBCA77u) ^ (d * 0xC2B2AE3Du) ^
               (seed * 0x27D4EB2Fu);
  h ^= h >> 15;
  h *= 0x2C1B3C6Du;
  h ^= h >> 13;
  h *= 0x297A2D39u;
  h ^= h >> 16;
  return __fmul_rn(static_cast<float>(h >> 8), 1.0f / 16777216.0f);
}

__device__ __forceinline__ int quantize_one(float x, float scale, float u,
                                            float qmax) {
  float v = floorf(__fadd_rn(__fdiv_rn(x, scale), u));
  v = fminf(fmaxf(v, -qmax), qmax);
  return static_cast<int>(v);
}

__device__ float block_max(float v) {
  __shared__ float warp_max[kThreads / 32];
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_max[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kThreads / 32 ? warp_max[lane] : 0.f;
    for (int off = 16; off > 0; off >>= 1)
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
    if (lane == 0) warp_max[0] = v;
  }
  __syncthreads();
  return warp_max[0];
}

__global__ void __launch_bounds__(kThreads)
quantize_kernel(const float* __restrict__ g, int8_t* __restrict__ q,
                float* __restrict__ scales, int T, int D, int bt, int bd,
                int qmax, int pack, int stochastic, uint32_t seed,
                const long long* __restrict__ seeds) {
  const int tiles_t = T / bt, tiles_d = D / bd;
  const long long tile = blockIdx.x;
  const int di = static_cast<int>(tile % tiles_d);
  const int ti = static_cast<int>((tile / tiles_d) % tiles_t);
  const int n = static_cast<int>(tile / ((long long)tiles_d * tiles_t));
  const long long row0 = (long long)n * T + (long long)ti * bt;
  const int d0 = di * bd;
  const int elems = bt * bd;

  float m = 0.f;
  for (int e = threadIdx.x; e < elems; e += blockDim.x) {
    const int r = e / bd, c = e - r * bd;
    m = fmaxf(m, fabsf(__ldg(g + (row0 + r) * D + d0 + c)));
  }
  const float absmax = block_max(m);
  const float inv_qmax = static_cast<float>(1.0 / qmax);
  const float scale = absmax > 0.f ? __fmul_rn(absmax, inv_qmax) : 1.0f;
  if (threadIdx.x == 0) scales[tile] = scale;

  const uint32_t s = seeds ? static_cast<uint32_t>(seeds[n]) : seed;
  const uint32_t hn = seeds ? 0u : static_cast<uint32_t>(n);
  const float fq = static_cast<float>(qmax);
  const int width = pack ? 2 : 1;
  for (int e = threadIdx.x * width; e < elems; e += blockDim.x * width) {
    const int r = e / bd, c = e - r * bd;
    const uint32_t t = static_cast<uint32_t>(ti * bt + r);
    const uint32_t d = static_cast<uint32_t>(d0 + c);
    const long long off = (row0 + r) * D + d0 + c;
    const float u0 = stochastic ? hash_uniform(hn, t, d, s) : 0.5f;
    const int v0 = quantize_one(__ldg(g + off), scale, u0, fq);
    if (!pack) {
      q[off] = static_cast<int8_t>(v0);
    } else {
      const float u1 = stochastic ? hash_uniform(hn, t, d + 1u, s) : 0.5f;
      const int v1 = quantize_one(__ldg(g + off + 1), scale, u1, fq);
      q[off / 2] = static_cast<int8_t>(((v1 & 15) << 4) | (v0 & 15));
    }
  }
}

__global__ void __launch_bounds__(kThreads)
dequant_agg_kernel(const int8_t* __restrict__ q,
                   const float* __restrict__ scales,
                   const float* __restrict__ rho, float* __restrict__ out,
                   int N, int T, int D, int bt, int bd, int pack) {
  const int tiles_t = T / bt, tiles_d = D / bd;
  const int dq = pack ? D / 2 : D;
  const long long total = (long long)T * D;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < total; i += stride) {
    const int t = static_cast<int>(i / D), d = static_cast<int>(i % D);
    const long long tile = (long long)(t / bt) * tiles_d + d / bd;
    float acc = 0.f;
    for (int n = 0; n < N; ++n) {
      const int b = __ldg(q + ((long long)n * T + t) * dq + (pack ? d >> 1 : d));
      int v = b;
      if (pack) {
        v = (d & 1) ? (b >> 4) & 15 : b & 15;
        v = v >= 8 ? v - 16 : v;
      }
      const float s = __ldg(scales + (long long)n * tiles_t * tiles_d + tile);
      const float x = __fmul_rn(static_cast<float>(v), s);
      acc = __fadd_rn(acc, __fmul_rn(__ldg(rho + n), x));
    }
    out[i] = acc;
  }
}

}  // namespace

// Each entry point returns the CUDA error of its launch (0 on success)
// and launches on `stream` without synchronizing. Shapes are checked by
// the Python wrapper: T % bt == 0, D % bd == 0, bd even for int4.
extern "C" int quantize_pack_f32(const float* g, int8_t* q, float* scales,
                                 int N, int T, int D, int bt, int bd,
                                 int bits, int stochastic, unsigned seed,
                                 const long long* seeds, void* stream) {
  const long long tiles = (long long)N * (T / bt) * (D / bd);
  if (tiles == 0) return 0;
  const int qmax = (1 << (bits - 1)) - 1;
  quantize_kernel<<<(unsigned)tiles, kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      g, q, scales, T, D, bt, bd, qmax, bits == 4, stochastic, seed, seeds);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dequant_agg_f32(const int8_t* q, const float* scales,
                               const float* rho, float* out, int N, int T,
                               int D, int bt, int bd, int bits,
                               void* stream) {
  const long long total = (long long)T * D;
  if (total == 0) return 0;
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  dequant_agg_kernel<<<(unsigned)blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      q, scales, rho, out, N, T, D, bt, bd, bits == 4);
  return static_cast<int>(cudaGetLastError());
}
