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
// Bound on this card: memory. B2 reads g once (4 B/elem) and writes q
// (1 or 0.5 B/elem) and the scales; B3 reads N payloads (1 or 0.5 B/elem
// each) and writes 4 B/elem. The paper CNN's cut-2 uplink (10 x 100,352
// f32) is 5 MB for B2, 1.5 us at 3.35 TB/s, so at the main path's shapes
// both kernels are latency-bound: what counts is how few dependent trips
// to memory a thread makes and that one wave covers the card. At an LM
// boundary (8 x 2048 x 4096) B2's ~25 integer and float operations an
// element come close to its 0.10 ms byte bound.
//
// Design. The host plans the path from shapes and alignment alone
// (`quantize_plan`, `dequant_plan` in ../quantize.py) and passes it in.
// Everything a thread touches moves in 16-byte units of 4 f32 (a float4);
// a thread walks its units with a row and a column that it steps by a
// fixed stride (`Walk`), so no element pays an integer division.
// B2, warp path (a tile of at most 1,024 elements, bd % 4 == 0, g 16-byte
//   aligned): one warp a tile, 8 tiles a block. Lane l holds the tile's
//   units l, l + 32, ... (at most 8, 32 values) in registers, read once
//   with coalesced float4 loads; the absmax is a warp-shuffle max, with no
//   shared memory and no block barrier; each unit's 4 codes go out in one
//   4-byte store (int8) or one 2-byte store (int4), every store of a warp
//   one contiguous run. The codec's 1 x 256 tile is 2 units a lane, and
//   the cut-2 uplink is 3,920 warps in 490 blocks: one wave on 132 SMs.
// B2, cluster path (a tile of up to 8 x 256 x 32 = 65,536 elements, the
//   same width rules): a tile spread over a thread block cluster of C <= 8
//   blocks of 256 threads, each thread holding at most 8 units. Each block
//   reduces its share (shuffles, then one shared-memory step), the cluster
//   combines its C block maxima through distributed shared memory, and
//   each block quantizes its units from registers. The cluster barrier is
//   split: a block arrives once it has read its peers' maxima and waits
//   only before it exits, so the quantize overlaps the barrier.
// B2, general path (bd or the pointer not fit for float4, or a tile above
//   65,536 elements): one block a tile walks it twice in scalar steps (for
//   the max, then to quantize; the second read mostly hits L2).
// B3, vector path (bd % 16 == 0, q 16-byte aligned): a thread owns 16
//   consecutive outputs of one row, inside one tile column. It works out
//   its row, column and tile once, then per client loads its 16 codes in
//   one 16-byte (int8) or 8-byte (int4) load and one scale, accumulates in
//   registers, and writes four float4 stores. The cut-2 decode is 62,720
//   threads in 245 blocks.
// B3, general path: a warp a segment of up to 1,024 columns of one row;
//   per-element indices are 32-bit, the tile column is stepped, not
//   divided.
//
// Bit parity with the reference (the plain versions in ../quantize.py and
// the TPU kernel) needs IEEE arithmetic in its op order: the scale as
// __fmul_rn(absmax, f32(1/qmax)); g / scale + u as __fadd_rn(__fdiv_rn())
// with no FMA contraction and no fast reciprocal; B3's sum as
// __fadd_rn(acc, __fmul_rn(rho[n], __fmul_rn(q, s))) over n = 0..N-1 in
// order. A max is exact in any order, so the absmax reduction tree is
// free. floor() and the float-to-int conversion are one round-down add of
// 1.5 * 2^23 (`code_bits`), exact for every value, and the hash terms that
// do not depend on d are hoisted out of the element loop.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 8;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kSegment = 1024;  // B3 general path: columns a warp

// the plan's path codes; kVector is B3's
enum Path { kGeneral = 0, kWarp = 1, kCluster = 2, kVector = 1 };

// xxhash/murmur-style odd multipliers of repro.kernels.quantize.hash_uniform
constexpr uint32_t kN = 0x9E3779B1u, kT = 0x85EBCA77u, kD = 0xC2B2AE3Du,
                   kS = 0x27D4EB2Fu;

// the terms of the hash that do not depend on d
__device__ __forceinline__ uint32_t row_key(uint32_t n, uint32_t t,
                                            uint32_t seed) {
  return (n * kN) ^ (t * kT) ^ (seed * kS);
}

__device__ __forceinline__ float hash_uniform(uint32_t key, uint32_t d) {
  uint32_t h = key ^ (d * kD);
  h ^= h >> 15;
  h *= 0x2C1B3C6Du;
  h ^= h >> 13;
  h *= 0x297A2D39u;
  h ^= h >> 16;
  return __fmul_rn(static_cast<float>(h >> 8), 1.0f / 16777216.0f);
}

// 1.5 * 2^23: in [2^23, 2^24) floats are the integers, so rounding
// x + kMagic down gives kMagic + floor(x) exactly for |x| <= 2^22, and
// the low bits of that float are floor(x) in two's complement. Clamped
// to kMagic -/+ qmax the low byte (int8) or nibble (int4) is the code.
// Larger |x| (a scale that underflowed) clamps as floor() would.
constexpr float kMagic = 12582912.0f;

__device__ __forceinline__ uint32_t code_bits(float x, float scale, float u,
                                              float fq) {
  float v = __fadd_rd(__fadd_rn(__fdiv_rn(x, scale), u), kMagic);
  v = fminf(fmaxf(v, kMagic - fq), kMagic + fq);
  return __float_as_uint(v);
}

__device__ __forceinline__ float tile_scale(float absmax, float inv_qmax) {
  return absmax > 0.f ? __fmul_rn(absmax, inv_qmax) : 1.0f;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

__device__ __forceinline__ float abs_max4(float m, float4 v) {
  return fmaxf(fmaxf(m, fmaxf(fabsf(v.x), fabsf(v.y))),
               fmaxf(fabsf(v.z), fabsf(v.w)));
}

// Row and column of the items first, first + stride, ... of a tile whose
// rows hold w items: one division a thread, then a step with no division.
struct Walk {
  int r, c, dr, dc, w;
  __device__ Walk(int first, int stride, int w_)
      : r(first / w_), c(first % w_), dr(stride / w_), dc(stride % w_),
        w(w_) {}
  __device__ __forceinline__ void next() {
    c += dc;
    r += dr;
    if (c >= w) {
      c -= w;
      ++r;
    }
  }
};

struct QuantArgs {
  const float* g;
  int8_t* q;
  float* scales;
  const long long* seeds;  // null: client n hashes (n, t, d, seed)
  int T, D, bt, bd, tiles_t, tiles_d;
  unsigned tiles;
  float fq, inv_qmax;
  uint32_t seed;
  int stochastic;
};

struct Tile {
  long long base;  // element offset of the tile's first element in g
  int t0, d0;
  uint32_t hn, seed;
};

__device__ __forceinline__ Tile tile_at(const QuantArgs& a, unsigned tile) {
  const unsigned di = tile % a.tiles_d, rest = tile / a.tiles_d;
  const unsigned ti = rest % a.tiles_t, n = rest / a.tiles_t;
  Tile o;
  o.t0 = ti * a.bt;
  o.d0 = di * a.bd;
  o.base = ((long long)n * a.T + o.t0) * a.D + o.d0;
  o.seed = a.seeds ? static_cast<uint32_t>(a.seeds[n]) : a.seed;
  o.hn = a.seeds ? 0u : n;
  return o;
}

// Quantize the 4 values of the unit at (row r, unit column c) of tile o
// and store their codes.
template <bool kPack>
__device__ __forceinline__ void quantize_unit(const QuantArgs& a,
                                              const Tile& o, int r, int c,
                                              float4 v, float scale) {
  const long long off = o.base + (long long)r * a.D + 4 * c;
  const uint32_t key = row_key(o.hn, o.t0 + r, o.seed);
  const uint32_t d = o.d0 + 4 * c;
  const float x[4] = {v.x, v.y, v.z, v.w};
  uint32_t b[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    b[j] = code_bits(x[j], scale, a.stochastic ? hash_uniform(key, d + j)
                                               : 0.5f, a.fq);
  if (!kPack) {
    *reinterpret_cast<uint32_t*>(a.q + off) =
        (b[0] & 255u) | (b[1] & 255u) << 8 | (b[2] & 255u) << 16 |
        b[3] << 24;
  } else {
    *reinterpret_cast<uint16_t*>(a.q + off / 2) = static_cast<uint16_t>(
        (b[0] & 15u) | (b[1] & 15u) << 4 | (b[2] & 15u) << 8 |
        (b[3] & 15u) << 12);
  }
}

__device__ __forceinline__ float4 load_unit(const QuantArgs& a,
                                            const Tile& o, int r, int c) {
  return __ldg(reinterpret_cast<const float4*>(
      a.g + o.base + (long long)r * a.D + 4 * c));
}

// K: units a lane, the power of two at or above the tile's units / 32
template <int K, bool kPack>
__global__ void __launch_bounds__(kThreads)
quantize_warp_kernel(QuantArgs a) {
  const int lane = threadIdx.x & 31;
  const unsigned tile = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (tile >= a.tiles) return;  // the whole warp
  const Tile o = tile_at(a, tile);
  const int w = a.bd >> 2;
  float4 v[K];
  float m = 0.f;
  Walk it(lane, 32, w);
#pragma unroll
  for (int k = 0; k < K; ++k, it.next()) {
    v[k] = it.r < a.bt ? load_unit(a, o, it.r, it.c)
                       : make_float4(0.f, 0.f, 0.f, 0.f);
    m = abs_max4(m, v[k]);
  }
  const float scale = tile_scale(warp_max(m), a.inv_qmax);
  if (lane == 0) a.scales[tile] = scale;
  Walk jt(lane, 32, w);
#pragma unroll
  for (int k = 0; k < K; ++k, jt.next())
    if (jt.r < a.bt) quantize_unit<kPack>(a, o, jt.r, jt.c, v[k], scale);
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// One tile a cluster of C blocks (C = 1 launches without a cluster).
// K: units a thread, the power of two at or above units / (C * 256).
template <int K, bool kPack>
__global__ void __launch_bounds__(kThreads)
quantize_cluster_kernel(QuantArgs a) {
  __shared__ float warp_maxes[kWarps];
  __shared__ float block_max, tile_max;
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned tile = blockIdx.x / C;
  const Tile o = tile_at(a, tile);
  const int w = a.bd >> 2;
  const int first = rank * kThreads + threadIdx.x, stride = C * kThreads;

  float4 v[K];
  float m = 0.f;
  Walk it(first, stride, w);
#pragma unroll
  for (int k = 0; k < K; ++k, it.next()) {
    v[k] = it.r < a.bt ? load_unit(a, o, it.r, it.c)
                       : make_float4(0.f, 0.f, 0.f, 0.f);
    m = abs_max4(m, v[k]);
  }
  m = warp_max(m);
  if (lane == 0) warp_maxes[warp] = m;
  __syncthreads();
  if (warp == 0) {
    m = warp_max(lane < kWarps ? warp_maxes[lane] : 0.f);
    if (lane == 0) block_max = m;
  }
  if (C > 1) {
    cluster.sync();  // every rank's block_max is written and visible
    if (warp == 0) {
      m = warp_max(lane < C ? *cluster.map_shared_rank(&block_max, lane)
                            : 0.f);
      if (lane == 0) tile_max = m;
    }
    cluster_arrive();  // this block is done reading its peers
  } else if (threadIdx.x == 0) {
    tile_max = block_max;
  }
  __syncthreads();
  const float scale = tile_scale(tile_max, a.inv_qmax);
  if (rank == 0 && threadIdx.x == 0) a.scales[tile] = scale;

  Walk jt(first, stride, w);
#pragma unroll
  for (int k = 0; k < K; ++k, jt.next())
    if (jt.r < a.bt) quantize_unit<kPack>(a, o, jt.r, jt.c, v[k], scale);
  if (C > 1) cluster_wait();  // no block exits while a peer may read it
}

// One block a tile, scalar steps of 1 element (int8) or a pair (int4).
template <bool kPack>
__global__ void __launch_bounds__(kThreads)
quantize_general_kernel(QuantArgs a) {
  __shared__ float warp_maxes[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned tile = blockIdx.x;
  const Tile o = tile_at(a, tile);
  constexpr int width = kPack ? 2 : 1;
  const int first = threadIdx.x * width, stride = kThreads * width;

  float m = 0.f;
  for (Walk it(first, stride, a.bd); it.r < a.bt; it.next()) {
    const float* p = a.g + o.base + (long long)it.r * a.D + it.c;
    m = fmaxf(m, fabsf(__ldg(p)));
    if (kPack) m = fmaxf(m, fabsf(__ldg(p + 1)));
  }
  m = warp_max(m);
  if (lane == 0) warp_maxes[warp] = m;
  __syncthreads();
  m = 0.f;
#pragma unroll
  for (int i = 0; i < kWarps; ++i) m = fmaxf(m, warp_maxes[i]);
  const float scale = tile_scale(m, a.inv_qmax);
  if (threadIdx.x == 0) a.scales[tile] = scale;

  for (Walk it(first, stride, a.bd); it.r < a.bt; it.next()) {
    const long long off = o.base + (long long)it.r * a.D + it.c;
    const uint32_t key = row_key(o.hn, o.t0 + it.r, o.seed);
    const uint32_t d = o.d0 + it.c;
    const uint32_t b0 = code_bits(
        __ldg(a.g + off), scale, a.stochastic ? hash_uniform(key, d) : 0.5f,
        a.fq);
    if (!kPack) {
      a.q[off] = static_cast<int8_t>(b0 & 255u);
    } else {
      const uint32_t b1 = code_bits(
          __ldg(a.g + off + 1), scale,
          a.stochastic ? hash_uniform(key, d + 1) : 0.5f, a.fq);
      a.q[off / 2] = static_cast<int8_t>((b0 & 15u) | (b1 & 15u) << 4);
    }
  }
}

typedef void (*QuantKernel)(QuantArgs);

template <bool kPack>
QuantKernel warp_kernel(int units) {
  switch (units) {
    case 1: return quantize_warp_kernel<1, kPack>;
    case 2: return quantize_warp_kernel<2, kPack>;
    case 4: return quantize_warp_kernel<4, kPack>;
    case 8: return quantize_warp_kernel<8, kPack>;
    default: return nullptr;
  }
}

template <bool kPack>
QuantKernel cluster_kernel(int units) {
  switch (units) {
    case 1: return quantize_cluster_kernel<1, kPack>;
    case 2: return quantize_cluster_kernel<2, kPack>;
    case 4: return quantize_cluster_kernel<4, kPack>;
    case 8: return quantize_cluster_kernel<8, kPack>;
    default: return nullptr;
  }
}

template <bool kPack>
cudaError_t launch_quantize(const QuantArgs& a, int path, unsigned grid,
                            int cluster, int units, cudaStream_t stream) {
  QuantKernel fn = nullptr;
  switch (path) {
    case kGeneral: fn = quantize_general_kernel<kPack>; break;
    case kWarp: fn = warp_kernel<kPack>(units); break;
    case kCluster: fn = cluster_kernel<kPack>(units); break;
  }
  if (fn == nullptr || cluster < 1 || cluster > kMaxCluster ||
      (path != kCluster && cluster != 1))
    return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  cudaError_t err = cudaLaunchKernelEx(&cfg, fn, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

struct DequantArgs {
  const int8_t* q;
  const float* scales;
  const float* rho;
  float* out;
  int N, T, D, bt, bd, tiles_t, tiles_d;
};

// code e (0..7) of a word of int4 pairs, or byte e (0..3) of int8 codes,
// sign-extended
__device__ __forceinline__ int nibble(uint32_t x, int e) {
  return static_cast<int>(x << (28 - 4 * e)) >> 28;
}

__device__ __forceinline__ int byte(uint32_t x, int e) {
  return static_cast<int>(x << (24 - 8 * e)) >> 24;
}

// 16 outputs a thread: out[t, d0 .. d0 + 15], one tile column
template <bool kPack>
__global__ void __launch_bounds__(kThreads)
dequant_vector_kernel(DequantArgs a) {
  const unsigned groups = a.D / 16;
  const unsigned i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= (unsigned)a.T * groups) return;
  const int t = i / groups;
  const int d0 = (i - t * groups) * 16;
  const long long plane = (long long)a.tiles_t * a.tiles_d;
  const float* s_n = a.scales + (t / a.bt) * a.tiles_d + d0 / a.bd;
  const long long dq = kPack ? a.D / 2 : a.D;
  const int8_t* q_n = a.q + (long long)t * dq + (kPack ? d0 / 2 : d0);
  const long long client = (long long)a.T * dq;

  float acc[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) acc[j] = 0.f;
  for (int n = 0; n < a.N; ++n, s_n += plane, q_n += client) {
    const float s = __ldg(s_n), r = __ldg(a.rho + n);
    uint32_t w[4];
    if (!kPack) {
      const int4 raw = __ldg(reinterpret_cast<const int4*>(q_n));
      w[0] = raw.x, w[1] = raw.y, w[2] = raw.z, w[3] = raw.w;
    } else {
      const int2 raw = __ldg(reinterpret_cast<const int2*>(q_n));
      w[0] = raw.x, w[1] = raw.y;
    }
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int v = kPack ? nibble(w[j >> 3], j & 7) : byte(w[j >> 2], j & 3);
      acc[j] = __fadd_rn(acc[j],
                         __fmul_rn(r, __fmul_rn(static_cast<float>(v), s)));
    }
  }
  float4* o = reinterpret_cast<float4*>(a.out + (long long)t * a.D + d0);
#pragma unroll
  for (int j = 0; j < 4; ++j)
    o[j] = make_float4(acc[4 * j], acc[4 * j + 1], acc[4 * j + 2],
                       acc[4 * j + 3]);
}

// A warp a segment of up to kSegment columns of one row, lane-strided.
template <bool kPack>
__global__ void __launch_bounds__(kThreads)
dequant_general_kernel(DequantArgs a) {
  const int lane = threadIdx.x & 31;
  const unsigned segs = (a.D + kSegment - 1) / kSegment;
  const unsigned s = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (s >= (unsigned)a.T * segs) return;
  const int t = s / segs;
  const int d_begin = (s - t * segs) * kSegment;
  const int d_end = min(a.D, d_begin + kSegment);
  const long long plane = (long long)a.tiles_t * a.tiles_d;
  const float* s_row = a.scales + (t / a.bt) * a.tiles_d;
  const long long dq = kPack ? a.D / 2 : a.D;
  const int8_t* q_row = a.q + (long long)t * dq;
  const long long client = (long long)a.T * dq;
  float* out_row = a.out + (long long)t * a.D;

  Walk col(d_begin + lane, 32, a.bd);  // r: the tile column, c: within it
  for (int d = d_begin + lane; d < d_end; d += 32, col.next()) {
    const float* s_n = s_row + col.r;
    const int8_t* q_n = q_row + (kPack ? d >> 1 : d);
    float acc = 0.f;
    for (int n = 0; n < a.N; ++n, s_n += plane, q_n += client) {
      int v = __ldg(q_n);
      if (kPack) v = nibble(static_cast<uint32_t>(v), d & 1);
      acc = __fadd_rn(acc, __fmul_rn(__ldg(a.rho + n),
                                     __fmul_rn(static_cast<float>(v),
                                               __ldg(s_n))));
    }
    out_row[d] = acc;
  }
}

}  // namespace

// Each entry point returns the CUDA error of its launch (0 on success)
// and launches on `stream` without synchronizing. The Python wrapper
// checks shapes, types, contiguity and alignment (T % bt == 0, D % bd ==
// 0, bd even for int4) and plans the path, the grid, the cluster size and
// the units a thread (`quantize_plan`, `dequant_plan`).
extern "C" int quantize_pack_f32(const float* g, int8_t* q, float* scales,
                                 int N, int T, int D, int bt, int bd,
                                 int bits, int stochastic, unsigned seed,
                                 const long long* seeds, int path,
                                 unsigned grid, int cluster, int units,
                                 void* stream) {
  const long long tiles = (long long)N * (T / bt) * (D / bd);
  if (tiles == 0) return 0;
  const int qmax = (1 << (bits - 1)) - 1;
  QuantArgs a;
  a.g = g, a.q = q, a.scales = scales, a.seeds = seeds;
  a.T = T, a.D = D, a.bt = bt, a.bd = bd, a.tiles_t = T / bt,
  a.tiles_d = D / bd;
  a.tiles = static_cast<unsigned>(tiles);
  a.fq = static_cast<float>(qmax);
  a.inv_qmax = static_cast<float>(1.0 / qmax);
  a.seed = seed, a.stochastic = stochastic;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      bits == 4 ? launch_quantize<true>(a, path, grid, cluster, units, s)
                : launch_quantize<false>(a, path, grid, cluster, units, s));
}

extern "C" int dequant_agg_f32(const int8_t* q, const float* scales,
                               const float* rho, float* out, int N, int T,
                               int D, int bt, int bd, int bits, int path,
                               unsigned grid, void* stream) {
  if ((long long)T * D == 0) return 0;
  DequantArgs a;
  a.q = q, a.scales = scales, a.rho = rho, a.out = out;
  a.N = N, a.T = T, a.D = D, a.bt = bt, a.bd = bd, a.tiles_t = T / bt,
  a.tiles_d = D / bd;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool pack = bits == 4;
  if (path == kVector) {
    if (pack)
      dequant_vector_kernel<true><<<grid, kThreads, 0, s>>>(a);
    else
      dequant_vector_kernel<false><<<grid, kThreads, 0, s>>>(a);
  } else if (path == kGeneral) {
    if (pack)
      dequant_general_kernel<true><<<grid, kThreads, 0, s>>>(a);
    else
      dequant_general_kernel<false><<<grid, kThreads, 0, s>>>(a);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
