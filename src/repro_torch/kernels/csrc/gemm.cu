// G1: float32-accurate matrix products on Hopper's tensor cores, for the
// model's `linear` (models/blocks.py): the forward Y = X W and both
// backward products dX = dY W^T and dW = X^T dY, each over an optional
// leading batch axis (one weight per client under `vmap`).
//
// Replaces no TPU kernel: on the TPU these products went to XLA's `dot`.
// Without it they run as cuBLAS's and CUTLASS's f32 SIMT GEMMs, which
// cap at the card's 67 TFLOP/s f32 rate (TF32 stays off: the model
// computes in f32).
//
// Precision: 3xTF32, as tf32_mma.cuh takes it for B4 and B5. Each
// operand x is split as hi = tf32(x) and lo = tf32(x - hi), and a.b is
// taken as lo.hi + hi.lo + hi.hi into f32; the dropped lo.lo is ~2^-22
// of each product. No plain TF32 product is taken. The tensor cores'
// own adds truncate, so a tile's sum over all of K on them drifts with
// K (normwise 2.4e-5 against an f64 product at K 3,352, 50x cuBLAS's
// f32). So each k-stage of BK is summed from 0 on the tensor cores,
// its 8 small products first and its 4 hi.hi last, and joins the
// tile's sum in f32 adds that round to nearest: 1.3e-7 to 2.4e-7 from
// K 32 to 4,096, below cuBLAS's f32 from K 256 on.
//
// Bound on an H100: operations. Three TF32 products per product make
// 3 x 2MNK flops at 495 TFLOP/s dense TF32: 165 TFLOP/s of f32-accurate
// work, 2.5x the 67 TFLOP/s SIMT rate.
//
// Design. A persistent grid of one block an SM walks the output tiles
// (batch, BM rows, BN columns) in groups of kGroupM row tiles, so
// neighbouring blocks share their A rows and B columns in L2. Four
// warpgroups a block:
//   - warpgroups 0 and 1 split. Thread 0 keeps TMA loads of raw f32
//     tiles of A (BM x BK) and B (BK x BN) in flight in a ring of
//     kRawStages. The eight warps split each B tile into hi and lo and
//     write both K-major under the 128-byte swizzle into a second ring
//     of kSplitStages, transposing where B lies N-major in memory (the
//     forward's W, the dW product's dY): `wgmma` takes tf32 B from
//     shared memory K-major only. A warp issues all its reads of a
//     stage before its writes, which the compiler cannot reorder across.
//   - warpgroups 2 and 3 multiply, 64 rows of the tile each. A thread
//     reads its A fragment from the raw tile (any layout: the dW
//     product's X^T lies M-major), splits it in registers and issues
//     `wgmma.m64n128k8` with A from registers, twelve a k-stage.
// Nothing goes to device memory but the operands once and C once, and
// nothing transient is allocated. The split costs shared-memory traffic
// instead: B's hi and lo are written once and read by both multiplying
// warpgroups in each of the three products. That traffic, and the
// split ahead of the products, set the pace: ~92 TFLOP/s at granite's
// gate/up forward, 56 % of the bound (PERF.md, G1).
//
// Order of sums: no split-K, no atomics. Each element of C is summed
// over K in one order fixed by K alone (k-stages of BK in turn, twelve
// products a k-stage), so a row gives the same bits batched, unbatched
// or at any M, and two launches give the same bits.
//
// The k-order inside a BK slice: a thread takes its A fragment as two
// 16-byte words a row (physical k 4t..4t+3 and 16+4t..16+4t+3), so in
// k-step s of 8 fragment position p holds physical k 4p + s (p < 4) or
// 16 + 4(p - 4) + s (p >= 4). The split warps write B's physical k to
// the column that the same position reads: col(k) = 8 (k % 4) +
// 4 (k / 16) + (k / 4) % 4. A sum does not care which of its terms a
// k-step takes, as long as A and B agree.
//
// Shapes: any M, N, K and batch; the ragged edges read as 0 (TMA's
// out-of-bounds fill) and are not stored. Row and batch strides must be
// multiples of 16 bytes and the base 16-byte aligned: the wrapper
// (kernels/gemm.py) checks them and raises.

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "tf32_mma.cuh"

namespace {

constexpr int kBM = 128;  // C rows a tile: two multiplying warpgroups
constexpr int kBN = 128;  // C columns a tile: one m64n128 wgmma
constexpr int kBK = 32;   // k a stage: one 128-byte swizzle row of f32
constexpr int kRawStages = 3;
constexpr int kSplitStages = 3;
constexpr int kGroupM = 8;
constexpr int kSplitters = 2;  // warpgroups that split B; two multiply
constexpr int kSplitWarps = 4 * kSplitters;
constexpr int kThreads = 128 * (kSplitters + 2);
constexpr int kRawABytes = kBM * kBK * 4;
constexpr int kRawBBytes = kBN * kBK * 4;
constexpr int kHalfBytes = kBN * kBK * 4;  // B's hi (or lo) of one stage
constexpr int kBarBytes = 8 * (2 * kRawStages + 2 * kSplitStages);
constexpr int kSmemBytes = kSplitStages * 2 * kHalfBytes +
                           kRawStages * (kRawABytes + kRawBBytes) +
                           kBarBytes + 1024;  // 1024: the base's alignment

struct Shape {
  float* c;
  long long ldc, sc;  // C's row and batch strides, in elements
  int M, N, K;        // C (M x N) = A (M x K) B (K x N), for each batch
  int tiles_m, tiles_n, k_steps, tiles;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of f32 element (r, c) of a tile of 128-byte rows under the
// 128-byte swizzle (TMA's CU_TENSOR_MAP_SWIZZLE_128B, wgmma's layout 1):
// 16-byte chunk c / 4 of row r sits at chunk (c / 4) ^ (r % 8)
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return r * 128 + ((((c >> 2) ^ r) & 7) << 4) + (c & 3) * 4;
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// spin until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// one 3-d TMA tile load into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// wgmma's shared-memory descriptor of a K-major tile under the 128-byte
// swizzle: 8-row groups 1024 bytes apart (the leading offset is unused)
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

// keeps the compiler from moving reads or writes of a register that an
// asynchronous wgmma owns (its accumulator or its A fragment) across it
__device__ __forceinline__ void pin(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}
__device__ __forceinline__ void pin(uint32_t& r) {
  asm volatile("" : "+r"(r)::"memory");
}

// d (64 x 128 over the warpgroup) = a (64 x 8, registers) b (8 x 128,
// shared memory, K-major) + (acc ? d : 0), TF32 operands, f32
// accumulator
__device__ __forceinline__ void wgmma_tf32(float (&d)[64],
                                           const uint32_t (&a)[4],
                                           uint64_t desc, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(acc));
}

// the block's loads, in the order the ring consumes them: (tile, k-step)
// of the block's tiles, k-steps innermost
struct Cursor {
  int tile, k;
  __device__ __forceinline__ void next(const Shape& s) {
    if (++k == s.k_steps) {
      k = 0;
      tile += gridDim.x;
    }
  }
};

// (batch, first row, first column) of output tile `tile`
__device__ __forceinline__ void tile_at(const Shape& s, int tile, int& b,
                                        int& m0, int& n0) {
  const int per = s.tiles_m * s.tiles_n;
  b = tile / per;
  int r = tile - b * per;
  const int group = r / (kGroupM * s.tiles_n);
  const int first = group * kGroupM;
  const int rows = min(s.tiles_m - first, kGroupM);
  r -= group * kGroupM * s.tiles_n;
  m0 = (first + r % rows) * kBM;
  n0 = (r / rows) * kBN;
}

// kAK: A lies K-major in memory (rows of C, k contiguous), else M-major;
// kBKm: B lies K-major (columns of C, k contiguous), else N-major
template <bool kAK, bool kBKm>
__global__ void __launch_bounds__(kThreads, 1)
    g1_gemm_kernel(const __grid_constant__ CUtensorMap ta,
                   const __grid_constant__ CUtensorMap tb, Shape s) {
  extern __shared__ uint8_t smem_base[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_base) + 1023) & ~uintptr_t(1023));
  uint8_t* halves = smem;  // stage i: hi at 2 i kHalfBytes, lo after it
  uint8_t* raw = halves + kSplitStages * 2 * kHalfBytes;  // A then B
  const uint32_t bars = smem_u32(raw + kRawStages * (kRawABytes + kRawBBytes));
  // raw_full, raw_empty, split_full, split_empty: one barrier a stage
  auto raw_full = [&](int i) { return bars + 8 * i; };
  auto raw_empty = [&](int i) { return bars + 8 * (kRawStages + i); };
  auto split_full = [&](int i) { return bars + 8 * (2 * kRawStages + i); };
  auto split_empty = [&](int i) {
    return bars + 8 * (2 * kRawStages + kSplitStages + i);
  };
  auto raw_a = [&](int i) { return raw + i * (kRawABytes + kRawBBytes); };
  auto raw_b = [&](int i) { return raw_a(i) + kRawABytes; };

  if (threadIdx.x == 0) {
    for (int i = 0; i < kRawStages; ++i) {
      mbar_init(raw_full(i), 1);
      mbar_init(raw_empty(i), kSplitWarps + 8);  // every warp reads it
    }
    for (int i = 0; i < kSplitStages; ++i) {
      mbar_init(split_full(i), kSplitWarps);
      mbar_init(split_empty(i), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x / 32) & 3, lane = threadIdx.x & 31;
  const int my_tiles =
      s.tiles > static_cast<int>(blockIdx.x)
          ? (s.tiles - blockIdx.x + gridDim.x - 1) / gridDim.x
          : 0;
  const int steps = my_tiles * s.k_steps;

  if (wg < kSplitters) {
    // the launch's 128 registers a thread, rebalanced: 56 x 256 + 200 x
    // 256 = 128 x 512
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n");
    Cursor ld{static_cast<int>(blockIdx.x), 0};
    int issued = 0;
    for (int it = 0; it < steps; ++it) {
      if (threadIdx.x == 0) {  // keep the raw ring full
        const int upto = min(it + kRawStages, steps);
        for (; issued < upto; ++issued, ld.next(s)) {
          const int st = issued % kRawStages;
          mbar_wait(raw_empty(st), ((issued / kRawStages) & 1) ^ 1);
          mbar_expect_tx(raw_full(st), kRawABytes + kRawBBytes);
          int b, m0, n0;
          tile_at(s, ld.tile, b, m0, n0);
          const int k0 = ld.k * kBK;
          if (kAK) {
            tma_load(raw_a(st), &ta, raw_full(st), k0, m0, b);
          } else {
#pragma unroll
            for (int i = 0; i < kBM / 32; ++i)
              tma_load(raw_a(st) + 4096 * i, &ta, raw_full(st), m0 + 32 * i,
                       k0, b);
          }
          if (kBKm) {
            tma_load(raw_b(st), &tb, raw_full(st), k0, n0, b);
          } else {
#pragma unroll
            for (int i = 0; i < kBN / 32; ++i)
              tma_load(raw_b(st) + 4096 * i, &tb, raw_full(st), n0 + 32 * i,
                       k0, b);
          }
        }
      }
      const int st = it % kRawStages, sp = it % kSplitStages;
      mbar_wait(raw_full(st), (it / kRawStages) & 1);
      mbar_wait(split_empty(sp), ((it / kSplitStages) & 1) ^ 1);
      const uint8_t* rb = raw_b(st);
      uint8_t* hi = halves + sp * 2 * kHalfBytes;
      uint8_t* lo = hi + kHalfBytes;
      // kBN / 4 units a stage, kUnits a warp; a lane's share of a unit is
      // four k of column n (k = 16 h + q0 + 4 i), written as one 16-byte
      // word of hi and one of lo at columns 8 q0 + 4 h .. + 3 of row n.
      // Lanes are laid out so that every read and write is free of bank
      // conflicts; all of a warp's reads are issued before its writes.
      constexpr int kUnits = kBN / 4 / kSplitWarps;
      const int sw = threadIdx.x / 32;  // the splitting warp
      float v[kUnits][4];
#pragma unroll
      for (int j = 0; j < kUnits; ++j) {
        const int u = kSplitWarps * j + sw;
        if (kBKm) {  // rows n of 128 bytes: a lane a (n, q0), 8 rows a unit
          const int n = (u >> 1) * 8 + (lane >> 2), q0 = lane & 3, h = u & 1;
#pragma unroll
          for (int i = 0; i < 4; ++i)
            v[j][i] = *reinterpret_cast<const float*>(
                rb + swz(n, 16 * h + q0 + 4 * i));
        } else {  // boxes of 32 k x 32 n: a lane a column n
          const int q0 = (u >> 1) & 3, h = u & 1;
#pragma unroll
          for (int i = 0; i < 4; ++i)
            v[j][i] = *reinterpret_cast<const float*>(
                rb + 4096 * (u >> 3) + swz(16 * h + q0 + 4 * i, lane));
        }
      }
#pragma unroll
      for (int j = 0; j < kUnits; ++j) {
        const int u = kSplitWarps * j + sw;
        const int n = kBKm ? (u >> 1) * 8 + (lane >> 2) : (u >> 3) * 32 + lane;
        const int q0 = kBKm ? lane & 3 : (u >> 1) & 3, h = u & 1;
        uint4 whi, wlo;
        split(v[j][0], whi.x, wlo.x);
        split(v[j][1], whi.y, wlo.y);
        split(v[j][2], whi.z, wlo.z);
        split(v[j][3], whi.w, wlo.w);
        const uint32_t off = swz(n, 8 * q0 + 4 * h);
        *reinterpret_cast<uint4*>(hi + off) = whi;
        *reinterpret_cast<uint4*>(lo + off) = wlo;
      }
      // the writes are read by wgmma, through the async proxy
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncwarp();
      if (lane == 0) {
        mbar_arrive(split_full(sp));
        mbar_arrive(raw_empty(st));
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 200;\n");
    const int g = lane >> 2, t = lane & 3;
    const int r0 = 64 * (wg - kSplitters) + 16 * warp + g;  // and r0 + 8
    float acc[64], part[64];
    int it = 0;
    for (int tile = blockIdx.x; tile < s.tiles; tile += gridDim.x) {
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = 0.f;
      for (int kk = 0; kk < s.k_steps; ++kk, ++it) {
        const int st = it % kRawStages, sp = it % kSplitStages;
        mbar_wait(raw_full(st), (it / kRawStages) & 1);
        const uint8_t* ra = raw_a(st);
        uint32_t ahi[4][4], alo[4][4];
        if (kAK) {
          const float4 x00 = *reinterpret_cast<const float4*>(ra + swz(r0, 4 * t));
          const float4 x01 =
              *reinterpret_cast<const float4*>(ra + swz(r0, 16 + 4 * t));
          const float4 x10 =
              *reinterpret_cast<const float4*>(ra + swz(r0 + 8, 4 * t));
          const float4 x11 =
              *reinterpret_cast<const float4*>(ra + swz(r0 + 8, 16 + 4 * t));
          const float f00[4] = {x00.x, x00.y, x00.z, x00.w};
          const float f01[4] = {x01.x, x01.y, x01.z, x01.w};
          const float f10[4] = {x10.x, x10.y, x10.z, x10.w};
          const float f11[4] = {x11.x, x11.y, x11.z, x11.w};
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            split(f00[q], ahi[q][0], alo[q][0]);
            split(f10[q], ahi[q][1], alo[q][1]);
            split(f01[q], ahi[q][2], alo[q][2]);
            split(f11[q], ahi[q][3], alo[q][3]);
          }
        } else {
          auto at = [&](int r, int k) {
            return *reinterpret_cast<const float*>(ra + 4096 * (r >> 5) +
                                                   swz(k, r & 31));
          };
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            split(at(r0, 4 * t + q), ahi[q][0], alo[q][0]);
            split(at(r0 + 8, 4 * t + q), ahi[q][1], alo[q][1]);
            split(at(r0, 16 + 4 * t + q), ahi[q][2], alo[q][2]);
            split(at(r0 + 8, 16 + 4 * t + q), ahi[q][3], alo[q][3]);
          }
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(raw_empty(st));
        mbar_wait(split_full(sp), (it / kSplitStages) & 1);
        __syncwarp();
        const uint32_t hi = smem_u32(halves + sp * 2 * kHalfBytes);
        const uint32_t lo = hi + kHalfBytes;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            pin(ahi[q][i]);
            pin(alo[q][i]);
          }
        }
#pragma unroll
        for (int i = 0; i < 64; ++i) pin(part[i]);
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          wgmma_tf32(part, alo[q], desc_sw128(hi + 32 * q), q);
          wgmma_tf32(part, ahi[q], desc_sw128(lo + 32 * q), 1);
        }
#pragma unroll
        for (int q = 0; q < 4; ++q)
          wgmma_tf32(part, ahi[q], desc_sw128(hi + 32 * q), 1);
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
        for (int i = 0; i < 64; ++i) pin(part[i]);
        __syncwarp();
        if (lane == 0) mbar_arrive(split_empty(sp));
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[i] += part[i];
      }
      int b, m0, n0;
      tile_at(s, tile, b, m0, n0);
      float* cb = s.c + b * s.sc;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + r0 + 8 * h;
        if (row >= s.M) continue;
        float* crow = cb + row * s.ldc;
#pragma unroll
        for (int j = 0; j < kBN / 8; ++j) {
          const int col = n0 + 8 * j + 2 * t;
          const float x = acc[4 * j + 2 * h], y = acc[4 * j + 2 * h + 1];
          if (col + 1 < s.N) {
            *reinterpret_cast<float2*>(crow + col) = make_float2(x, y);
          } else if (col < s.N) {
            crow[col] = x;
          }
        }
      }
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a (batch, outer, inner) f32 tensor with the given row and batch strides
// (elements), read in boxes of (box_inner, box_outer) under the 128-byte
// swizzle; 0 on success
int make_map(CUtensorMap* map, const float* base, long long inner,
             long long outer, long long batch, long long ld, long long sb,
             int box_inner, int box_outer) {
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return -1;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(inner),
                              static_cast<cuuint64_t>(outer),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(ld) * 4,
                                 static_cast<cuuint64_t>(sb) * 4};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(box_inner),
                             static_cast<cuuint32_t>(box_outer), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
                         const_cast<float*>(base), dims, strides, box, elem,
                         CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -1000 - static_cast<int>(r);
}

template <bool kAK, bool kBKm>
int launch(const float* a, const float* b, float* c, int batch, int M, int N,
           int K, long long lda, long long ldb, long long ldc, long long sa,
           long long sb, long long sc, int sms, cudaStream_t stream) {
  static bool ready = false;
  if (!ready) {
    const cudaError_t e = cudaFuncSetAttribute(
        g1_gemm_kernel<kAK, kBKm>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    ready = true;
  }
  CUtensorMap ta, tb;
  int err = kAK ? make_map(&ta, a, K, M, batch, lda, sa, kBK, kBM)
                : make_map(&ta, a, M, K, batch, lda, sa, 32, kBK);
  if (err) return err;
  err = kBKm ? make_map(&tb, b, K, N, batch, ldb, sb, kBK, kBN)
             : make_map(&tb, b, N, K, batch, ldb, sb, 32, kBK);
  if (err) return err;
  Shape s;
  s.c = c;
  s.ldc = ldc;
  s.sc = sc;
  s.M = M;
  s.N = N;
  s.K = K;
  s.tiles_m = (M + kBM - 1) / kBM;
  s.tiles_n = (N + kBN - 1) / kBN;
  s.k_steps = (K + kBK - 1) / kBK;
  s.tiles = batch * s.tiles_m * s.tiles_n;
  const int grid = s.tiles < sms ? s.tiles : sms;
  g1_gemm_kernel<kAK, kBKm><<<grid, kThreads, kSmemBytes, stream>>>(ta, tb, s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C (batch, M, N) = A B over each batch, 3xTF32. a_kmajor: A is stored
// (batch, M, K), else (batch, K, M); b_kmajor: B is stored (batch, N, K),
// else (batch, K, N); C is (batch, M, N). Strides in elements: lda, ldb,
// ldc of a stored row, sa, sb, sc of a batch. M, N, K >= 1. Returns 0 or
// a CUDA error code; -1 when the driver has no cuTensorMapEncodeTiled,
// -1000 - r when it refuses a tensor map with CUresult r.
extern "C" int g1_gemm_f32(int a_kmajor, int b_kmajor, const float* a,
                           const float* b, float* c, int batch, int M, int N,
                           int K, long long lda, long long ldb, long long ldc,
                           long long sa, long long sb, long long sc, int sms,
                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a_kmajor && !b_kmajor)
    return launch<true, false>(a, b, c, batch, M, N, K, lda, ldb, ldc, sa, sb,
                               sc, sms, st);
  if (a_kmajor && b_kmajor)
    return launch<true, true>(a, b, c, batch, M, N, K, lda, ldb, ldc, sa, sb,
                              sc, sms, st);
  if (!a_kmajor && !b_kmajor)
    return launch<false, false>(a, b, c, batch, M, N, K, lda, ldb, ldc, sa,
                                sb, sc, sms, st);
  return static_cast<int>(cudaErrorInvalidValue);  // no product takes it
}

extern "C" long long g1_gemm_smem_bytes() { return kSmemBytes; }
