// Float32-accurate products on Hopper's tensor cores (3xTF32 on
// mma.sync m16n8k8) and cp.async staging: the helpers that the flash
// attention kernel (B4) and the SSD intra-chunk kernel (B5) share.
//
// Precision. One TF32 product keeps 10 mantissa bits. So each operand x
// is split as hi = tf32(x) and lo = tf32(x - hi), both rounded as
// `cvt.rna.tf32.f32` rounds (to nearest, ties away from zero), and a.b is
// taken as lo.hi + hi.lo + hi.hi, small terms first, all into the f32
// accumulator; the dropped lo.lo term is ~2^-22 of the product, so the
// result is f32-accurate. The rounding is done in two integer operations:
// `cvt` runs on the conversion pipe at a quarter of their rate.
//
// Fragments of m16n8k8 (lane = 4 g + t): A a0 (row g, k t), a1 (g + 8, t),
// a2 (g, t + 4), a3 (g + 8, t + 4); B b0 (k t, col g), b1 (t + 4, g); C
// c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1). A sum
// over k does not care about the order of its terms, so a kernel may
// give k-index t and t + 4 any two of its 8 positions as long as A and B
// agree: both kernels take k-index t = position 2t and t + 4 = position
// 2t + 1, which lets a C fragment feed the next product as its A.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace {

// cvt.rna.tf32.f32 (to nearest, ties away from zero) in two integer
// operations: the conversion instruction runs at a quarter of their rate
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo to ~2^-22 of x, both TF32
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// four (hi, lo) pairs, stored as two 16-byte words
__device__ __forceinline__ void split4(uint4* dst, float4 x) {
  uint4 a, b;
  split(x.x, a.x, a.y);
  split(x.y, a.z, a.w);
  split(x.z, b.x, b.y);
  split(x.w, b.z, b.w);
  dst[0] = a;
  dst[1] = b;
}

// c += a b on one m16n8k8 tile, TF32 operands, f32 accumulator
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a b in 3xTF32: lo.hi, then hi.lo, then hi.hi
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ahi)[4],
                                     const uint32_t (&alo)[4],
                                     const uint32_t (&bhi)[2],
                                     const uint32_t (&blo)[2]) {
  mma(c, alo, bhi);
  mma(c, ahi, blo);
  mma(c, ahi, bhi);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Stage rows [r0, r0 + kRows) of a (rows, D) matrix into dst (kRows rows
// of stride SD, DP columns), kThreads threads sharing the copies: rows
// past `rows` and columns past D read as 0 (cp.async's zero-fill).
template <int kRows, int kThreads, int DP, int SD>
__device__ __forceinline__ void stage_tile(float* dst, const float* src,
                                           int r0, int rows, int D,
                                           bool vec) {
  if (vec) {  // D % 4 == 0 and 16-byte aligned rows
    constexpr int chunks = DP / 4;
    for (int i = threadIdx.x; i < kRows * chunks; i += kThreads) {
      const int r = i / chunks, c = 4 * (i % chunks);
      const bool ok = r0 + r < rows && c < D;
      cp_async16(dst + r * SD + c, ok ? src + (size_t)(r0 + r) * D + c : src,
                 ok);
    }
  } else {
    for (int i = threadIdx.x; i < kRows * DP; i += kThreads) {
      const int r = i / DP, c = i % DP;
      const bool ok = r0 + r < rows && c < D;
      cp_async4(dst + r * SD + c, ok ? src + (size_t)(r0 + r) * D + c : src,
                ok);
    }
  }
}

}  // namespace
