// Paged batched-decode attention for Hopper (sm_90a), float32.
//
// Replaces the TPU kernel `paged_attention_decode` of
// src/repro/kernels/paged_attention.py (Pallas body `_paged_kernel`).
// One query token per decode slot attends over that slot's pages of a
// paged KV pool:
//
//   q        (slots, Hkv, G, D)     GQA group-major, f32
//   pages_k  (Hkv, P, page, D)      physical pools, f32
//   pages_v  (Hkv, P, page, D)
//   table    (slots, max_pages)     int32 physical page ids
//   lengths  (slots,)               int32, counting the just-written token
//   out      (slots, Hkv, G, D)     f32
//
// Design. The TPU grid walks the pages of a slot as a sequential grid
// axis and carries the online-softmax state (m, l, acc) in VMEM scratch
// across grid steps. Hopper blocks run in no order and share nothing,
// so here one block owns one (slot, kv head) and loops over the slot's
// pages itself, keeping m and l in shared memory and acc in registers.
// Each block reads its own page-table row and length (the TPU kernel's
// scalar prefetch). Pages at or past the slot's length are never read;
// positions past the length inside the last page are masked. The query
// rows of a kv head share every K/V page the block stages in shared
// memory, so G needs no padding (the TPU pads it to its 8-row sublane
// tile). A slot of length 0 reads no page and writes exact zeros; the
// denominator is clamped at 1e-30 as in the reference.
//
// Any group size G. A block holds at most kMaxG = 16 query rows in its
// registers, so a third grid axis cuts a larger group into chunks of 16:
// block (h, slot, z) takes rows [16z, min(16z + 16, G)) of kv head h,
// still in one launch. G <= 16 keeps one chunk and the path it always
// had. The cost is in the reads: each chunk stages the slot's K/V pages
// on its own, so a group of 48 (granite-20b: 48 query heads over one kv
// head) reads every page three times. A design that loops over the whole
// group inside one block, reading each page once, is left for B6's own
// redesign.
//
// Bound on this card: memory. The work is 4*G*D flops per live position
// per kv head against 2*D*4 bytes of K and V read once, i.e. G/2
// flop/byte -- far below the H100's balance point -- so the least time is
// the live K/V bytes, slots * length * Hkv * D * 4 B * 2, over the HBM
// rate. At decode batch sizes that is about a megabyte per layer, which
// the card moves in well under a launch's overhead: the kernel is
// launch-bound there. It is written simple and right: wgmma, TMA and a
// split of the pages across blocks are left for later work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxG = 16;        // query rows a block holds (a chunk)
constexpr float kNegInf = -1e30f;

template <int D>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const float* __restrict__ q,
                    const float* __restrict__ pages_k,
                    const float* __restrict__ pages_v,
                    const int* __restrict__ page_table,
                    const int* __restrict__ lengths,
                    float* __restrict__ out,
                    int hkv, int G_all, int num_pages, int page,
                    int maxp, float scale) {
  constexpr int kRowsPerPass = kThreads / D;       // 1 (D=128) or 2 (D=64)
  constexpr int kAccRows = kMaxG / kRowsPerPass;
  constexpr int kStride = D + 1;  // padded K rows: conflict-free score reads

  extern __shared__ float smem[];
  // this block's chunk of the group: rows [g0, g0 + G) of kv head h
  const int g0 = blockIdx.z * kMaxG;
  const int G = min(kMaxG, G_all - g0);
  float* qs = smem;                    // G * D, pre-scaled queries
  float* ks = qs + G * D;              // page * kStride
  float* vs = ks + page * kStride;     // page * D
  float* ps = vs + page * D;           // G * page scores, then probabilities
  float* m_s = ps + G * page;          // G running max
  float* l_s = m_s + G;                // G running denominator
  float* a_s = l_s + G;                // G rescale factor of the current page

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int length = lengths[b];
  const size_t qo = (((size_t)b * hkv + h) * G_all + g0) * D;

  for (int i = tid; i < G * D; i += kThreads) qs[i] = q[qo + i] * scale;
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }

  // this thread's output column and the query rows it accumulates
  const int col = tid % D;
  const int row0 = tid / D;
  float acc[kAccRows];
#pragma unroll
  for (int r = 0; r < kAccRows; ++r) acc[r] = 0.f;

  int n_pages = (length + page - 1) / page;  // later pages are skipped
  if (n_pages > maxp) n_pages = maxp;
  const int* row_table = page_table + (size_t)b * maxp;

  for (int j = 0; j < n_pages; ++j) {
    const size_t base = ((size_t)h * num_pages + row_table[j]) * page * D;
    __syncthreads();  // the previous page's reads of ks, vs, ps are done
    for (int i = tid; i < page * D; i += kThreads) {
      ks[(i / D) * kStride + (i % D)] = pages_k[base + i];
      vs[i] = pages_v[base + i];
    }
    __syncthreads();

    // scores, one thread per (query row, position)
    for (int i = tid; i < G * page; i += kThreads) {
      const int g = i / page, t = i % page;
      const float* qr = qs + g * D;
      const float* kr = ks + t * kStride;
      float s = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) s = fmaf(qr[d], kr[d], s);
      ps[i] = (j * page + t < length) ? s : kNegInf;
    }
    __syncthreads();

    // online-softmax update, one thread per query row
    for (int g = tid; g < G; g += kThreads) {
      float* pr = ps + g * page;
      const float m_prev = m_s[g];
      float m_new = m_prev;
      for (int t = 0; t < page; ++t) m_new = fmaxf(m_new, pr[t]);
      float sum = 0.f;
      for (int t = 0; t < page; ++t) {
        const float p = expf(pr[t] - m_new);
        pr[t] = p;
        sum += p;
      }
      const float alpha = expf(m_prev - m_new);
      l_s[g] = l_s[g] * alpha + sum;
      m_s[g] = m_new;
      a_s[g] = alpha;
    }
    __syncthreads();

    // acc = acc * alpha + p @ v for this thread's column
#pragma unroll
    for (int r = 0; r < kAccRows; ++r) {
      const int g = row0 + r * kRowsPerPass;
      if (g < G) {
        const float* pr = ps + g * page;
        float pv = 0.f;
        for (int t = 0; t < page; ++t) pv = fmaf(pr[t], vs[t * D + col], pv);
        acc[r] = acc[r] * a_s[g] + pv;
      }
    }
  }
  __syncthreads();  // l_s is final (and initialised, when no page was read)

#pragma unroll
  for (int r = 0; r < kAccRows; ++r) {
    const int g = row0 + r * kRowsPerPass;
    if (g < G) out[qo + (size_t)g * D + col] = acc[r] / fmaxf(l_s[g], 1e-30f);
  }
}

template <int D>
cudaError_t launch(const float* q, const float* pages_k, const float* pages_v,
                   const int* page_table, const int* lengths, float* out,
                   int slots, int hkv, int G, int num_pages, int page,
                   int maxp, float scale, cudaStream_t stream) {
  const int Gc = G < kMaxG ? G : kMaxG;  // rows of the largest chunk
  const size_t smem =
      sizeof(float) * ((size_t)Gc * D + (size_t)page * (D + 1) +
                       (size_t)page * D + (size_t)Gc * page + 3 * (size_t)Gc);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        paged_decode_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int chunks = (G + kMaxG - 1) / kMaxG;
  paged_decode_kernel<D><<<dim3(hkv, slots, chunks), kThreads, smem,
                           stream>>>(
      q, pages_k, pages_v, page_table, lengths, out, hkv, G, num_pages, page,
      maxp, scale);
  return cudaGetLastError();
}

}  // namespace

// C entry point bound with ctypes. Returns the launch's cudaError_t
// (0 = success); the caller validates shapes, types and contiguity.
extern "C" int paged_attention_decode_f32(
    const float* q, const float* pages_k, const float* pages_v,
    const int* page_table, const int* lengths, float* out, int slots, int hkv,
    int G, int D, int num_pages, int page, int maxp, float scale,
    void* stream) {
  if (G < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return (int)launch<64>(q, pages_k, pages_v, page_table, lengths, out,
                             slots, hkv, G, num_pages, page, maxp, scale, s);
    case 128:
      return (int)launch<128>(q, pages_k, pages_v, page_table, lengths, out,
                              slots, hkv, G, num_pages, page, maxp, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
