// M2: the position-in-expert count of the mixture-of-experts layer's
// dispatch (models/moe.py _dispatch): for each (token, choice) pair, in the
// layer's flat order (token-major, choice-minor), the number of earlier
// pairs routed to the same expert.
//
//   pos[i] = #{ j < i : ids[j] == ids[i] }        ids in [0, E)
//
// ids (P,) int64, pos (P,) int32. An id outside [0, E) (no router makes
// one) takes pos -1 and counts for no expert.
//
// Replaces no TPU kernel: on the TPU XLA's cumsum took it. On the card
// PyTorch ran it as a (P, E) int32 one-hot, a scan over its outer dim
// (tensor_kernel_scan_outer_dim: one serial walk down the P rows a column,
// ~6.9 ms at the granite-4.0-h server's P 40,960, E 72) and a gather of
// each pair's own column, ~118 ms of a 1,145 ms step (PERF.md).
//
// Bound on an H100: bytes, at 3.35 TB/s. The count reads each id once and
// writes each position once, 12 bytes a pair (0.15 us at P 40,960); at
// these sizes the launch and the one grid-wide barrier set the time.
//
// Design. One cooperative launch of G blocks (G <= the SM count, chosen
// by the wrapper, so every block is resident and the grid barrier cannot
// wait on a block that never runs). Block b owns the contiguous segment
// [b seg, (b + 1) seg) of the pairs and each of its warps a contiguous
// chunk of that segment, a multiple of 32 pairs.
//   1. Each warp walks its chunk 32 pairs at a time, in order: the lanes
//      holding one id find each other with __match_any_sync, a lane's rank
//      among them is the popcount of the lower lanes' bits, and the group's
//      lowest lane adds the group's size to the warp's counter of that id
//      in shared memory. Each pair's position within its warp's chunk
//      (counter before the round + rank) goes to pos.
//   2. Each expert's counters become an exclusive prefix over the block's
//      warps in warp order, and the block's total of each expert goes to
//      the scratch agg (G, E).
//   3. After the grid barrier each block sums the totals of the blocks
//      before it, expert by expert, and adds that to its warps' prefixes.
//   4. Each warp walks its chunk again and adds the offset of the pair's
//      expert to its position.
// Every sum is of integers in a fixed order, no atomic decides anything,
// and each pos is written by one thread: the result is the one-hot scan's
// bit for bit and the same on every launch.
//
// Shapes: 1 <= E <= kMaxE (a warp's counters in shared memory), P < 2^31.
// The wrapper (kernels/moe_count.py) checks them and raises.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxE = 1024;
constexpr int kBatch = 4;  // rounds whose ids a warp loads before counting

__global__ void __launch_bounds__(kThreads) m2_positions(
    const long long* __restrict__ ids, int* __restrict__ pos,
    int* __restrict__ agg, long long P, int E, long long seg) {
  __shared__ int s_cnt[kWarps * kMaxE];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const unsigned lower = (1u << lane) - 1u;
  for (int i = threadIdx.x; i < kWarps * E; i += kThreads) s_cnt[i] = 0;
  __syncthreads();

  const long long b0 = blockIdx.x * seg;
  const long long b1 = b0 + seg < P ? b0 + seg : P;
  const long long chunk = (seg + kWarps * 32 - 1) / (kWarps * 32) * 32;
  const long long w0 = b0 + warp * chunk < b1 ? b0 + warp * chunk : b1;
  const long long w1 = w0 + chunk < b1 ? w0 + chunk : b1;
  int* cnt = s_cnt + warp * E;

  // 1. positions within the warp's chunk, counters per warp
  for (long long r0 = w0; r0 < w1; r0 += kBatch * 32) {  // uniform per warp
    int id[kBatch];
#pragma unroll
    for (int r = 0; r < kBatch; ++r) {
      const long long i = r0 + r * 32 + lane;
      long long v = -1;
      if (i < w1) v = __ldg(ids + i);
      id[r] = v >= 0 && v < E ? static_cast<int>(v) : -1;
    }
#pragma unroll
    for (int r = 0; r < kBatch; ++r) {
      const long long i = r0 + r * 32 + lane;
      const unsigned group = __match_any_sync(0xffffffffu, id[r]);
      const int before = id[r] >= 0 ? cnt[id[r]] : 0;
      __syncwarp();
      if (id[r] >= 0 && lane == __ffs(group) - 1)
        cnt[id[r]] = before + __popc(group);
      __syncwarp();
      if (i < w1) pos[i] = id[r] >= 0 ? before + __popc(group & lower) : -1;
    }
  }
  __syncthreads();

  // 2. exclusive prefix over the warps; the block's totals to agg
  for (int e = threadIdx.x; e < E; e += kThreads) {
    int run = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int c = s_cnt[w * E + e];
      s_cnt[w * E + e] = run;
      run += c;
    }
    agg[static_cast<long long>(blockIdx.x) * E + e] = run;
  }
  cg::this_grid().sync();

  // 3. the totals of the blocks before this one
  for (int e = threadIdx.x; e < E; e += kThreads) {
    int base = 0;
#pragma unroll 8
    for (unsigned p = 0; p < blockIdx.x; ++p)
      base += __ldcg(agg + static_cast<long long>(p) * E + e);
    for (int w = 0; w < kWarps; ++w) s_cnt[w * E + e] += base;
  }
  __syncthreads();

  // 4. each position moved by its expert's offset
  for (long long i = w0 + lane; i < w1; i += 32) {
    const long long v = __ldg(ids + i);
    if (v >= 0 && v < E) pos[i] += cnt[v];
  }
}

}  // namespace

extern "C" int m2_positions_launch(const long long* ids, int* pos, int* agg,
                                   long long P, int E, int blocks,
                                   void* stream) {
  if (P <= 0) return 0;
  if (E < 1 || E > kMaxE || P > 0x7fffffffLL || blocks < 1 ||
      blocks > P)
    return static_cast<int>(cudaErrorInvalidValue);
  long long seg = (P + blocks - 1) / blocks;
  void* args[] = {&ids, &pos, &agg, &P, &E, &seg};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(m2_positions), dim3(blocks), dim3(kThreads),
      args, 0, static_cast<cudaStream_t>(stream)));
}
