// Dedup + compaction of a sorted padded frontier, hand-written for sm_90a.
//
// Replaces the TPU kernel repro/kernels/unique_compact/kernel.py
// (unique_compact_pallas / _unique_kernel).  The TPU version walks its
// grid in order and carries the running unique count in SMEM from one
// block to the next, and compacts through a (cap x block_m) equality
// match.  Hopper blocks run in parallel with nothing carried between
// them, so this kernel is ONE block of 1024 threads that loops over the
// sorted array tile by tile: per tile it computes first-occurrence flags,
// an inclusive block scan of the flags (warp shuffles, then a scan of the
// 32 warp sums), adds the carry from earlier tiles, and scatters.
//
// Input: ids sorted ascending (the sort stays outside, in torch.sort).
//   inv[j]   = rank of ids[j] among the unique ids; -1 for INVALID ids and
//              for ranks >= cap (keep-smallest-cap overflow policy);
//   uniq[r]  = the r-th unique id for r < min(#unique, cap), INVALID after.
//
// Bound on the H100: at serving shapes (m <= ~31k ids, 125 KB in, 125 KB
// out) one block is bound by launch latency and the tile loop's
// synchronisations, far above the byte bound; a multi-block two-pass scan
// is the later step if plan building ever runs at large m.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int32_t kInvalid = 0x7fffffff;
constexpr int kThreads = 1024;

__global__ void __launch_bounds__(kThreads)
unique_compact_kernel(const int32_t* __restrict__ sorted,
                      int32_t* __restrict__ inv, int32_t* __restrict__ uniq,
                      int m, int cap) {
  __shared__ int warp_sums[kThreads / 32];
  __shared__ int carry;  // uniques in earlier tiles
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  constexpr int nwarps = kThreads / 32;
  if (tid == 0) carry = 0;
  __syncthreads();
  for (int base = 0; base < m; base += kThreads) {
    const int j = base + tid;
    int32_t v = 0;
    int first = 0;
    if (j < m) {
      v = sorted[j];
      first = (j == 0) || (sorted[j - 1] != v);
    }
    int x = first;  // inclusive scan within the warp
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      int y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    if (lane == 31) warp_sums[warp] = x;
    __syncthreads();
    if (warp == 0) {  // inclusive scan of the warp sums
      int w = warp_sums[lane];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        int y = __shfl_up_sync(0xffffffffu, w, o);
        if (lane >= o) w += y;
      }
      warp_sums[lane] = w;
    }
    __syncthreads();
    const int rank = carry + x + (warp > 0 ? warp_sums[warp - 1] : 0) - 1;
    if (j < m) {
      inv[j] = (rank < cap && v != kInvalid) ? rank : -1;
      if (first && rank < cap) uniq[rank] = v;
    }
    __syncthreads();  // every thread has read carry and warp_sums
    if (tid == 0) carry += warp_sums[nwarps - 1];
    __syncthreads();
  }
  for (int c = carry + tid; c < cap; c += kThreads) uniq[c] = kInvalid;
}

}  // namespace

extern "C" int unique_compact_launch(const void* sorted, void* inv, void* uniq,
                                     long long m, long long cap,
                                     void* stream) {
  unique_compact_kernel<<<1, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)sorted, (int32_t*)inv, (int32_t*)uniq, (int)m,
      (int)cap);
  return (int)cudaGetLastError();
}
