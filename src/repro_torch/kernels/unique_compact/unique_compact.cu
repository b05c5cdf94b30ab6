// Dedup + compaction of a sorted padded frontier, hand-written for sm_90a.
//
// Replaces the TPU kernel repro/kernels/unique_compact/kernel.py
// (unique_compact_pallas / _unique_kernel).  The TPU version walks its
// grid in order, carries the running unique count in SMEM from one block
// to the next, and compacts through a (cap x block_m) equality match.
//
// Input: m ids sorted ascending (the sort stays outside, in torch.sort) and
// the sort's int64 permutation `order`.
//   inv[order[j]] = rank of ids[j] among the unique ids; -1 for INVALID ids
//                   and for ranks >= cap (keep-smallest-cap overflow
//                   policy) -- the inverse in the caller's input order, with
//                   no separate scatter;
//   uniq[r]       = the r-th unique id for r < min(#unique, cap), INVALID after.
//
// Bound on the H100: bytes -- each id and its permutation entry read once,
// its inverse written once, `cap` unique ids written; one compare and one
// scan add per id are far below any arithmetic rate.  At the training
// path's deepest dedup (m = 1.29M ids) one block on one of the 132 SMs
// cannot draw the memory rate, and the TPU's in-order carry has no Hopper
// counterpart.  So the ids are cut into tiles of 2048 (256 threads x 8
// ids, two 16-byte loads per thread), one block each, all in ONE launch.
// Five blocks fit an SM, so the deepest dedup's 632 tiles run in one wave,
// and a short array spreads its scattered inverse over several SMs: one SM
// issues about one scattered store per clock, and a single 1,024-thread
// block took 6.9 us on an H100 for the 4,160 of a serving batch.  Each
// tile flags the first occurrences (its first id compares against the id
// before the tile), block-scans them (warp shuffles, then the warp sums in
// shared memory), takes the sum of all earlier tiles by scan.cuh's
// decoupled look-back, and writes inv and uniq.  The INVALID padding of
// uniq is written first: tile t fills uniq[2048 t, 2048 (t + 1)) before it
// publishes its status, and every rank tile t writes is below 2048 (t + 1),
// so by the time a tile writes its ids, every slot it writes has been
// filled; slots past the last tile are filled by all blocks.  More than
// one tile also takes a memset of the look-back's status words; one tile
// takes the kernel alone.  Nothing synchronises with the host.  What is
// left at large m is the inverse's scatter to random places (one 32-byte
// sector per id) and the int64 permutation's read.
#include <cuda_runtime.h>
#include <cstdint>

#include "../scan.cuh"

namespace {

constexpr int32_t kInvalid = 0x7fffffff;
constexpr int kThreads = 256;
constexpr int kItems = 8;                  // ids per thread
constexpr int kTile = kThreads * kItems;   // ids per block

long long tiles_of(long long m) { return m > kTile ? (m + kTile - 1) / kTile : 1; }

// Loads this thread's kItems ids from j0 on (two 16-byte loads when they
// are all in range and `vec`) and flags the first occurrence of each;
// returns the number of flags.  Every thread of the block calls it.
__device__ __forceinline__ int load_flags(const int32_t* __restrict__ sorted, long long m,
                                          long long j0, int vec, int32_t (&v)[kItems],
                                          int (&first)[kItems]) {
  if (vec && j0 + kItems <= m) {
    const int4 a = __ldg(reinterpret_cast<const int4*>(sorted + j0));
    const int4 b = __ldg(reinterpret_cast<const int4*>(sorted + j0) + 1);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
#pragma unroll
    for (int i = 0; i < kItems; ++i) v[i] = j0 + i < m ? __ldg(sorted + j0 + i) : 0;
  }
  // the id before this thread's first: the last id of the lane below, or
  // read from memory by lane 0
  int32_t prev = __shfl_up_sync(0xffffffffu, v[kItems - 1], 1);
  if ((threadIdx.x & 31) == 0 && j0 > 0 && j0 <= m) prev = __ldg(sorted + j0 - 1);
  int count = 0;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const long long j = j0 + i;
    const int32_t p = i == 0 ? prev : v[i - 1];
    first[i] = j < m && (j == 0 || p != v[i]);
    count += first[i];
  }
  return count;
}

// One tile per block: fill, flags, block scan, look-back, then inv and uniq.
__global__ void __launch_bounds__(kThreads, 5)
unique_compact_kernel(const int32_t* __restrict__ sorted, const int64_t* __restrict__ order,
                      int32_t* __restrict__ inv, int32_t* __restrict__ uniq, long long m,
                      int cap, int vec, unsigned long long* status, unsigned* next_tile) {
  __shared__ int smem[32];
  __shared__ int slot;
  const int tile = gridDim.x > 1 ? scan::claim_tile(next_tile, &slot) : 0;
  const long long f0 = (long long)tile * kTile;
  const long long f1 = f0 + kTile < cap ? f0 + kTile : cap;
  for (long long r = f0 + threadIdx.x; r < f1; r += kThreads) uniq[r] = kInvalid;
  for (long long r = (long long)gridDim.x * kTile + (long long)tile * kThreads + threadIdx.x;
       r < cap; r += (long long)gridDim.x * kThreads)
    uniq[r] = kInvalid;
  const long long j0 = f0 + (long long)threadIdx.x * kItems;
  int32_t v[kItems];
  int first[kItems];
  const int c = load_flags(sorted, m, j0, vec, v, first);
  // where each inverse goes, loaded before the scan so its latency overlaps
  long long dst[kItems];
  if (vec && j0 + kItems <= m) {
#pragma unroll
    for (int i = 0; i < kItems; i += 2) {
      const longlong2 o = __ldg(reinterpret_cast<const longlong2*>(order + j0 + i));
      dst[i] = o.x;
      dst[i + 1] = o.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < kItems; ++i) dst[i] = j0 + i < m ? __ldg(order + j0 + i) : 0;
  }
  int tile_sum;
  int rank = scan::block_exclusive_scan(c, smem, &tile_sum) - 1;  // ends in a barrier
  if (gridDim.x > 1) {
    if (threadIdx.x < 32) {
      const int prefix = scan::lookback(status, tile, tile_sum);
      if (threadIdx.x == 0) slot = prefix;
    }
    __syncthreads();
    rank += slot;
  }
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    rank += first[i];
    if (first[i] && rank < cap) uniq[rank] = v[i];
    if (j0 + i < m) inv[dst[i]] = (rank < cap && v[i] != kInvalid) ? rank : -1;
  }
}

}  // namespace

// Scratch of unique_compact_launch over m ids, in int32: the look-back's
// status words and tile counter when m spans more than one tile, else 0.
extern "C" long long unique_compact_scratch_ints(long long m) {
  const long long tiles = tiles_of(m);
  return tiles > 1 ? scan::lookback_ints(tiles) : 0;
}

// sorted: m int32 ids, ascending; order: the sort's int64 permutation;
// inv: m int32; uniq: cap int32; scratch: unique_compact_scratch_ints(m)
// int32.  Returns the first launch error, checked after the memset and
// the kernel.
extern "C" int unique_compact_launch(const void* sorted, const void* order, void* inv,
                                     void* uniq, void* scratch, long long m, long long cap,
                                     void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const long long tiles = tiles_of(m);
  if (tiles > 1) {
    const cudaError_t err =
        cudaMemsetAsync(scratch, 0, scan::lookback_ints(tiles) * sizeof(int), s);
    if (err != cudaSuccess) return (int)err;
  }
  const int vec = (uintptr_t)sorted % 16 == 0 && (uintptr_t)order % 16 == 0;
  int* words = tiles > 1 ? (int*)scratch : nullptr;  // status words, then the tile counter
  unsigned* next_tile = words ? (unsigned*)(words + 2 * tiles) : nullptr;
  unique_compact_kernel<<<(unsigned)tiles, kThreads, 0, s>>>(
      (const int32_t*)sorted, (const int64_t*)order, (int32_t*)inv, (int32_t*)uniq, m,
      (int)cap, vec, (unsigned long long*)words, next_tile);
  return (int)cudaGetLastError();
}
