// Integer scans shared by the port's CUDA kernels, for sm_90a.
//
// * block_exclusive_scan: the exclusive prefix of one int per thread over a
//   block, in thread order -- an inclusive scan inside each warp by
//   shuffles, then a scan of the warp sums in shared memory.
// * load_ints / store_ints: a thread's N consecutive ints, moved with
//   16-byte accesses where aligned.
// * claim_tile / lookback: the decoupled look-back -- each tile adds the
//   sums its predecessors publish -- with which a kernel scans across its
//   blocks in the same launch.
// * exclusive_scan: a device-wide exclusive scan of an int array in one
//   launch built on them, its total written to device memory, never read
//   by the host.
//
// unique_compact.cu scans its tiles' first-occurrence flags with
// claim_tile / lookback inside its one kernel; spmm.cu scans its per-row
// counts with exclusive_scan.
#pragma once
#include <cuda_runtime.h>
#include <cstdint>

namespace scan {

// Exclusive prefix of x over the block's threads (thread order); *total gets
// the block's sum in every thread.  Every thread of the block calls it;
// blockDim.x is a multiple of 32, at most 1024.  smem: 32 ints.  It ends
// in a barrier, so smem may be reused right after.
__device__ __forceinline__ int block_exclusive_scan(int x, int* smem, int* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  int inc = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += y;
  }
  if (lane == 31) smem[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    int w = lane < nwarps ? smem[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    if (lane < nwarps) smem[lane] = w;
  }
  __syncthreads();
  const int out = inc - x + (warp > 0 ? smem[warp - 1] : 0);
  *total = smem[nwarps - 1];
  __syncthreads();
  return out;
}

// Loads N consecutive ints from p + j0 (N a multiple of 4, j0 of N): int4
// loads when `vec` (p 16-byte aligned) and all N lie below n, else scalar
// loads with 0 past n.  Not through the read-only cache: p may be written
// in place afterwards.
template <int N>
__device__ __forceinline__ void load_ints(const int* p, long long j0, long long n, bool vec,
                                          int (&v)[N]) {
  if (vec && j0 + N <= n) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const int4 q = *reinterpret_cast<const int4*>(p + j0 + i);
      v[i] = q.x; v[i + 1] = q.y; v[i + 2] = q.z; v[i + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = j0 + i < n ? p[j0 + i] : 0;
  }
}

// Stores v to p + j0 below n, as load_ints reads.
template <int N>
__device__ __forceinline__ void store_ints(int* p, long long j0, long long n, bool vec,
                                           const int (&v)[N]) {
  if (vec && j0 + N <= n) {
#pragma unroll
    for (int i = 0; i < N; i += 4)
      *reinterpret_cast<int4*>(p + j0 + i) = make_int4(v[i], v[i + 1], v[i + 2], v[i + 3]);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i)
      if (j0 + i < n) p[j0 + i] = v[i];
  }
}

__device__ __forceinline__ bool aligned16(const void* a, const void* b) {
  return ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) & 15) == 0;
}

// Decoupled look-back, the single-pass device-wide scan: blocks claim tile
// ids in launch order, so every earlier tile belongs to a block that has
// already started, and each tile publishes one 64-bit status word -- its
// own sum (kAggregate), then the sum of tiles 0..t (kInclusive).
constexpr unsigned long long kAggregate = 1ULL << 32;
constexpr unsigned long long kInclusive = 2ULL << 32;

// The next tile id in launch order, claimed by thread 0 and broadcast
// through `slot` (shared memory).  Every thread of the block calls it.
__device__ __forceinline__ int claim_tile(unsigned* next_tile, int* slot) {
  if (threadIdx.x == 0) *slot = (int)atomicAdd(next_tile, 1u);
  __syncthreads();
  return *slot;
}

// Called by the 32 threads of warp 0 of the block that owns `tile`, once
// its sum is known: publishes the sum, reads back through the earlier
// tiles' words 32 at a time (each lane waits on one tile) until one holds
// an inclusive sum, publishes this tile's inclusive sum and returns the
// sum of all earlier tiles.  status: one zeroed word per tile.  Fenced on
// both sides: what the block wrote before a __syncthreads preceding the
// call is visible to every later tile once that tile's lookback returns.
__device__ __forceinline__ int lookback(unsigned long long* status, int tile, int tile_sum) {
  const int lane = threadIdx.x & 31;
  int prefix = 0;
  __threadfence();  // release: the block's writes before its status word
  if (tile > 0) {
    if (lane == 0) atomicExch(status + tile, kAggregate | (unsigned)tile_sum);
    for (int k = tile - 1 - lane;; k -= 32) {
      unsigned long long w = kInclusive;  // before tile 0: an inclusive 0
      if (k >= 0) {
        do {
          w = atomicAdd(status + k, 0ULL);
        } while ((w >> 32) == 0);
      }
      const unsigned done = __ballot_sync(0xffffffffu, (w >> 32) == 2);
      const int last = done ? __ffs(done) - 1 : 31;  // nearest inclusive word
      int v = lane <= last ? (int)(unsigned)w : 0;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      prefix += v;
      if (done) break;
    }
  }
  __threadfence();  // acquire: the earlier tiles' writes before the caller's
  if (lane == 0) atomicExch(status + tile, kInclusive | (unsigned)(prefix + tile_sum));
  return prefix;
}

constexpr int kScanThreads = 256;
constexpr int kScanItems = 8;
constexpr int kScanTile = kScanThreads * kScanItems;  // ints per tile of exclusive_scan

// Tiles of exclusive_scan over n ints.
inline long long scan_tiles(long long n) { return n > 0 ? (n + kScanTile - 1) / kScanTile : 1; }

// Scratch of a look-back over `tiles` tiles, in ints: a 64-bit status word
// per tile, then the tile counter, all zeroed before the launch (8-byte
// aligned).
inline long long lookback_ints(long long tiles) { return 2 * tiles + 1; }

// Scratch of exclusive_scan over n ints.
inline long long scratch_ints(long long n) { return lookback_ints(scan_tiles(n)); }

namespace {

__global__ void __launch_bounds__(kScanThreads)
lookback_scan_kernel(const int* in, int* out, long long n, unsigned long long* status,
                     unsigned* next_tile, int* total) {
  __shared__ int smem[kScanThreads / 32];
  __shared__ int slot;
  const int tile = claim_tile(next_tile, &slot);
  const long long j0 = (long long)tile * kScanTile + (long long)threadIdx.x * kScanItems;
  const bool vec = aligned16(in, out);
  int v[kScanItems];
  load_ints(in, j0, n, vec, v);
  int sum = 0;
#pragma unroll
  for (int i = 0; i < kScanItems; ++i) sum += v[i];
  int tile_sum;
  int pre = block_exclusive_scan(sum, smem, &tile_sum);
  if (threadIdx.x < 32) {
    const int prefix = lookback(status, tile, tile_sum);
    if (threadIdx.x == 0) {
      slot = prefix;
      if ((long long)(tile + 1) * kScanTile >= n) *total = prefix + tile_sum;
    }
  }
  __syncthreads();
  pre += slot;
#pragma unroll
  for (int i = 0; i < kScanItems; ++i) {
    const int x = v[i];
    v[i] = pre;
    pre += x;
  }
  store_ints(out, j0, n, vec, v);
}

}  // namespace

// Device-wide exclusive scan of in[0, n) into out (in place allowed), in
// one launch; *total = the sum.  scratch: scratch_ints(n) ints, zeroed.
inline cudaError_t exclusive_scan(const int* in, int* out, long long n, int* scratch,
                                  int* total, cudaStream_t stream) {
  const long long tiles = scan_tiles(n);
  lookback_scan_kernel<<<(unsigned)tiles, kScanThreads, 0, stream>>>(
      in, out, n, reinterpret_cast<unsigned long long*>(scratch),
      reinterpret_cast<unsigned*>(scratch + 2 * tiles), total);
  return cudaGetLastError();
}

}  // namespace scan
