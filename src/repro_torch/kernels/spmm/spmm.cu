// Padded-bipartite neighbor aggregation (SpMM), forward and backward,
// hand-written for sm_90a.
//
// Replaces the TPU kernel repro/kernels/spmm/kernel.py (spmm_pallas /
// _spmm_kernel).  The TPU version keeps a whole (S, block_d) slice of the
// source matrix resident in VMEM so that its row gathers hit VMEM, not
// HBM.  A Hopper SM has 227 KB of shared memory, far less than one such
// slice, but it gathers at random from HBM and L2 directly.
//
// Forward: out[r, c] = sum over k in slot order 0..w-1 of
//   (mask[r, k] ? src[clamp(nbr_idx[r, k], 0, S-1), c] : 0), in float32,
//   divided by max(deg_r, 1) in mean mode (deg_r = masked slots of row r).
// Bound on the H100 (forward): bytes -- the mask, the index of each masked
// slot, each source row a masked slot reads and the (n, d) output written
// once; at the training path's layer 2 (n = 39,208, w = 32, d = 64) the
// output is 10 MB of the 12.8 MB, and most rows are padding with no
// masked slot.  So the forward skips masked-out slots instead of looping
// over them, and writes the output with 16-byte stores:
//   - a group of G lanes (8, 16 or 32, as many as d's float4s need, up
//     to a warp; d = 256 takes two groups a row) takes one row; its lanes
//     load a window of 64 slots' mask bytes and, for masked slots only,
//     their indices (into shared memory), G slots a round, all rounds in
//     flight together;
//   - __ballot_sync gives the window's masked-slot bits; the group walks
//     only the set bits, in ascending slot order (__ffsll), reads each
//     index back from shared memory, loads 4 source vectors ahead and adds
//     them in slot order with __fadd_rn, each lane on its own float4
//     column (floats where d % 4 or an address is not 16-byte aligned);
//     so a row costs a round trip for its mask, one for its indices and
//     one for each 4 masked slots, whatever w is;
//   - a row with no masked slot adds nothing and writes its zeros.
// Skipping a masked-out slot equals the plain version's adding 0.0: the
// sum starts at +0.0, which round-to-nearest addition never turns into
// -0.0, and x + 0.0 == x for every other x (inf and NaN included).  The
// plain version in ref.py adds in the same slot order, so the forward
// equals it bit for bit.
//
// Backward: grad_src[j, c] = sum over the masked slots (r, k) with
// clamp(nbr_idx[r, k]) == j, in slot order r*w + k, of g[r, c], with
// g = grad_out / max(deg_r, 1) in mean mode (the division first, as the
// plain version divides first).  Each sum runs in slot order with
// __fadd_rn, so the result equals the plain version bit for bit and is the
// same from call to call.
//
// Bound on the H100 (backward): bytes -- the mask, the index of each masked
// slot, each gradient row with a masked slot, and the (num_src, d) output
// written once; at the training path's layer 1 the output is 26.8 MB of
// the 27 MB.  A sort of the slots by source row, a zero fill of the
// output and a (slot x column) grid where most slots are masked out cost
// several times that bound in launches and passes, so the backward
// transposes the masked slots by counting instead, and writes each output
// row once:
//   1. count:   one warp per output row r, a lane per slot: each masked
//               slot adds 1 to count[j] (integer atomics; count and the
//               scan's status words zeroed by one memset); the row's
//               degree by ballot;
//   2. offsets: an exclusive scan of count in one launch (scan.cuh's
//               decoupled look-back), so source row j's slots own
//               list[offset[j], offset[j + 1]);
//   3. place:   each masked slot takes a place in its row's run by an
//               atomic countdown of count[j] (order inside a run arbitrary);
//   4. rows:    one warp per source row j puts its run in slot order, in
//               place in the run's own slice of `list` -- up to 32 entries
//               by shuffle ranks, longer runs (a hub row, up to n w) by a
//               bitonic sort -- then its lanes cover the d columns (float4
//               where d % 4 == 0), add the runs' gradient rows in that order
//               and write row j once (zeros for no run).
// No sort, no float atomics, no fill of the output.
#include <cuda_runtime.h>
#include <cstdint>

#include "../scan.cuh"

namespace {

__device__ __forceinline__ long long clamp_row(int32_t j, long long num_src) {
  long long r = j < 0 ? 0 : (long long)j;
  return r >= num_src ? num_src - 1 : r;
}

constexpr unsigned kFull = 0xffffffffu;
constexpr int kFwdThreads = 256;
constexpr int kAhead = 4;  // source loads in flight per lane

__device__ __forceinline__ float4 vload(const float4* p) { return __ldg(p); }
__device__ __forceinline__ float vload(const float* p) { return __ldg(p); }
__device__ __forceinline__ void vzero(float4& a) { a = make_float4(0.0f, 0.0f, 0.0f, 0.0f); }
__device__ __forceinline__ void vzero(float& a) { a = 0.0f; }
__device__ __forceinline__ float4 vadd(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y), __fadd_rn(a.z, b.z),
                     __fadd_rn(a.w, b.w));
}
__device__ __forceinline__ float vadd(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float4 vdiv(float4 a, float b) {
  return make_float4(__fdiv_rn(a.x, b), __fdiv_rn(a.y, b), __fdiv_rn(a.z, b), __fdiv_rn(a.w, b));
}
__device__ __forceinline__ float vdiv(float a, float b) { return __fdiv_rn(a, b); }

// One group of G lanes (G = 8, 16 or 32) per row r and pass; V is float4
// or float, dv the row width in V, and pass blockIdx.y covers columns
// [G * pass, G * (pass + 1)), lane `sub` on column G * pass + sub.  Slots
// go in windows of 64: the lanes load the window's mask bytes (and each
// masked slot's index, into the group's shared row) G slots a round, every
// round's loads in flight together, and ballot them into one 64-bit mask;
// the walk then takes kAhead masked slots at a time, reads their indices
// from the shared row, issues their kAhead source loads and adds them in
// slot order.  The lanes of a group take the same branches (the bits come
// from ballots), so each warp sync names the group only.
template <typename V, int G>
__global__ void __launch_bounds__(kFwdThreads)
spmm_fwd_kernel(const V* __restrict__ src, const int32_t* __restrict__ nbr_idx,
                const uint8_t* __restrict__ mask, V* __restrict__ out, long long n, int w,
                int dv, long long num_src, int mean) {
  constexpr int kRounds = 64 / G;  // rounds of G slots in a window
  constexpr unsigned kLow = G == 32 ? kFull : (1u << G) - 1u;
  __shared__ int s_rows[kFwdThreads / G][64];  // each group's window of source rows
  const long long r = (blockIdx.x * (long long)kFwdThreads + threadIdx.x) / G;
  if (r >= n) return;  // the whole group
  const int lane = threadIdx.x & 31;
  const int sub = lane & (G - 1);
  const int base = lane - sub;
  const unsigned group = kLow << base;
  int* rows = s_rows[threadIdx.x / G];
  const int c = blockIdx.y * G + sub;  // this lane's column
  const int32_t* idx = nbr_idx + r * w;
  const uint8_t* m = mask + r * w;
  V acc;
  vzero(acc);
  int deg = 0;
  for (int k0 = 0; k0 < w; k0 += 64) {
    unsigned long long bits = 0;
#pragma unroll
    for (int q = 0; q < kRounds; ++q) {
      const int k = k0 + q * G + sub;
      const bool on = k < w && __ldg(m + k);
      if (on) rows[q * G + sub] = (int)clamp_row(__ldg(idx + k), num_src);
      bits |= (unsigned long long)((__ballot_sync(group, on) >> base) & kLow) << (q * G);
    }
    __syncwarp(group);
    deg += __popcll(bits);
    while (bits) {
      int row[kAhead];
      int cnt = 0;
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {  // the next kAhead masked slots, in slot order
        row[u] = bits ? rows[__ffsll((long long)bits) - 1] : 0;
        if (bits) {
          bits &= bits - 1;
          cnt = u + 1;
        }
      }
      V x[kAhead];
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {  // every load before the first add
        vzero(x[u]);
        if (u < cnt && c < dv) x[u] = vload(src + (long long)row[u] * dv + c);
      }
#pragma unroll
      for (int u = 0; u < kAhead; ++u)
        if (u < cnt) acc = vadd(acc, x[u]);
    }
    __syncwarp(group);  // the window's rows are read before the next one's land
  }
  if (c < dv) out[r * dv + c] = mean ? vdiv(acc, (float)(deg > 1 ? deg : 1)) : acc;
}

constexpr int kRowsThreads = 256;  // 8 warps, one source row each

// 1. count[j] += 1 for every masked slot reading source row j; deg[r] =
// masked slots of row r.  One warp per row r, lane k0 + lane on slot k.
__global__ void bwd_count_kernel(const int32_t* __restrict__ nbr_idx,
                                 const uint8_t* __restrict__ mask, int* __restrict__ count,
                                 int* __restrict__ deg, long long n, int w,
                                 long long num_src) {
  const long long r = (blockIdx.x * (long long)blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (r >= n) return;  // the whole warp
  int dg = 0;
  for (int k0 = 0; k0 < w; k0 += 32) {
    const int k = k0 + lane;
    const bool on = k < w && __ldg(mask + r * w + k);
    if (on) atomicAdd(count + clamp_row(__ldg(nbr_idx + r * w + k), num_src), 1);
    dg += __popc(__ballot_sync(kFull, on));
  }
  if (lane == 0) deg[r] = dg;
}

// 3. list[offset[j] + c] = flat slot index r*w + k for the masked slots of
// source row j, c counting count[j] down to 0 (order within a run arbitrary).
__global__ void bwd_place_kernel(const int32_t* __restrict__ nbr_idx,
                                 const uint8_t* __restrict__ mask,
                                 const int* __restrict__ offset, int* __restrict__ count,
                                 int* __restrict__ list, long long n, int w,
                                 long long num_src) {
  const long long r = (blockIdx.x * (long long)blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (r >= n) return;
  for (int k0 = 0; k0 < w; k0 += 32) {
    const int k = k0 + lane;
    if (k < w && __ldg(mask + r * w + k)) {
      const long long j = clamp_row(__ldg(nbr_idx + r * w + k), num_src);
      list[__ldg(offset + j) + atomicSub(count + j, 1) - 1] = (int)(r * w + k);
    }
  }
}

// Sorts a[0, L) ascending (distinct values) by one warp: a bitonic network
// with every comparator pointing up, positions >= L read as +infinity (so
// comparators that reach past L are skipped).
__device__ void warp_sort(int* a, int L) {
  const int lane = threadIdx.x & 31;
  int Lp = 32;
  while (Lp < L) Lp <<= 1;
  for (int size = 2; size <= Lp; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const int flip = stride == (size >> 1) ? size - 1 : stride;
      for (int base = 0; base < Lp; base += 4 * 32) {
        int lo[4], hi[4], x[4], y[4];
        bool on[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {  // loads first: this lane's pairs are disjoint
          const int i = base + u * 32 + lane;
          const int p = i ^ flip;
          lo[u] = i;
          hi[u] = p;
          on[u] = i < p && p < L;
          if (on[u]) {
            x[u] = a[i];
            y[u] = a[p];
          }
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (on[u] && x[u] > y[u]) {
            a[lo[u]] = y[u];
            a[hi[u]] = x[u];
          }
        }
      }
      __syncwarp();
    }
  }
}

template <bool kVec>
__device__ __forceinline__ void add_run(const float* __restrict__ g,
                                        const int* __restrict__ deg, const int* run, int L,
                                        float* __restrict__ out, int w, int d, int mean) {
  const int lane = threadIdx.x & 31;
  constexpr int kCols = kVec ? 4 : 1;
  for (int c = lane * kCols; c < d; c += 32 * kCols) {
    float acc[kCols];
#pragma unroll
    for (int q = 0; q < kCols; ++q) acc[q] = 0.0f;
#pragma unroll 4
    for (int t = 0; t < L; ++t) {
      const long long r = run[t] / w;
      float x[kCols];
      if constexpr (kVec) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(g + r * d + c));
        x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
      } else {
        x[0] = __ldg(g + r * d + c);
      }
      if (mean) {
        const int dg = __ldg(deg + r);
        const float div = (float)(dg > 1 ? dg : 1);
#pragma unroll
        for (int q = 0; q < kCols; ++q) x[q] = __fdiv_rn(x[q], div);
      }
#pragma unroll
      for (int q = 0; q < kCols; ++q) acc[q] = __fadd_rn(acc[q], x[q]);
    }
    if constexpr (kVec) {
      *reinterpret_cast<float4*>(out + c) = make_float4(acc[0], acc[1], acc[2], acc[3]);
    } else {
      out[c] = acc[0];
    }
  }
}

// 4. One warp per source row j: its run in slot order, then the sums.
template <bool kVec>
__global__ void __launch_bounds__(kRowsThreads)
bwd_rows_kernel(const float* __restrict__ g, const int* __restrict__ offset,
                int* list, const int* __restrict__ deg, float* __restrict__ grad_src,
                long long num_src, int w, int d, int mean) {
  const long long j = (blockIdx.x * (long long)blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (j >= num_src) return;  // the whole warp
  const int beg = __ldg(offset + j);
  const int L = __ldg(offset + j + 1) - beg;
  int* run = list + beg;  // this warp owns the slice
  if (L <= 32) {
    // rank of each lane's entry among the run's (entries are distinct)
    const int e = lane < L ? run[lane] : 0x7fffffff;
    if (L > 1) {
      int rank = 0;
#pragma unroll
      for (int t = 0; t < 32; ++t) rank += __shfl_sync(kFull, e, t) < e;
      if (lane < L) run[rank] = e;  // every lane has read its entry
      __syncwarp();
    }
  } else {
    warp_sort(run, L);
  }
  add_run<kVec>(g, deg, run, L, grad_src + j * d, w, d, mean);
}

unsigned blocks_for(long long total, int threads) {
  return (unsigned)((total + threads - 1) / threads);
}

template <typename V, int G>
void fwd_launch(const void* src, const void* nbr_idx, const void* mask, void* out,
                long long n, long long w, long long dv, long long num_src, long long mean,
                cudaStream_t s) {
  const dim3 grid(blocks_for(n * G, kFwdThreads), (unsigned)((dv + G - 1) / G));
  spmm_fwd_kernel<V, G><<<grid, kFwdThreads, 0, s>>>(
      (const V*)src, (const int32_t*)nbr_idx, (const uint8_t*)mask, (V*)out, n, (int)w,
      (int)dv, num_src, (int)mean);
}

template <typename V>
void fwd_launch(const void* src, const void* nbr_idx, const void* mask, void* out,
                long long n, long long w, long long dv, long long num_src, long long mean,
                cudaStream_t s) {
  if (dv <= 8) fwd_launch<V, 8>(src, nbr_idx, mask, out, n, w, dv, num_src, mean, s);
  else if (dv <= 16) fwd_launch<V, 16>(src, nbr_idx, mask, out, n, w, dv, num_src, mean, s);
  else fwd_launch<V, 32>(src, nbr_idx, mask, out, n, w, dv, num_src, mean, s);
}

}  // namespace

extern "C" int spmm_forward_launch(const void* src, const void* nbr_idx,
                                   const void* mask, void* out, long long n,
                                   long long w, long long d, long long num_src,
                                   long long mean, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (d % 4 == 0 && (uintptr_t)src % 16 == 0 && (uintptr_t)out % 16 == 0)
    fwd_launch<float4>(src, nbr_idx, mask, out, n, w, d / 4, num_src, mean, s);
  else
    fwd_launch<float>(src, nbr_idx, mask, out, n, w, d, num_src, mean, s);
  return (int)cudaGetLastError();
}

// Scratch of the backward, in int32 offsets: count (num_src + 1), the
// scan's zeroed words, offset (num_src + 1) and deg (n), each from a
// 16-byte boundary, then list (n w) and the scan's total.  count and the
// scan's words, the first `zeroed` ints, are zeroed by one memset.
namespace {

struct BwdScratch {
  long long scan_words, zeroed, offset, deg, list, total, ints;
};

BwdScratch bwd_scratch(long long n, long long w, long long num_src) {
  auto up4 = [](long long x) { return (x + 3) & ~3LL; };
  BwdScratch o;
  o.scan_words = up4(num_src + 1);
  o.zeroed = o.scan_words + scan::scratch_ints(num_src + 1);
  o.offset = up4(o.zeroed);
  o.deg = o.offset + up4(num_src + 1);
  o.list = o.deg + up4(n);
  o.total = o.list + n * w;
  o.ints = o.total + 1;
  return o;
}

}  // namespace

extern "C" long long spmm_backward_scratch_ints(long long n, long long w, long long num_src) {
  return bwd_scratch(n, w, num_src).ints;
}

// g: (n, d) output gradient; grad_src: (num_src, d), every row written;
// scratch: spmm_backward_scratch_ints(n, w, num_src) int32.  Returns the
// first launch error, checked after the memset and each of the 4 kernel
// launches.
extern "C" int spmm_backward_launch(const void* g, const void* nbr_idx, const void* mask,
                                    void* grad_src, void* scratch, long long n, long long w,
                                    long long d, long long num_src, long long mean,
                                    void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const BwdScratch lay = bwd_scratch(n, w, num_src);
  int* count = (int*)scratch;  // num_src + 1; the last stays 0
  int* scan_words = count + lay.scan_words;
  int* offset = count + lay.offset;
  int* deg = count + lay.deg;
  int* list = count + lay.list;
  int* total = count + lay.total;
  cudaError_t err = cudaMemsetAsync(count, 0, lay.zeroed * sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  const int threads = 256;
  const unsigned row_blocks = blocks_for(n * 32, threads);
  bwd_count_kernel<<<row_blocks, threads, 0, s>>>((const int32_t*)nbr_idx,
                                                  (const uint8_t*)mask, count, deg, n,
                                                  (int)w, num_src);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = scan::exclusive_scan(count, offset, num_src + 1, scan_words, total, s);
  if (err != cudaSuccess) return (int)err;
  bwd_place_kernel<<<row_blocks, threads, 0, s>>>((const int32_t*)nbr_idx,
                                                  (const uint8_t*)mask, offset, count, list,
                                                  n, (int)w, num_src);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const unsigned src_blocks = blocks_for(num_src * 32, kRowsThreads);
  const bool vec = d % 4 == 0 && (uintptr_t)g % 16 == 0 && (uintptr_t)grad_src % 16 == 0;
  if (vec)
    bwd_rows_kernel<true><<<src_blocks, kRowsThreads, 0, s>>>(
        (const float*)g, offset, list, deg, (float*)grad_src, num_src, (int)w, (int)d,
        (int)mean);
  else
    bwd_rows_kernel<false><<<src_blocks, kRowsThreads, 0, s>>>(
        (const float*)g, offset, list, deg, (float*)grad_src, num_src, (int)w, (int)d,
        (int)mean);
  return (int)cudaGetLastError();
}

