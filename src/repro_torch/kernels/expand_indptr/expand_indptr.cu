// CSR indptr expansion: the row id of every edge slot, hand-written for
// sm_90a.
//
// Replaces the TPU kernel repro/kernels/expand_indptr/kernel.py
// (expand_indptr_pallas / _expand_kernel).  The TPU version compares a
// (block_e,) tile of slot ids against the whole VMEM-resident indptr, a
// (block_e, R+1) comparison matrix per tile, and needs num_edges to be a
// multiple of block_e.  There is no block-multiple constraint here.
//
// rows[e] = (number of r with indptr[r] <= e) - 1 if e < indptr[R], else -1.
//
// Bound on the H100: bytes -- indptr read once and 4 bytes written per
// slot, almost all of it the output (5 MB at the training path's layer 2,
// R = 39,208, with most slots past indptr[R]).  A binary search per slot
// is 16 dependent loads at that R, a latency chain far longer than the
// bound, so the kernel searches as little as it can and writes in 16-byte
// stores:
//   - each thread owns a run of 4 consecutive slots and writes them with
//     one 16-byte store (scalar stores for the last num_edges % 4);
//   - each warp reads indptr[0] and indptr[R] (one broadcast load each);
//     a warp whose 128 slots all lie at or past indptr[R] writes -1s and
//     searches nothing;
//   - otherwise the warp finds the rows of its first slot and of its last
//     slot that holds an edge together: each round its 32 lanes probe 64
//     evenly spaced entries and two ballots keep the step that holds the
//     boundary, so ceil(log64(R)) rounds of spread loads (3 at R =
//     39,208, 1 at R = 64) replace 16 dependent ones;
//   - each lane then finds its 4 slots' rows between those two rows, a
//     range of a few lines of indptr the warp has just read, by binary
//     lifting: log2 of the range's rows (runs of empty rows included)
//     steps, the 4 slots' loads of a step in flight together.
// Integer results: equal to the plain version (torch.searchsorted) bit
// for bit.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kRun = 4;  // slots per thread: one int4 store

// The rows of slots ea <= eb, both in [indptr[0], indptr[len - 1]),
// searched by the whole warp at once.  A round narrows each key's range
// [lo, hi), with indptr[lo] <= e < indptr[hi], 64 times: the 32 lanes
// probe 64 evenly spaced entries, lane l the (l + 1)-th and (l + 33)-th,
// and the ballots count the probes <= e (a prefix of them, indptr being
// ascending).  All 4 of a lane's loads of a round are in flight together.
__device__ __forceinline__ void warp_rows(const int32_t* __restrict__ indptr, int len, int ea,
                                          int eb, int& ra, int& rb) {
  const int lane = threadIdx.x & 31;
  int lo[2] = {0, 0}, hi[2] = {len - 1, len - 1};
  const int key[2] = {ea, eb};
  while (hi[0] - lo[0] > 1 || hi[1] - lo[1] > 1) {
    int step[2];
    bool le[2][2];
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      step[t] = (hi[t] - lo[t] + 63) >> 6;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = lo[t] + (lane + 1 + 32 * h) * step[t];
        le[t][h] = p < hi[t] && __ldg(indptr + p) <= key[t];
      }
    }
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      if (hi[t] - lo[t] > 1) {
        const int cnt = __popc(__ballot_sync(kFull, le[t][0])) +
                        __popc(__ballot_sync(kFull, le[t][1]));
        hi[t] = min(hi[t], lo[t] + (cnt + 1) * step[t]);
        lo[t] += cnt * step[t];
      }
    }
  }
  ra = lo[0];
  rb = lo[1];
}

// Slots and rows are ints: the wrapper keeps num_edges + 128 below 2^31.
__global__ void __launch_bounds__(kThreads)
expand_indptr_kernel(const int32_t* __restrict__ indptr, int32_t* __restrict__ rows,
                     int num_edges, int len) {
  const int e0 = (blockIdx.x * kThreads + threadIdx.x) * kRun;
  const int w0 = e0 - (threadIdx.x & 31) * kRun;  // the warp's first slot
  if (w0 >= num_edges) return;  // the whole warp
  // the warp's first and last slots in [indptr[0], indptr[R]) (one broadcast
  // load each); the slots outside are -1
  const int ws = max(w0, __ldg(indptr));
  const int wl = min(w0 + 32 * kRun, min(num_edges, __ldg(indptr + len - 1))) - 1;
  int out[kRun] = {-1, -1, -1, -1};
  if (ws <= wl) {  // the whole warp
    int r0, r1;
    warp_rows(indptr, len, ws, wl, r0, r1);
    // Every slot in [ws, wl] lies in a row of [r0, r1]: binary lifting from
    // r0 by warp-uniform steps, the 4 slots' loads of a step in flight
    // together (lines the warp's last rounds have just read).
    int pos[kRun] = {r0, r0, r0, r0};
    for (int step = r1 > r0 ? 1 << (31 - __clz(r1 - r0)) : 0; step > 0; step >>= 1) {
      int v[kRun];
#pragma unroll
      for (int q = 0; q < kRun; ++q) v[q] = pos[q] + step <= r1 ? __ldg(indptr + pos[q] + step) : 0;
#pragma unroll
      for (int q = 0; q < kRun; ++q)
        if (pos[q] + step <= r1 && v[q] <= e0 + q) pos[q] += step;
    }
#pragma unroll
    for (int q = 0; q < kRun; ++q)
      if (e0 + q >= ws && e0 + q <= wl) out[q] = pos[q];
  }
  if (e0 + kRun <= num_edges) {
    *reinterpret_cast<int4*>(rows + e0) = make_int4(out[0], out[1], out[2], out[3]);
  } else {
#pragma unroll
    for (int q = 0; q < kRun; ++q)
      if (e0 + q < num_edges) rows[e0 + q] = out[q];
  }
}

}  // namespace

// indptr: (len,) int32 ascending, len >= 1; rows: (num_edges,) int32,
// 16-byte aligned; num_edges + 128 < 2^31.
extern "C" int expand_indptr_launch(const void* indptr, void* rows, long long num_edges,
                                    long long len, void* stream) {
  const long long threads = (num_edges + kRun - 1) / kRun;
  const unsigned blocks = (unsigned)((threads + kThreads - 1) / kThreads);
  expand_indptr_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)indptr, (int32_t*)rows, (int)num_edges, (int)len);
  return (int)cudaGetLastError();
}
