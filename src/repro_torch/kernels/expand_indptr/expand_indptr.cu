// CSR indptr expansion: the row id of every edge slot, hand-written for
// sm_90a.
//
// Replaces the TPU kernel repro/kernels/expand_indptr/kernel.py
// (expand_indptr_pallas / _expand_kernel).  The TPU version compares a
// (block_e,) tile of slot ids against the whole VMEM-resident indptr, a
// (block_e, R+1) comparison matrix per tile, and needs num_edges to be a
// multiple of block_e.  Here one thread per edge slot e binary-searches
// indptr (read through L1/L2: its R+1 int32s are shared by all threads)
// for the number of entries <= e; there is no block-multiple constraint.
//
// rows[e] = (number of r with indptr[r] <= e) - 1 if e < indptr[R], else -1.
//
// Bound on the H100: bytes (indptr read once, 4 bytes written per slot);
// a search of log2(R+1) compares per slot is far below the integer rate.
// Integer results: equal to the plain version (torch.searchsorted) bit
// for bit.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

__global__ void expand_indptr_kernel(const int32_t* __restrict__ indptr,
                                     int32_t* __restrict__ rows, long long num_edges,
                                     long long len) {
  long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (e >= num_edges) return;
  if (e >= (long long)__ldg(indptr + len - 1)) {
    rows[e] = -1;
    return;
  }
  // upper bound: the first position whose entry is > e
  long long lo = 0, hi = len;
  while (lo < hi) {
    long long mid = (lo + hi) >> 1;
    if ((long long)__ldg(indptr + mid) <= e) lo = mid + 1;
    else hi = mid;
  }
  rows[e] = (int32_t)(lo - 1);
}

}  // namespace

// indptr: (len,) int32 ascending, len >= 1; rows: (num_edges,) int32.
extern "C" int expand_indptr_launch(const void* indptr, void* rows, long long num_edges,
                                    long long len, void* stream) {
  const int threads = 256;
  unsigned blocks = (unsigned)((num_edges + threads - 1) / threads);
  expand_indptr_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)indptr, (int32_t*)rows, num_edges, len);
  return (int)cudaGetLastError();
}
