// Masked CSR frontier gather (neighbor expansion), hand-written for sm_90a.
//
// Replaces the TPU kernel repro/kernels/frontier_gather/kernel.py
// (frontier_gather_pallas / _frontier_kernel).  The TPU version sweeps
// `indices` page by page with `indptr` resident in VMEM and combines the
// pages with a running min, because the TPU cannot gather at random from
// HBM.  Hopper can: this kernel reads indptr[s], indptr[s+1] and
// indices[off + k] directly and masks the ragged edge itself.
//
// Work: one thread per (seed, slot); the threads of a row are adjacent,
// so a row's neighbor ids are one coalesced read.  Bound on the H100: at
// serving shapes (n <= 480 seeds x 64 slots, ~120 KiB of output) it is
// bound by launch latency, not by the ~3.35 TB/s of HBM; at large n it is
// bound by bytes (the output write plus the scattered index reads).
//
// out[i, k] = indices[indptr[s_i] + k] if s_i != INVALID and k < deg(s_i),
//             INVALID otherwise.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int32_t kInvalid = 0x7fffffff;

__global__ void frontier_gather_kernel(const int32_t* __restrict__ indptr,
                                       const int32_t* __restrict__ indices,
                                       const int32_t* __restrict__ seeds,
                                       int32_t* __restrict__ out,
                                       long long total, int max_degree) {
  long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (t >= total) return;
  long long i = t / max_degree;
  int k = (int)(t - i * max_degree);
  int32_t s = seeds[i];
  int32_t v = kInvalid;
  if (s != kInvalid) {
    int32_t off = __ldg(indptr + s);
    int32_t deg = __ldg(indptr + s + 1) - off;
    if (k < deg) v = __ldg(indices + off + k);
  }
  out[t] = v;
}

}  // namespace

extern "C" int frontier_gather_launch(const void* indptr, const void* indices,
                                      const void* seeds, void* out,
                                      long long n, long long max_degree,
                                      void* stream) {
  long long total = n * max_degree;
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  frontier_gather_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)indptr, (const int32_t*)indices, (const int32_t*)seeds,
      (int32_t*)out, total, (int)max_degree);
  return (int)cudaGetLastError();
}
