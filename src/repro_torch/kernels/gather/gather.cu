// Masked embedding-row gather (feature loading), hand-written for sm_90a.
//
// Replaces the TPU kernel repro/kernels/gather/kernel.py
// (paged_gather_pallas / _gather_kernel).  The TPU version sweeps the
// whole table page by page through VMEM and accumulates the rows that
// fall in each page, because the TPU cannot gather at random from HBM.
// Hopper can: each output element is one direct load.
//
// out[i, :] = table[ids[i], :] if 0 <= ids[i] < V, else a zero row
// (INVALID = int32 max is out of range, so padding comes back zero).
//
// Work: one thread per 16-byte float4 of an output row when d % 4 == 0
// and both rows are 16-byte aligned (d = 64: 16 threads, half a warp, per
// row), else one thread per float.  The threads of a row are adjacent, so
// a row is one coalesced read and one coalesced write.  Bound on the
// H100: bytes (the ids, the touched table rows and the output over
// ~3.35 TB/s); there is no arithmetic.  The result equals the plain
// version bit for bit: it copies values.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

template <typename T>
__global__ void gather_kernel(const T* __restrict__ table,
                              const int32_t* __restrict__ ids,
                              T* __restrict__ out, long long total,
                              int row_elems, long long num_rows) {
  long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (t >= total) return;
  long long i = t / row_elems;
  int c = (int)(t - i * row_elems);
  int32_t id = __ldg(ids + i);
  T v = T{};
  if (id >= 0 && id < num_rows) v = __ldg(table + (long long)id * row_elems + c);
  out[t] = v;
}

template <typename T>
int launch(const void* table, const void* ids, void* out, long long n,
           int row_elems, long long num_rows, cudaStream_t stream) {
  long long total = n * row_elems;
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  gather_kernel<T><<<(unsigned)blocks, threads, 0, stream>>>(
      (const T*)table, (const int32_t*)ids, (T*)out, total, row_elems, num_rows);
  return (int)cudaGetLastError();
}

}  // namespace

// vec4 != 0: d % 4 == 0 and table/out 16-byte aligned (checked by the caller).
extern "C" int gather_launch(const void* table, const void* ids, void* out,
                             long long n, long long d, long long num_rows,
                             long long vec4, void* stream) {
  if (vec4)
    return launch<float4>(table, ids, out, n, (int)(d / 4), num_rows,
                          (cudaStream_t)stream);
  return launch<float>(table, ids, out, n, (int)d, num_rows, (cudaStream_t)stream);
}
