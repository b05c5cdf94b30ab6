// Batched set-associative tag probe (device cache lookup), for sm_90a.
//
// Replaces the TPU kernel repro/store/kernel.py (tag_probe_pallas /
// _probe_kernel).  The TPU version sweeps the tag array page by page
// and max-combines, with -2/-1 padding, because it cannot read rows of
// `tags` at random.  Here one thread per id reads its set's W tags
// directly and returns the first matching way.
//
//   out[i] = first w with tags[sets[i], w] == ids[i], else -1.
//
// Bound on the H100: at serving shapes (a few thousand ids, W = 8) it is
// bound by launch latency; the bytes are n * (8 + 4 + 4W) plus the
// 4-byte output.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

__global__ void tag_probe_kernel(const int32_t* __restrict__ tags,
                                 const int32_t* __restrict__ sets,
                                 const int32_t* __restrict__ ids,
                                 int32_t* __restrict__ out, long long n,
                                 int ways) {
  long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int32_t* row = tags + (long long)sets[i] * ways;
  const int32_t id = ids[i];
  int way = -1;
  for (int w = 0; w < ways; ++w) {
    if (__ldg(row + w) == id) {
      way = w;
      break;
    }
  }
  out[i] = way;
}

}  // namespace

extern "C" int tag_probe_launch(const void* tags, const void* sets,
                                const void* ids, void* out, long long n,
                                long long ways, void* stream) {
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  tag_probe_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)tags, (const int32_t*)sets, (const int32_t*)ids,
      (int32_t*)out, n, (int)ways);
  return (int)cudaGetLastError();
}
