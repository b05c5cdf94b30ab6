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
// Bound on the H100: bytes, n * (8 + 4) plus 4W per set read and the
// 4-byte output -- under 0.1 us at the serving path's few thousand ids,
// W = 8.  What costs time at that size is the chain of dependent loads
// per id, so the kernel keeps it at two round trips: the id and its set,
// then all W tags of the set at once, before any compare.  At the cache's
// width, W = 8, with a 16-byte aligned tag array, that is two 16-byte
// loads; the compares make a bit mask of the matching ways and its lowest
// set bit is the first match.  Any other W or alignment takes the generic
// kernel: W independent scalar loads, unrolled by 8, with the first match
// kept by a select.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;

// W ways (W % 4 == 0, W <= 32) of a 16-byte aligned tag array.
template <int W>
__global__ void __launch_bounds__(kThreads)
tag_probe_kernel(const int32_t* __restrict__ tags, const int32_t* __restrict__ sets,
                 const int32_t* __restrict__ ids, int32_t* __restrict__ out, long long n) {
  static_assert(W % 4 == 0 && W <= 32, "W ways in 16-byte loads and one mask word");
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const int32_t* row = tags + (long long)__ldg(sets + i) * W;
  const int32_t id = __ldg(ids + i);
  int32_t t[W];
#pragma unroll
  for (int q = 0; q < W / 4; ++q) {
    const int4 v = __ldg(reinterpret_cast<const int4*>(row) + q);
    t[4 * q] = v.x;
    t[4 * q + 1] = v.y;
    t[4 * q + 2] = v.z;
    t[4 * q + 3] = v.w;
  }
  uint32_t hit = 0;
#pragma unroll
  for (int w = 0; w < W; ++w) hit |= (uint32_t)(t[w] == id) << w;
  out[i] = hit ? __ffs(hit) - 1 : -1;
}

// Any W >= 1: the loads of a run of 8 ways are independent of every
// compare; the ways are walked from the last, so the last match kept is
// the first way.
__global__ void __launch_bounds__(kThreads)
tag_probe_any_kernel(const int32_t* __restrict__ tags, const int32_t* __restrict__ sets,
                     const int32_t* __restrict__ ids, int32_t* __restrict__ out, long long n,
                     int ways) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const int32_t* row = tags + (long long)__ldg(sets + i) * ways;
  const int32_t id = __ldg(ids + i);
  int way = -1;
#pragma unroll 8
  for (int w = ways - 1; w >= 0; --w) way = __ldg(row + w) == id ? w : way;
  out[i] = way;
}

}  // namespace

// tags: (S, ways) int32; sets, ids, out: (n,) int32, sets in [0, S); n >= 1.
// The tag rows' alignment is checked here (a view may start anywhere).
extern "C" int tag_probe_launch(const void* tags, const void* sets,
                                const void* ids, void* out, long long n,
                                long long ways, void* stream) {
  const auto* tg = (const int32_t*)tags;
  const auto* st = (const int32_t*)sets;
  const auto* id = (const int32_t*)ids;
  auto* o = (int32_t*)out;
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  const cudaStream_t s = (cudaStream_t)stream;
  if (ways == 8 && (uintptr_t)tags % 16 == 0) {
    tag_probe_kernel<8><<<blocks, kThreads, 0, s>>>(tg, st, id, o, n);
  } else {
    tag_probe_any_kernel<<<blocks, kThreads, 0, s>>>(tg, st, id, o, n, (int)ways);
  }
  return (int)cudaGetLastError();
}
