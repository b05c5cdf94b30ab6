// Masked CSR frontier gather (neighbor expansion), hand-written for sm_90a.
//
// Replaces the TPU kernel repro/kernels/frontier_gather/kernel.py
// (frontier_gather_pallas / _frontier_kernel).  The TPU version sweeps
// `indices` page by page with `indptr` resident in VMEM and combines the
// pages with a running min, because the TPU cannot gather at random from
// HBM.  Hopper can: this kernel reads indptr[s], indptr[s+1] and
// indices[off + k] directly and masks the ragged edge itself.
//
//   nbr[i, k]  = indices[indptr[s_i] + k] if s_i != INVALID and k < deg(s_i),
//                INVALID otherwise;
//   mask[i, k] = the same condition, as a 0/1 byte (a torch.bool tensor).
//
// Bound on the H100: bytes -- the seeds, two indptr words per valid seed
// and the valid rows' neighbor ids read once, the table and its mask
// written once (6.4 MB at the training path's deepest frontier, n = 39,208
// x D = 32, almost all of it INVALID padding).  So the kernel spends its
// time on the stores and writes both outputs in one launch:
//   - a group of D/4 lanes owns a row (8 lanes at D = 32, 16 at D = 64);
//     lane l owns slots 4l..4l+3 and writes them with one 16-byte store
//     of the table and one 4-byte store of the mask, so a warp writes
//     whole contiguous rows;
//   - row and lane come from shifts of the thread index: no division by a
//     runtime value (D is a template argument on the paths' widths);
//   - the group's first lane loads the seed and, only for a valid seed,
//     its two indptr words, and shuffles offset and capped degree to the
//     group; an INVALID row loads nothing else and goes straight to its
//     stores;
//   - a valid row's lanes load their up to 4 neighbor ids with scalar
//     loads (a row starts at any edge offset, so no vector load), the
//     group's loads contiguous.
// Any other width, or outputs not 16-byte (table) and 4-byte (mask)
// aligned, takes the generic instantiation: the same row header for a
// group of the next power of two >= D lanes (at most 32), each lane
// storing slots l, l + g, ... one at a time.  It is still one launch.
// Integer results: equal to the plain version bit for bit.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int32_t kInvalid = 0x7fffffff;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;

// The CSR offset and the degree (capped at `cap`) of row i, for the group
// of g lanes (a power of two, g <= 32) that owns it: its first lane loads
// them, 0 and 0 for an INVALID seed or a row past n, and the group gets
// them by shuffle.  Every lane of the warp must call this.
__device__ __forceinline__ void row_header(const int32_t* __restrict__ indptr,
                                           const int32_t* __restrict__ seeds, long long i,
                                           long long n, int g, int cap, int& off, int& deg) {
  off = 0;
  deg = 0;
  if ((threadIdx.x & (g - 1)) == 0 && i < n) {
    const int32_t s = __ldg(seeds + i);
    if (s != kInvalid) {
      off = __ldg(indptr + s);
      deg = min(__ldg(indptr + s + 1) - off, cap);
    }
  }
  off = __shfl_sync(kFull, off, 0, g);
  deg = __shfl_sync(kFull, deg, 0, g);
}

// D % 4 == 0 and 4 <= D <= 128: D/4 lanes a row, 4 slots a lane.
template <int D>
__global__ void __launch_bounds__(kThreads)
frontier_gather_vec_kernel(const int32_t* __restrict__ indptr,
                           const int32_t* __restrict__ indices,
                           const int32_t* __restrict__ seeds, int32_t* __restrict__ nbr,
                           uint8_t* __restrict__ mask, long long n) {
  constexpr int G = D / 4;
  static_assert(D % 4 == 0 && G >= 1 && G <= 32 && (G & (G - 1)) == 0, "D/4 lanes a row");
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long i = t / G;  // a shift: G is a power of two
  const int k0 = 4 * (int)(t & (G - 1));
  int off, deg;
  row_header(indptr, seeds, i, n, G, D, off, deg);
  if (i >= n) return;
  int v[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) v[q] = k0 + q < deg ? __ldg(indices + off + k0 + q) : kInvalid;
  uint32_t m = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q) m |= (uint32_t)(k0 + q < deg) << (8 * q);
  const long long o = i * D + k0;
  *reinterpret_cast<int4*>(nbr + o) = make_int4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<uint32_t*>(mask + o) = m;
}

// Any D >= 1: a group of g = 1 << lg lanes a row (the next power of two
// >= D, at most 32); lane l stores slots l, l + g, ...
__global__ void __launch_bounds__(kThreads)
frontier_gather_any_kernel(const int32_t* __restrict__ indptr,
                           const int32_t* __restrict__ indices,
                           const int32_t* __restrict__ seeds, int32_t* __restrict__ nbr,
                           uint8_t* __restrict__ mask, long long n, int D, int lg) {
  const int g = 1 << lg;
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long i = t >> lg;
  int off, deg;
  row_header(indptr, seeds, i, n, g, D, off, deg);
  if (i >= n) return;
  const long long o = i * D;
  for (int k = (int)(t & (g - 1)); k < D; k += g) {
    const bool valid = k < deg;
    nbr[o + k] = valid ? __ldg(indices + off + k) : kInvalid;
    mask[o + k] = valid;
  }
}

}  // namespace

// indptr: (V+1,) int32; indices: (E,) int32; seeds: (n,) int32, INVALID
// padded, ids in [0, V); nbr: (n, max_degree) int32; mask: (n,
// max_degree) bytes; n >= 1, max_degree >= 1.  The vector instantiations
// run only on aligned outputs, checked here.
extern "C" int frontier_gather_launch(const void* indptr, const void* indices,
                                      const void* seeds, void* nbr, void* mask,
                                      long long n, long long max_degree, void* stream) {
  const auto* ip = (const int32_t*)indptr;
  const auto* ind = (const int32_t*)indices;
  const auto* sd = (const int32_t*)seeds;
  auto* out = (int32_t*)nbr;
  auto* m = (uint8_t*)mask;
  const bool aligned = (uintptr_t)nbr % 16 == 0 && (uintptr_t)mask % 4 == 0;
  const cudaStream_t s = (cudaStream_t)stream;
  auto blocks = [](long long lanes) { return (unsigned)((lanes + kThreads - 1) / kThreads); };
  if (aligned && max_degree == 32) {
    frontier_gather_vec_kernel<32><<<blocks(n * 8), kThreads, 0, s>>>(ip, ind, sd, out, m, n);
  } else if (aligned && max_degree == 64) {
    frontier_gather_vec_kernel<64><<<blocks(n * 16), kThreads, 0, s>>>(ip, ind, sd, out, m, n);
  } else {
    int lg = 0;
    while (lg < 5 && (1LL << lg) < max_degree) ++lg;
    frontier_gather_any_kernel<<<blocks(n << lg), kThreads, 0, s>>>(ip, ind, sd, out, m, n,
                                                                     (int)max_degree, lg);
  }
  return (int)cudaGetLastError();
}
