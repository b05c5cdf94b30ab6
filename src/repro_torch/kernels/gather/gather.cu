// Masked embedding-row gather (feature loading), hand-written for sm_90a.
//
// Replaces the TPU kernel repro/kernels/gather/kernel.py:49
// (paged_gather_pallas / _gather_kernel).  The TPU version sweeps the
// whole table page by page through VMEM and accumulates the rows that
// fall in each page, because the TPU cannot gather at random from HBM.
// Hopper can: each valid row is one direct read.
//
// out[i, :] = table[ids[i], :] if 0 <= ids[i] < V, else a zero row
// (INVALID = int32 max is out of range, so padding comes back zero).
//
// Bound on the H100: bytes, and on the training paths the bytes written.
// The R-GCN's input gather writes a (1,048,576, 768) float32 output (3.2
// GB) of which 98.5% of the rows are padding, and reads 49.5 MB of valid
// rows.  So the kernel is a store stream, and the design removes what
// stood between the card and that stream:
//   - a group of G = min(32, next power of two >= c) lanes owns a row
//     (c = d/4 float4 columns, or d floats on the generic path): a warp a
//     row at d = 768, two rows a warp at d = 64.  Row and column come from
//     the warp, group and lane index by shifts (G is a template argument);
//     there is no division, and 64-bit arithmetic only in a row's base;
//   - a warp takes one step of 32/G groups x R rows (R = 4), the step's
//     ids in one coalesced load, each row's id shuffled to its group (one
//     id load per row, not one per thread);
//   - a lane first issues all its loads for its R rows (K columns a row:
//     6 float4 a lane a row at d = 768), then all its stores: several
//     rows' bytes in flight per thread;
//   - the padding test is group-uniform: a padding row stores zeros and
//     reads nothing beyond its one id;
//   - the output is written with streaming stores (st.global.cs), so 3.2
//     GB of writes evict first and compete less in L2 with the table rows;
//   - consecutive warps take consecutive steps and each warp one step, so
//     the rows being written at any time are one contiguous front, as in
//     a fill.  On the H100 a persistent grid walking the steps grid-stride,
//     or a warp owning 32 consecutive rows, was slower (PERF.md).
// d % 4 != 0, or a table or output not 16-byte aligned, takes the same
// kernel on floats (T = float).  It copies values: the result equals the
// plain version bit for bit.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// Rows a group takes in a step (a warp's step is 32 / G groups x R rows,
// at most 32, one id a lane).
__host__ __device__ constexpr int rows_a_step(int g) { return g < 4 ? g : 4; }

// T: float4 (c = d/4 columns a row) or float (c = d).  G lanes a row (a
// power of two, at most 32); K columns a lane loads for each of its R rows
// before it stores them (a loop over chunks of K * G columns covers any c).
template <typename T, int G, int K>
__global__ void __launch_bounds__(kThreads)
gather_kernel(const T* __restrict__ table, const int32_t* __restrict__ ids,
              T* __restrict__ out, long long n, int c, long long num_rows) {
  constexpr int R = rows_a_step(G);
  constexpr int kStep = 32 / G * R;
  static_assert(G >= 1 && G <= 32 && (G & (G - 1)) == 0, "G lanes a row");
  static_assert(kStep <= 32, "one id a lane");
  const int lane = threadIdx.x & 31;
  const int r0 = lane / G * R;  // the group's first row in the step (shifts)
  const int l = lane & (G - 1);
  const long long base = (((long long)blockIdx.x * kThreads + threadIdx.x) >> 5) * kStep;
  const int32_t my_id = lane < kStep && base + lane < n ? __ldg(ids + base + lane) : -1;
  const T* src[R];
  bool valid[R];
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int32_t id = __shfl_sync(kFull, my_id, r0 + j);
    valid[j] = id >= 0 && id < num_rows;  // uniform over the group
    src[j] = table + (long long)(valid[j] ? id : 0) * c;
  }
#pragma unroll 1
  for (int c0 = l; c0 < c; c0 += K * G) {
    T v[R][K];
#pragma unroll
    for (int j = 0; j < R; ++j) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int col = c0 + k * G;
        v[j][k] = valid[j] && col < c ? __ldg(src[j] + col) : T{};
      }
    }
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const long long row = base + r0 + j;
      if (row < n) {
        T* dst = out + row * c;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const int col = c0 + k * G;
          if (col < c) __stcs(dst + col, v[j][k]);
        }
      }
    }
  }
}

template <typename T>
using Kernel = void (*)(const T*, const int32_t*, T*, long long, int, long long);

// The instantiation for G lanes a row and K columns a lane: G < 32 has
// K = 1 (a row's c <= G columns), G = 32 any K in 1..8; else null.
template <typename T>
Kernel<T> pick(long long g, long long k) {
  if (k == 1) {
    switch (g) {
      case 1: return gather_kernel<T, 1, 1>;
      case 2: return gather_kernel<T, 2, 1>;
      case 4: return gather_kernel<T, 4, 1>;
      case 8: return gather_kernel<T, 8, 1>;
      case 16: return gather_kernel<T, 16, 1>;
      case 32: return gather_kernel<T, 32, 1>;
    }
  } else if (g == 32) {
    switch (k) {
      case 2: return gather_kernel<T, 32, 2>;
      case 3: return gather_kernel<T, 32, 3>;
      case 4: return gather_kernel<T, 32, 4>;
      case 5: return gather_kernel<T, 32, 5>;
      case 6: return gather_kernel<T, 32, 6>;
      case 7: return gather_kernel<T, 32, 7>;
      case 8: return gather_kernel<T, 32, 8>;
    }
  }
  return nullptr;
}

// One step a warp: a grid of n / (warps a block x rows a step) blocks.
template <typename T>
int launch(const void* table, const void* ids, void* out, long long n, int c,
           long long num_rows, long long g, long long k, cudaStream_t stream) {
  const Kernel<T> f = pick<T>(g, k);
  if (f == nullptr) return (int)cudaErrorInvalidValue;
  const long long rows = (long long)kWarps * (32 / g) * rows_a_step((int)g);
  const long long blocks = (n + rows - 1) / rows;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  f<<<(unsigned)blocks, kThreads, 0, stream>>>((const T*)table, (const int32_t*)ids, (T*)out,
                                               n, c, num_rows);
  return (int)cudaGetLastError();
}

}  // namespace

// table: (V, d) float32; ids: (n,) int32; out: (n, d) float32; n, d >= 1.
// vec4 != 0: float4 columns (d % 4 == 0 and table/out 16-byte aligned,
// checked here).  group: lanes a row; k: columns a lane per row in
// flight.
extern "C" int gather_launch(const void* table, const void* ids, void* out, long long n,
                             long long d, long long num_rows, long long vec4, long long group,
                             long long k, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (vec4) {
    if (d % 4 || (uintptr_t)table % 16 || (uintptr_t)out % 16) return (int)cudaErrorInvalidValue;
    return launch<float4>(table, ids, out, n, (int)(d / 4), num_rows, group, k, s);
  }
  return launch<float>(table, ids, out, n, (int)d, num_rows, group, k, s);
}
