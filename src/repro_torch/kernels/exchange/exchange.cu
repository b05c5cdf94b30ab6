// Valid-rows exchange of the single-device cooperative executor, for sm_90a.
//
// Replaces no TPU kernel.  The JAX package's SimExecutor redistributes a
// layer's embeddings as a chain of XLA ops: a (P, P, cap_bucket, d) gather
// of every bucket slot, an axis swap (the all-to-all), and a scatter of
// every slot into the requester's rows.  At the input layer of the
// papers100M cell that moves 25.9M slots of which 6.6% hold a row.  With
// all PEs on one card the three compose into one index map:
//
//   out[p, slot_to_tilde[p, q, s]] = H[q, req_idx[q, p, s]]
//
// for every slot with both indices valid, and a zero row for every other
// output row.  Three kernels:
//
//   - exchange_invert_kernel: a thread a slot turns the plan's two tables
//     into one source row for each output row (fwd_src, flat rows of H)
//     and, for a layer whose H takes a gradient, the P requesters of each
//     row of H (bwd_src, flat rows of the output, -1 where peer p did not
//     ask).  Each tilde row is the target of at most one slot, and each
//     row of H at most once a peer (a peer's bucket holds distinct ids),
//     so the int32 stores never collide: no atomics.
//   - exchange_fwd_kernel: out[i] = H[fwd_src[i]], or a zero row.  One
//     pass writes the whole output, in order, as a store stream: the row
//     geometry of gather.cu (a group of G lanes a row, G the next power of
//     two >= its float4 or float columns, at most 32; R rows a group in a
//     step, their ids in one coalesced load and shuffled; all loads, then
//     streaming stores).  It copies values: bit for bit the plain version.
//   - exchange_bwd_kernel: grad_H[i] = sum over p ascending of
//     grad_out[bwd_src[i, p]] (+0.0 for a missing peer), the same adds in
//     the same order as the plain version, so equal to it bit for bit and
//     the same bits from run to run.  A row nobody requested is zero.
//
// Offsets into the float arrays are 64-bit (the output passes 2^31 floats
// at papers100M's batch 512); row ids are int32, checked by the wrapper.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// Rows a group takes in a step (a warp's step is 32 / G groups x R rows,
// at most 32, one id a lane in the forward).
__host__ __device__ constexpr int rows_a_step(int g) { return g < 4 ? g : 4; }

__device__ __forceinline__ float add(float a, float b) { return a + b; }
__device__ __forceinline__ float4 add(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// Grid (ceil(cap_b / kThreads), P * P): blockIdx.y = p * P + q, the bucket
// PE p sent to owner q; req_idx[q, p] holds owner q's rows for it.
__global__ void __launch_bounds__(kThreads)
exchange_invert_kernel(const int32_t* __restrict__ slot_to_tilde,
                       const int32_t* __restrict__ req_idx, int32_t* __restrict__ fwd_src,
                       int32_t* __restrict__ bwd_src, int P, long long cap_b,
                       long long cap_tilde, long long cap_next) {
  const long long s = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (s >= cap_b) return;
  const int p = blockIdx.y / P;
  const int q = blockIdx.y - p * P;
  const int32_t t = __ldg(slot_to_tilde + (long long)blockIdx.y * cap_b + s);
  if (t < 0 || t >= cap_tilde) return;  // padding: the bucket's tail
  const int32_t r = __ldg(req_idx + ((long long)q * P + p) * cap_b + s);
  if (r < 0 || r >= cap_next) return;   // the owner dropped the id
  fwd_src[p * cap_tilde + t] = (int32_t)(q * cap_next + r);
  if (bwd_src != nullptr) bwd_src[(q * cap_next + r) * P + p] = (int32_t)(p * cap_tilde + t);
}

// T: float4 (c = d/4 columns a row) or float (c = d).  One source a row:
// out[row] = table[src[row]] where 0 <= src[row] < num_rows, else zeros.
template <typename T, int G, int K>
__global__ void __launch_bounds__(kThreads)
exchange_fwd_kernel(const T* __restrict__ table, const int32_t* __restrict__ src,
                    T* __restrict__ out, long long n, int ways, int c, long long num_rows) {
  constexpr int R = rows_a_step(G);
  constexpr int kStep = 32 / G * R;
  static_assert(G >= 1 && G <= 32 && (G & (G - 1)) == 0, "G lanes a row");
  static_assert(kStep <= 32, "one id a lane");
  const int lane = threadIdx.x & 31;
  const int r0 = lane / G * R;  // the group's first row in the step
  const int l = lane & (G - 1);
  const long long base = (((long long)blockIdx.x * kThreads + threadIdx.x) >> 5) * kStep;
  const int32_t my_id = lane < kStep && base + lane < n ? __ldg(src + base + lane) : -1;
  const T* from[R];
  bool valid[R];
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int32_t id = __shfl_sync(kFull, my_id, r0 + j);
    valid[j] = id >= 0 && id < num_rows;  // uniform over the group
    from[j] = table + (long long)(valid[j] ? id : 0) * c;
  }
#pragma unroll 1
  for (int c0 = l; c0 < c; c0 += K * G) {
    T v[R][K];
#pragma unroll
    for (int j = 0; j < R; ++j) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int col = c0 + k * G;
        v[j][k] = valid[j] && col < c ? __ldg(from[j] + col) : T{};
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

// `ways` sources a row (src is (n, ways)): out[row] = the sum over w
// ascending of table[src[row, w]], +0.0 for a source out of range,
// starting from +0.0.
template <typename T, int G, int K>
__global__ void __launch_bounds__(kThreads)
exchange_bwd_kernel(const T* __restrict__ table, const int32_t* __restrict__ src,
                    T* __restrict__ out, long long n, int ways, int c, long long num_rows) {
  constexpr int R = rows_a_step(G);
  constexpr int kStep = 32 / G * R;
  static_assert(G >= 1 && G <= 32 && (G & (G - 1)) == 0, "G lanes a row");
  const int lane = threadIdx.x & 31;
  const int r0 = lane / G * R;
  const int l = lane & (G - 1);
  const long long base = (((long long)blockIdx.x * kThreads + threadIdx.x) >> 5) * kStep;
#pragma unroll 1
  for (int c0 = l; c0 < c; c0 += K * G) {
    T acc[R][K];
#pragma unroll
    for (int j = 0; j < R; ++j) {
#pragma unroll
      for (int k = 0; k < K; ++k) acc[j][k] = T{};
    }
#pragma unroll 1
    for (int w = 0; w < ways; ++w) {
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const long long row = base + r0 + j;
        // the group's lanes read one address: one load a group
        const int32_t id = row < n ? __ldg(src + row * ways + w) : -1;
        const bool ok = id >= 0 && id < num_rows;
        const T* from = table + (long long)(ok ? id : 0) * c;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const int col = c0 + k * G;
          acc[j][k] = add(acc[j][k], ok && col < c ? __ldg(from + col) : T{});
        }
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
          if (col < c) __stcs(dst + col, acc[j][k]);
        }
      }
    }
  }
}

template <typename T>
using Kernel = void (*)(const T*, const int32_t*, T*, long long, int, int, long long);

template <typename T, bool kBwd, int G, int K>
Kernel<T> rows_kernel() {
  if constexpr (kBwd) {
    return exchange_bwd_kernel<T, G, K>;
  } else {
    return exchange_fwd_kernel<T, G, K>;
  }
}

// The instantiation for G lanes a row and K columns a lane: G < 32 has
// K = 1 (a row's c <= G columns), G = 32 any K in 1..8 (1..4 in the
// backward, whose lanes hold a sum and a load a column); else null.
template <typename T, bool kBwd>
Kernel<T> pick(long long g, long long k) {
  if (k == 1) {
    switch (g) {
      case 1: return rows_kernel<T, kBwd, 1, 1>();
      case 2: return rows_kernel<T, kBwd, 2, 1>();
      case 4: return rows_kernel<T, kBwd, 4, 1>();
      case 8: return rows_kernel<T, kBwd, 8, 1>();
      case 16: return rows_kernel<T, kBwd, 16, 1>();
      case 32: return rows_kernel<T, kBwd, 32, 1>();
    }
  } else if (g == 32) {
    switch (k) {
      case 2: return rows_kernel<T, kBwd, 32, 2>();
      case 3: return rows_kernel<T, kBwd, 32, 3>();
      case 4: return rows_kernel<T, kBwd, 32, 4>();
    }
    if (!kBwd) {
      switch (k) {
        case 5: return rows_kernel<T, false, 32, 5>();
        case 6: return rows_kernel<T, false, 32, 6>();
        case 7: return rows_kernel<T, false, 32, 7>();
        case 8: return rows_kernel<T, false, 32, 8>();
      }
    }
  }
  return nullptr;
}

// One step a warp: a grid of n / (warps a block x rows a step) blocks.
template <typename T, bool kBwd>
int launch_rows(const void* table, const void* src, void* out, long long n, long long ways,
                long long d, long long num_rows, long long vec4, long long g, long long k,
                cudaStream_t stream) {
  const Kernel<T> f = pick<T, kBwd>(g, k);
  if (f == nullptr || ways < 1 || (!kBwd && ways != 1)) return (int)cudaErrorInvalidValue;
  const long long rows = (long long)kWarps * (32 / g) * rows_a_step((int)g);
  const long long blocks = (n + rows - 1) / rows;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int c = (int)(vec4 ? d / 4 : d);
  f<<<(unsigned)blocks, kThreads, 0, stream>>>((const T*)table, (const int32_t*)src, (T*)out,
                                               n, (int)ways, c, num_rows);
  return (int)cudaGetLastError();
}

template <bool kBwd>
int launch(const void* table, const void* src, void* out, long long n, long long ways,
           long long d, long long num_rows, long long vec4, long long g, long long k,
           void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (vec4) {
    if (d % 4 || (uintptr_t)table % 16 || (uintptr_t)out % 16) return (int)cudaErrorInvalidValue;
    return launch_rows<float4, kBwd>(table, src, out, n, ways, d, num_rows, vec4, g, k, s);
  }
  return launch_rows<float, kBwd>(table, src, out, n, ways, d, num_rows, vec4, g, k, s);
}

}  // namespace

// slot_to_tilde, req_idx: (P, P, cap_b) int32; fwd_src: (P, cap_tilde) int32
// and bwd_src (P, cap_next, P) int32 (or null), both filled with -1 before.
extern "C" int exchange_invert_launch(const void* slot_to_tilde, const void* req_idx,
                                      void* fwd_src, void* bwd_src, long long P,
                                      long long cap_b, long long cap_tilde, long long cap_next,
                                      void* stream) {
  if (P < 1 || P * P > 65535) return (int)cudaErrorInvalidValue;
  const long long bx = (cap_b + kThreads - 1) / kThreads;
  if (bx < 1 || bx > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  exchange_invert_kernel<<<dim3((unsigned)bx, (unsigned)(P * P)), kThreads, 0,
                           (cudaStream_t)stream>>>(
      (const int32_t*)slot_to_tilde, (const int32_t*)req_idx, (int32_t*)fwd_src,
      (int32_t*)bwd_src, (int)P, cap_b, cap_tilde, cap_next);
  return (int)cudaGetLastError();
}

// table: (num_rows, d) float32; src: (n, ways) int32; out: (n, d) float32.
// vec4 != 0: float4 columns (d % 4 == 0, table and out 16-byte aligned,
// checked here).  group: lanes a row; k: columns a lane per row in flight.
// The forward takes one source a row (ways = 1), the backward any.
extern "C" int exchange_forward_launch(const void* table, const void* src, void* out,
                                       long long n, long long ways, long long d,
                                       long long num_rows, long long vec4, long long group,
                                       long long k, void* stream) {
  return launch<false>(table, src, out, n, ways, d, num_rows, vec4, group, k, stream);
}

extern "C" int exchange_backward_launch(const void* table, const void* src, void* out,
                                        long long n, long long ways, long long d,
                                        long long num_rows, long long vec4, long long group,
                                        long long k, void* stream) {
  return launch<true>(table, src, out, n, ways, d, num_rows, vec4, group, k, stream);
}
