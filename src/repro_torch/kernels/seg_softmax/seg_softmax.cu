// Masked per-destination edge softmax (GAT), forward and backward,
// hand-written for sm_90a.
//
// Replaces the TPU kernel repro/kernels/seg_softmax/kernel.py
// (seg_softmax_pallas / _seg_softmax_kernel).  The TPU version softmaxes
// a (block_n, w) tile of logits in VMEM, and its wrapper first folds the
// heads of (n, w, h) logits into rows with a moveaxis copy.  Here the
// logits are read in place.
//
// Forward: out[r, k, j] = mask[r, k] ? exp(e[r, k, j] - mx) / max(s, 1e-20)
// : 0, with mx the max over slots of (mask ? e : -1e9) and s the sum of
// the valid slots' exponentials.  Backward: grad_e[r, k, j] = mask[r, k] ?
// alpha * (g - sum over valid slots of alpha * g) : 0.
//
// Layout: one warp per row r, all heads at once.  Lane k takes slot k
// (then k+32, ... when w > 32) and holds the slot's heads, which are
// contiguous in memory, G at a time (G = 8, 4, 2 or 1, the largest that
// divides h): one 16-byte access per 4 heads, so for h = 4 a row's 32
// slots are 512 contiguous bytes, loaded and stored as whole lines.  The
// wrapper passes 16-byte-aligned floats only.
//
// One pass: the warp loads its row's mask bytes and ballots them.  A row
// with no valid slot (most of the rows of the last plan layer, which is
// mostly padding) stores zeros and is done.  Otherwise each valid slot's
// logits (forward) or alpha and g (backward) are loaded once into
// registers; the per-head max and sum are taken by shuffles, expf runs
// once per valid slot, and every output is written once.  Slots past the
// first 32 (w > 32) are loaded again from cache in the later steps.  A
// warp takes one row: giving it 2 or 4 rows, their mask bytes loaded
// together, shortened the mostly-padding layer but slowed the small
// layers, whose rows then ran one after another.
//
// Each lane adds its slots in order (a masked slot, or a slot past w in
// the last 32, adds +0.0), then the lanes are added by a shuffle-xor
// butterfly (16, 8, 4, 2, 1 apart), per head.  The plain
// versions in ref.py (warp_sum) add in that same order, and every product
// and sum is an explicitly rounded __fmul_rn / __fadd_rn (no FMA
// contraction), so on a card both do the same float32 operations in the
// same order.
//
// Bound on the H100: bytes.  The mask (n*w bytes), the logits (forward)
// or alpha and g (backward) of the valid slots, and the whole output
// (4*n*w*h bytes), which masked slots get as zeros; a few float
// operations per slot are far below the float32 rate.  Masked slots are
// not read.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr float NEG = -1e9f;
// 8 rows a block; at least 4 blocks an SM (64 registers a thread at most),
// so that enough warps keep the zero rows' stores in flight
constexpr int THREADS = 256, MIN_BLOCKS = 4;

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off; off >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off; off >>= 1) v = __fadd_rn(v, __shfl_xor_sync(FULL, v, off));
  return v;
}

// G consecutive floats at p (aligned to min(16, 4*G) bytes).
template <int G>
__device__ __forceinline__ void load(const float* __restrict__ p, float (&v)[G]) {
  if constexpr (G % 4 == 0) {
#pragma unroll
    for (int i = 0; i < G; i += 4) {
      float4 q = __ldg(reinterpret_cast<const float4*>(p + i));
      v[i] = q.x, v[i + 1] = q.y, v[i + 2] = q.z, v[i + 3] = q.w;
    }
  } else if constexpr (G == 2) {
    float2 q = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = q.x, v[1] = q.y;
  } else {
    v[0] = __ldg(p);
  }
}

template <int G>
__device__ __forceinline__ void store(float* __restrict__ p, const float (&v)[G]) {
  if constexpr (G % 4 == 0) {
#pragma unroll
    for (int i = 0; i < G; i += 4)
      *reinterpret_cast<float4*>(p + i) = make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
  } else if constexpr (G == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    p[0] = v[0];
  }
}

// Whether any slot of row mr (w bytes) is valid, the same on every lane;
// *v0 is whether this lane's first slot is.
__device__ __forceinline__ bool row_has_valid(const uint8_t* __restrict__ mr, int w, int lane,
                                              bool* v0) {
  *v0 = lane < w && __ldg(mr + lane);
  unsigned any = __ballot_sync(FULL, *v0);
  for (int c = 32; c < w; c += 32)
    any |= __ballot_sync(FULL, c + lane < w && __ldg(mr + c + lane));
  return any != 0;
}

template <int G>
__device__ __forceinline__ void store_zero_row(float* __restrict__ orow, int w, int h, int lane) {
  float z[G];
#pragma unroll
  for (int i = 0; i < G; ++i) z[i] = 0.0f;
  for (int k = lane; k < w; k += 32)
    for (int j = 0; j < h; j += G) store<G>(orow + (long long)k * h + j, z);
}

// e, out: (n, w, h) floats; mask: (n, w) bytes; one warp per row.
template <int G>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
seg_softmax_fwd_kernel(const float* __restrict__ e, const uint8_t* __restrict__ mask,
                       float* __restrict__ out, long long n, int w, int h) {
  long long r = (blockIdx.x * (long long)blockDim.x + threadIdx.x) >> 5;
  int lane = threadIdx.x & 31;
  if (r >= n) return;  // uniform over the warp
  const uint8_t* mr = mask + r * w;
  const long long row = r * w * (long long)h;
  bool v0;
  if (!row_has_valid(mr, w, lane, &v0)) {
    store_zero_row<G>(out + row, w, h, lane);
    return;
  }
  for (int j = 0; j < h; j += G) {
    const float* er = e + row + j;
    float* orow = out + row + j;
    float x0[G], mx[G], s[G], y[G];
    if (v0) {
      load<G>(er + (long long)lane * h, x0);
    } else {
#pragma unroll
      for (int i = 0; i < G; ++i) x0[i] = NEG;
    }
#pragma unroll
    for (int i = 0; i < G; ++i) mx[i] = lane < w ? x0[i] : __int_as_float(0xff800000);  // -inf
    for (int k = lane + 32; k < w; k += 32) {
      float x[G] = {};
      if (__ldg(mr + k)) {
        load<G>(er + (long long)k * h, x);
      } else {
#pragma unroll
        for (int i = 0; i < G; ++i) x[i] = NEG;
      }
#pragma unroll
      for (int i = 0; i < G; ++i) mx[i] = fmaxf(mx[i], x[i]);
    }
#pragma unroll
    for (int i = 0; i < G; ++i) {
      mx[i] = warp_max(mx[i]);
      x0[i] = v0 ? expf(x0[i] - mx[i]) : 0.0f;  // now the exponential
      s[i] = x0[i];
    }
    for (int k = lane + 32; k - lane < w; k += 32) {  // uniform over the warp
      float x[G] = {};
      bool valid = k < w && __ldg(mr + k);
      if (valid) load<G>(er + (long long)k * h, x);
#pragma unroll
      for (int i = 0; i < G; ++i) s[i] = __fadd_rn(s[i], valid ? expf(x[i] - mx[i]) : 0.0f);
    }
#pragma unroll
    for (int i = 0; i < G; ++i) s[i] = fmaxf(warp_sum(s[i]), 1e-20f);
    if (lane < w) {
#pragma unroll
      for (int i = 0; i < G; ++i) y[i] = v0 ? __fdiv_rn(x0[i], s[i]) : 0.0f;
      store<G>(orow + (long long)lane * h, y);
    }
    for (int k = lane + 32; k < w; k += 32) {
      bool valid = __ldg(mr + k);
      float x[G] = {};
      if (valid) load<G>(er + (long long)k * h, x);
#pragma unroll
      for (int i = 0; i < G; ++i) y[i] = valid ? __fdiv_rn(expf(x[i] - mx[i]), s[i]) : 0.0f;
      store<G>(orow + (long long)k * h, y);
    }
  }
}

// alpha, grad, out: (n, w, h) floats; mask: (n, w) bytes; one warp per row.
template <int G>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
seg_softmax_bwd_kernel(const float* __restrict__ alpha, const float* __restrict__ grad,
                       const uint8_t* __restrict__ mask, float* __restrict__ out, long long n,
                       int w, int h) {
  long long r = (blockIdx.x * (long long)blockDim.x + threadIdx.x) >> 5;
  int lane = threadIdx.x & 31;
  if (r >= n) return;
  const uint8_t* mr = mask + r * w;
  const long long row = r * w * (long long)h;
  bool v0;
  if (!row_has_valid(mr, w, lane, &v0)) {
    store_zero_row<G>(out + row, w, h, lane);
    return;
  }
  for (int j = 0; j < h; j += G) {
    const float* ar = alpha + row + j;
    const float* gr = grad + row + j;
    float* orow = out + row + j;
    float a0[G] = {}, g0[G] = {}, s[G], y[G];
    if (v0) {
      load<G>(ar + (long long)lane * h, a0);
      load<G>(gr + (long long)lane * h, g0);
    }
#pragma unroll
    for (int i = 0; i < G; ++i) s[i] = v0 ? __fmul_rn(a0[i], g0[i]) : 0.0f;
    for (int k = lane + 32; k - lane < w; k += 32) {  // uniform over the warp
      float a[G] = {}, g[G] = {};
      bool valid = k < w && __ldg(mr + k);
      if (valid) {
        load<G>(ar + (long long)k * h, a);
        load<G>(gr + (long long)k * h, g);
      }
#pragma unroll
      for (int i = 0; i < G; ++i) s[i] = __fadd_rn(s[i], valid ? __fmul_rn(a[i], g[i]) : 0.0f);
    }
#pragma unroll
    for (int i = 0; i < G; ++i) s[i] = warp_sum(s[i]);
    if (lane < w) {
#pragma unroll
      for (int i = 0; i < G; ++i) y[i] = v0 ? __fmul_rn(a0[i], __fsub_rn(g0[i], s[i])) : 0.0f;
      store<G>(orow + (long long)lane * h, y);
    }
    for (int k = lane + 32; k < w; k += 32) {
      bool valid = __ldg(mr + k);
      float a[G] = {}, g[G] = {};
      if (valid) {
        load<G>(ar + (long long)k * h, a);
        load<G>(gr + (long long)k * h, g);
      }
#pragma unroll
      for (int i = 0; i < G; ++i)
        y[i] = valid ? __fmul_rn(a[i], __fsub_rn(g[i], s[i])) : 0.0f;
      store<G>(orow + (long long)k * h, y);
    }
  }
}

unsigned blocks_for(long long n) { return (unsigned)((n * 32 + THREADS - 1) / THREADS); }

}  // namespace

// Heads a lane takes at a time: the largest of 8, 4, 2, 1 that divides h.
#define SEG_DISPATCH(h, KERNEL, ...)                                                 \
  switch ((h) % 8 == 0 ? 8 : (h) % 4 == 0 ? 4 : (h) % 2 == 0 ? 2 : 1) {              \
    case 8: KERNEL<8><<<blocks_for(n), THREADS, 0, (cudaStream_t)stream>>>(__VA_ARGS__); break; \
    case 4: KERNEL<4><<<blocks_for(n), THREADS, 0, (cudaStream_t)stream>>>(__VA_ARGS__); break; \
    case 2: KERNEL<2><<<blocks_for(n), THREADS, 0, (cudaStream_t)stream>>>(__VA_ARGS__); break; \
    default: KERNEL<1><<<blocks_for(n), THREADS, 0, (cudaStream_t)stream>>>(__VA_ARGS__);       \
  }

extern "C" int seg_softmax_forward_launch(const void* e, const void* mask, void* out,
                                          long long n, long long w, long long h,
                                          void* stream) {
  SEG_DISPATCH(h, seg_softmax_fwd_kernel, (const float*)e, (const uint8_t*)mask, (float*)out,
               n, (int)w, (int)h);
  return (int)cudaGetLastError();
}

extern "C" int seg_softmax_backward_launch(const void* alpha, const void* grad,
                                           const void* mask, void* out, long long n,
                                           long long w, long long h, void* stream) {
  SEG_DISPATCH(h, seg_softmax_bwd_kernel, (const float*)alpha, (const float*)grad,
               (const uint8_t*)mask, (float*)out, n, (int)w, (int)h);
  return (int)cudaGetLastError();
}
