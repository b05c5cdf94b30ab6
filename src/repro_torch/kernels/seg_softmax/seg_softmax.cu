// Masked per-destination edge softmax (GAT), forward and backward,
// hand-written for sm_90a.
//
// Replaces the TPU kernel repro/kernels/seg_softmax/kernel.py
// (seg_softmax_pallas / _seg_softmax_kernel).  The TPU version softmaxes
// a (block_n, w) tile of logits in VMEM, and its wrapper first folds the
// heads of (n, w, h) logits into rows with a moveaxis copy.  Here the
// logits are read in place: one warp per (row, head), its 32 lanes over
// the w slots (lane k takes slots k, k+32, ... when w > 32), the max and
// the sum taken with warp shuffles; no shared memory, no copy.
//
// Forward: out[r, k, j] = mask[r, k] ? exp(e[r, k, j] - mx) / max(s, 1e-20)
// : 0, with mx the max over slots of (mask ? e : -1e9) and s the sum of
// the valid slots' exponentials.  Backward: grad_e[r, k, j] = mask[r, k] ?
// alpha * (g - sum over valid slots of alpha * g) : 0.
//
// Each lane adds its slots in order, then the lanes are added by a
// shuffle-xor butterfly (16, 8, 4, 2, 1 apart).  The plain versions in
// ref.py (warp_sum) add in that same order, and every product and sum is
// an explicitly rounded __fmul_rn / __fadd_rn (no FMA contraction), so on
// a card both do the same float32 operations in the same order.
//
// Bound on the H100: bytes.  The mask (n*w bytes), the logits (forward)
// or alpha and g (backward) of the valid slots, and the whole output
// (4*n*w*h bytes), which masked slots get as zeros; a few float
// operations per slot are far below the float32 rate.  Masked slots are
// not read: a warp loads a slot's value only where the mask is set.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off; off >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off; off >>= 1) v = __fadd_rn(v, __shfl_xor_sync(FULL, v, off));
  return v;
}

// e, out: (n, w, h) floats; mask: (n, w) bytes; one warp per (r, j).
__global__ void seg_softmax_fwd_kernel(const float* __restrict__ e,
                                       const uint8_t* __restrict__ mask,
                                       float* __restrict__ out,
                                       long long warps, int w, int h) {
  long long g = (blockIdx.x * (long long)blockDim.x + threadIdx.x) >> 5;
  int lane = threadIdx.x & 31;
  if (g >= warps) return;  // uniform over the warp
  long long r = g / h;
  int j = (int)(g - r * h);
  const float* er = e + r * w * h + j;
  const uint8_t* mr = mask + r * w;
  float* orow = out + r * w * h + j;

  float mx = __int_as_float(0xff800000);  // -inf
  for (int k = lane; k < w; k += 32)
    mx = fmaxf(mx, __ldg(mr + k) ? __ldg(er + (long long)k * h) : -1e9f);
  mx = warp_max(mx);

  float s = 0.0f;
  for (int k = lane; k < w; k += 32) {
    float x = __ldg(mr + k) ? expf(__ldg(er + (long long)k * h) - mx) : 0.0f;
    s = k == lane ? x : __fadd_rn(s, x);
  }
  float denom = fmaxf(warp_sum(s), 1e-20f);

  for (int k = lane; k < w; k += 32) {
    float y = 0.0f;
    if (__ldg(mr + k)) y = __fdiv_rn(expf(__ldg(er + (long long)k * h) - mx), denom);
    orow[(long long)k * h] = y;
  }
}

// alpha, grad, out: (n, w, h) floats; mask: (n, w) bytes.
__global__ void seg_softmax_bwd_kernel(const float* __restrict__ alpha,
                                       const float* __restrict__ grad,
                                       const uint8_t* __restrict__ mask,
                                       float* __restrict__ out,
                                       long long warps, int w, int h) {
  long long g = (blockIdx.x * (long long)blockDim.x + threadIdx.x) >> 5;
  int lane = threadIdx.x & 31;
  if (g >= warps) return;
  long long r = g / h;
  int j = (int)(g - r * h);
  long long base = r * w * h + j;
  const uint8_t* mr = mask + r * w;

  float s = 0.0f;
  for (int k = lane; k < w; k += 32) {
    long long i = base + (long long)k * h;
    float x = __ldg(mr + k) ? __fmul_rn(__ldg(alpha + i), __ldg(grad + i)) : 0.0f;
    s = k == lane ? x : __fadd_rn(s, x);
  }
  s = warp_sum(s);

  for (int k = lane; k < w; k += 32) {
    long long i = base + (long long)k * h;
    float y = 0.0f;
    if (__ldg(mr + k)) y = __fmul_rn(__ldg(alpha + i), __fsub_rn(__ldg(grad + i), s));
    out[i] = y;
  }
}

unsigned blocks_for(long long warps, int threads) {
  return (unsigned)((warps * 32 + threads - 1) / threads);
}

}  // namespace

extern "C" int seg_softmax_forward_launch(const void* e, const void* mask, void* out,
                                          long long n, long long w, long long h,
                                          void* stream) {
  const int threads = 256;
  long long warps = n * h;
  seg_softmax_fwd_kernel<<<blocks_for(warps, threads), threads, 0, (cudaStream_t)stream>>>(
      (const float*)e, (const uint8_t*)mask, (float*)out, warps, (int)w, (int)h);
  return (int)cudaGetLastError();
}

extern "C" int seg_softmax_backward_launch(const void* alpha, const void* grad,
                                           const void* mask, void* out, long long n,
                                           long long w, long long h, void* stream) {
  const int threads = 256;
  long long warps = n * h;
  seg_softmax_bwd_kernel<<<blocks_for(warps, threads), threads, 0, (cudaStream_t)stream>>>(
      (const float*)alpha, (const float*)grad, (const uint8_t*)mask, (float*)out, warps,
      (int)w, (int)h);
  return (int)cudaGetLastError();
}
