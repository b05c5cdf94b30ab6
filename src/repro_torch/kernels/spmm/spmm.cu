// Padded-bipartite neighbor aggregation (SpMM), forward and backward,
// hand-written for sm_90a.
//
// Replaces the TPU kernel repro/kernels/spmm/kernel.py (spmm_pallas /
// _spmm_kernel).  The TPU version keeps a whole (S, block_d) slice of the
// source matrix resident in VMEM so that its row gathers hit VMEM, not
// HBM.  A Hopper SM has 227 KB of shared memory, far less than one such
// slice, but it gathers at random from HBM and L2 directly: each thread
// loads its source element itself.
//
// Forward: out[r, c] = sum over k in slot order 0..w-1 of
//   (mask[r, k] ? src[clamp(nbr_idx[r, k], 0, S-1), c] : 0), in float32,
//   divided by max(deg_r, 1) in mean mode (deg_r = masked slots of row r).
// One thread per (row, feature column); the d threads of a row read the
// same index and mask bytes (L1 broadcast) and adjacent source columns
// (coalesced).  The plain version in ref.py adds in the same slot order,
// so the forward equals it bit for bit.
//
// Backward: grad_src[j, c] = sum over the masked slots (r, k) with
// clamp(nbr_idx[r, k]) == j of g[r, c], with g = grad_out / max(deg_r, 1)
// in mean mode.  The wrapper sorts the slots by source row with a stable
// sort (keys: the source row, or S for a masked-out slot), so each source
// row's slots form one run in slot order.  One thread per (slot, column)
// whose slot starts a run adds the run's gradients in that order and
// writes the row once: no atomics, so the result is deterministic and
// equals the plain version, which adds in the same order, bit for bit.
// Source rows no slot reads stay as the caller zeroed them.
//
// Bound on the H100: bytes (indices, mask, the touched source rows and the
// output); one add per masked slot and column is far below the float32
// rate.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

__device__ __forceinline__ long long clamp_row(int32_t j, long long num_src) {
  long long r = j < 0 ? 0 : (long long)j;
  return r >= num_src ? num_src - 1 : r;
}

__global__ void spmm_fwd_kernel(const float* __restrict__ src,
                                const int32_t* __restrict__ nbr_idx,
                                const uint8_t* __restrict__ mask,
                                float* __restrict__ out, long long total, int w,
                                int d, long long num_src, int mean) {
  long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (t >= total) return;
  long long r = t / d;
  int c = (int)(t - r * d);
  const int32_t* idx = nbr_idx + r * w;
  const uint8_t* m = mask + r * w;
  float acc = 0.0f;
  int deg = 0;
  for (int k = 0; k < w; ++k) {
    float v = 0.0f;
    if (__ldg(m + k)) {
      v = __ldg(src + clamp_row(__ldg(idx + k), num_src) * d + c);
      ++deg;
    }
    acc = __fadd_rn(acc, v);
  }
  if (mean) acc = __fdiv_rn(acc, (float)(deg > 1 ? deg : 1));
  out[t] = acc;
}

__global__ void spmm_bwd_kernel(const float* __restrict__ g,
                                const int32_t* __restrict__ keys,
                                const int32_t* __restrict__ slots,
                                float* __restrict__ grad_src, long long total,
                                long long num_slots, int w, int d,
                                long long num_src) {
  long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (t >= total) return;
  long long e = t / d;
  int c = (int)(t - e * d);
  int32_t j = __ldg(keys + e);
  if (j >= num_src || (e > 0 && __ldg(keys + e - 1) == j)) return;
  float acc = 0.0f;
  for (long long f = e; f < num_slots && __ldg(keys + f) == j; ++f)
    acc = __fadd_rn(acc, __ldg(g + (long long)(__ldg(slots + f) / w) * d + c));
  grad_src[(long long)j * d + c] = acc;
}

unsigned blocks_for(long long total, int threads) {
  return (unsigned)((total + threads - 1) / threads);
}

}  // namespace

extern "C" int spmm_forward_launch(const void* src, const void* nbr_idx,
                                   const void* mask, void* out, long long n,
                                   long long w, long long d, long long num_src,
                                   long long mean, void* stream) {
  long long total = n * d;
  const int threads = 256;
  spmm_fwd_kernel<<<blocks_for(total, threads), threads, 0, (cudaStream_t)stream>>>(
      (const float*)src, (const int32_t*)nbr_idx, (const uint8_t*)mask,
      (float*)out, total, (int)w, (int)d, num_src, (int)mean);
  return (int)cudaGetLastError();
}

// keys/slots: the n*w slots sorted stably by source row (keys) with their
// flat slot index r*w + k (slots); g already divided by the degree in mean
// mode; grad_src zeroed by the caller.
extern "C" int spmm_backward_launch(const void* g, const void* keys,
                                    const void* slots, void* grad_src,
                                    long long num_slots, long long w, long long d,
                                    long long num_src, void* stream) {
  long long total = num_slots * d;
  const int threads = 256;
  spmm_bwd_kernel<<<blocks_for(total, threads), threads, 0, (cudaStream_t)stream>>>(
      (const float*)g, (const int32_t*)keys, (const int32_t*)slots,
      (float*)grad_src, total, num_slots, (int)w, (int)d, num_src);
  return (int)cudaGetLastError();
}
