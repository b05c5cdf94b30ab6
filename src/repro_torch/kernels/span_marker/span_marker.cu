// Span marker: one thread stamps the device's global timer into the
// accumulator of one span of a program (repro_torch.utils.spans).
//
// Replaces no TPU kernel.  It exists because a captured CUDA graph replays
// kernels with no host work between them, so nothing on the host can say
// which stage of the train step a kernel belongs to.  A marker launched
// while a graph is captured becomes a kernel node of that graph and runs
// on every replay, in stream order with the stage's own kernels:
//   - begin (end == 0): acc[2] = now;
//   - end   (end == 1): acc[0] += now - acc[2]; acc[1] += 1;
// where acc is the span's three int64 slots (total ns, count, last start)
// in a buffer the recorder allocates before any capture.  Markers of one
// span never overlap (a stream runs them in order), so plain loads and
// stores suffice.
//
// Each span has a kernel of its own, named after it ("exchange.fwd.l2" ->
// span_exchange_fwd_l2), so a profiler trace names the stage it marks
// with no lookup table, and the markers of one name alternate begin and
// end.  SPAN_KERNELS lists them in the order of
// repro_torch.utils.spans.SPANS; a span's index is its position there.
//
// Bound: launch latency (one thread, three 8-byte words); a few
// microseconds a marker on the H100, against steps of tens to hundreds
// of milliseconds.
#include <cuda_runtime.h>

#define SPAN_LAYERS(X, kind)                                                   \
  X(exchange_##kind##_l0) X(exchange_##kind##_l1) X(exchange_##kind##_l2)      \
  X(exchange_##kind##_l3) X(exchange_##kind##_l4) X(exchange_##kind##_l5)      \
  X(exchange_##kind##_l6) X(exchange_##kind##_l7)

#define SPAN_KERNELS(X)                                                        \
  X(plan) X(gather) X(forward) X(backward) X(all_reduce) X(adam)               \
  SPAN_LAYERS(X, ids) SPAN_LAYERS(X, fwd) SPAN_LAYERS(X, bwd)

namespace {

__device__ __forceinline__ void stamp(unsigned long long* acc, int end) {
  unsigned long long now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  if (end) {
    acc[0] += now - acc[2];
    acc[1] += 1;
  } else {
    acc[2] = now;
  }
}

}  // namespace

#define SPAN_DEFINE(name)                                                      \
  extern "C" __global__ void span_##name(unsigned long long* acc, int end) {   \
    stamp(acc, end);                                                           \
  }
SPAN_KERNELS(SPAN_DEFINE)

typedef void (*marker_fn)(unsigned long long*, int);
#define SPAN_ENTRY(name) span_##name,
static const marker_fn kMarkers[] = {SPAN_KERNELS(SPAN_ENTRY)};
static const long long kCount = sizeof(kMarkers) / sizeof(kMarkers[0]);

// The number of span kernels (the wrapper checks it against SPANS).
extern "C" long long span_marker_count() { return kCount; }

// Stamps span ``index`` (its slots at acc + 3 * index); ``end`` 0 begins
// the span, 1 ends it.
extern "C" int span_marker_launch(void* acc, long long index, long long end, void* stream) {
  if (index < 0 || index >= kCount) return (int)cudaErrorInvalidValue;
  unsigned long long* slots = (unsigned long long*)acc + 3 * index;
  int ends = (int)end;
  void* args[] = {&slots, &ends};
  cudaError_t err = cudaLaunchKernel((const void*)kMarkers[index], dim3(1), dim3(1), args, 0,
                                     (cudaStream_t)stream);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}
