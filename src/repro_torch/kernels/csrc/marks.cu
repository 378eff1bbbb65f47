// Device marks for the program's spans (obs/telemetry.py, through
// kernels/marks.py).
//
// Replaces no TPU kernel: JAX names a division's phases with host
// scopes, which a CUDA graph replays without.  A mark is one thread
// that reads the card's nanosecond clock (%globaltimer) and writes it,
// with its mark index and its row, into a ring of stamps; a span is a
// pair of marks.  Inside a captured graph each scope boundary is one
// such node, so every replay stamps its own row without the host: the
// row count lives in the ring's header on the device, the first mark of
// a replay takes the next row and the others stamp the row it took.
//
// Bound: launch latency (one thread, three 8-byte stores).  A mark is
// not one of the program's counted launches (kernels/build.py:count).
//
// Two boundaries of a capture share one mark when nothing was captured
// between them: span_capture_tail gives the node a stream being
// captured will make its next node follow, so a boundary whose tail is
// still the last mark's node reuses that mark (only the host asks, at
// capture; nothing of it is in the graph).
//
// The header, four int64 words: the ring's address, marks a row (n),
// rows in the ring (depth), rows started so far.  Row r lives in slot r
// mod depth; mark j of it is the triple (clock, j, r) at word 3 * ((r
// mod depth) * n + j) of the ring.
#include <cstdint>
#include <cuda_runtime.h>

__global__ void span_mark_kernel(long long* header, int mark) {
  unsigned long long now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  long long* ring = reinterpret_cast<long long*>(header[0]);
  if (ring == nullptr) return;
  long long row = mark == 0 ? header[3]++ : header[3] - 1;
  long long* e = ring + 3 * ((row % header[2]) * header[1] + mark);
  e[0] = (long long)now;
  e[1] = mark;
  e[2] = row;
}

extern "C" int span_mark_launch(void* header, int mark, void* stream) {
  span_mark_kernel<<<1, 1, 0, (cudaStream_t)stream>>>((long long*)header,
                                                       mark);
  return (int)cudaGetLastError();
}

// The one node that the next node captured on `stream` will follow, or
// 0: not capturing, nothing captured yet, or several.
extern "C" int span_capture_tail(void* stream, unsigned long long* node) {
  cudaStreamCaptureStatus status;
  const cudaGraphNode_t* deps = nullptr;
  size_t n = 0;
#if CUDART_VERSION >= 13000
  cudaError_t err = cudaStreamGetCaptureInfo(
      (cudaStream_t)stream, &status, nullptr, nullptr, &deps, nullptr, &n);
#else
  cudaError_t err = cudaStreamGetCaptureInfo(
      (cudaStream_t)stream, &status, nullptr, nullptr, &deps, &n);
#endif
  *node = err == cudaSuccess && status == cudaStreamCaptureStatusActive &&
                  n == 1
              ? (unsigned long long)(uintptr_t)deps[0]
              : 0;
  return (int)err;
}
