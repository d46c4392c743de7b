// The span mark: an empty kernel that vkrt_tpu_torch/tracing.py::span
// enqueues where a span of a traced frame opens and where it closes.
//
// It does no work. Captured into a CUDA graph it is a kernel node like
// any other, so every replay runs it and the profiler (CUPTI) gives it a
// timestamp on the clock of the frame's other kernels and of the host's
// ranges; on one stream the kernels between two marks belong to the
// innermost span open between them (tracing.device_spans). One thread of
// one block: the launch is the cost, about a microsecond a mark.
#include <cuda_runtime.h>

namespace vkrt {

__global__ void span_mark_kernel() {}

}  // namespace vkrt

// Plain C entry point (bound with ctypes): returns cudaGetLastError()
// after the launch; the launch does not synchronise.
extern "C" int vkrt_span_mark(void* stream) {
  vkrt::span_mark_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
