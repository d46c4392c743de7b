// Kernels C and D: live-ray consolidation and its inverse.
//
// C replaces the Pallas kernel vkrt_tpu/wavefront/pack.py::_consolidate_kernel
// (:98, entry consolidate :158); D replaces ::_scatter_kernel (:200, entry
// scatter_back :242).
//
// What bounds them on the H100: memory traffic, and nothing else. They move
// f32 values without arithmetic: at 1080p C reads 4 channels and the rank of
// 2.09M rays and writes the live ones (~42 MB read, up to 33 MB written);
// D reads and writes 4 mask channels. The TPU kernels could write only
// whole static blocks, so they gathered each destination block from a DMA'd
// run of source blocks through one-hot matmuls; on a GPU a thread can store
// to any address, so C is a plain scatter and D a plain gather.
//
// Design: one thread per ray, channel-major loops. The global live rank
// grank (vkrt_tpu_torch/wavefront/pack.py::consolidate_plan) rises with the
// ray index, so the live lanes of a warp store to (C) or load from (D)
// consecutive addresses. The wrapper zeroes C's output, so the dead tail is
// 0. A rank outside [0, n) marks a dead ray (grank -1): C skips it and D
// writes 0 there, so values past the last live rank never leak.
#include <cuda_runtime.h>

namespace vkrt {

__global__ void __launch_bounds__(256)
consolidate_kernel(const float* __restrict__ x,      // [c, n]
                   const int* __restrict__ grank,    // [n]
                   int c, int n, float* __restrict__ out) {  // [c, n], zeroed
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int g = grank[i];
  if ((unsigned)g >= (unsigned)n) return;
  for (int ch = 0; ch < c; ++ch)
    out[(size_t)ch * n + g] = x[(size_t)ch * n + i];
}

__global__ void __launch_bounds__(256)
scatter_back_kernel(const float* __restrict__ res,   // [s, n] packed order
                    const int* __restrict__ grank,   // [n]
                    int s, int n, float* __restrict__ out) {  // [s, n]
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int g = grank[i];
  bool live = (unsigned)g < (unsigned)n;
  for (int ch = 0; ch < s; ++ch)
    out[(size_t)ch * n + i] = live ? res[(size_t)ch * n + g] : 0.0f;
}

}  // namespace vkrt

// Plain C entry points (bound with ctypes). Each returns cudaGetLastError()
// after its launch; the launch does not synchronise.
extern "C" int vkrt_consolidate(const float* x, const int* grank, int c, int n,
                                float* out, void* stream) {
  if (n > 0 && c > 0) {
    const int threads = 256;
    vkrt::consolidate_kernel<<<(n + threads - 1) / threads, threads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
        x, grank, c, n, out);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int vkrt_scatter_back(const float* res, const int* grank, int s,
                                 int n, float* out, void* stream) {
  if (n > 0 && s > 0) {
    const int threads = 256;
    vkrt::scatter_back_kernel<<<(n + threads - 1) / threads, threads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
        res, grank, s, n, out);
  }
  return static_cast<int>(cudaGetLastError());
}
