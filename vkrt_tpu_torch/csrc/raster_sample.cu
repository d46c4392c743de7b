// Kernel I: one alpha-discard round of the edge raster path after kernel
// G: the material sample, the alpha test and the next round's depth floor.
//
// I replaces no Pallas kernel: the JAX package runs this step in XLA
// (vkrt_tpu/raster/pipeline.py::edge_color_lanes, its `sample_material`
// call at :126), and the port's plain PyTorch version
// (vkrt_tpu_torch/raster/sample.py::raster_sample_round_plain, the CPU
// path) samples all three maps of the 48-byte heap row on every lane,
// widens the rows to float32 and blends them in some 30 elementwise
// kernels, then keeps only the base map's colour and alpha. An MSAA-8
// frame runs it 32 times, and in rounds 1-3 at most 1% of the lanes hold
// a fragment (the raster cell's frames).
//
// What bounds it on the H100: bytes. Every lane reads its slot (4 bytes)
// and writes its depth floor (4); a lane that G hit also reads u, v, mat
// and z (16), its slot's level-0 offset and size (12, cached: a few
// hundred slots) and one 16-byte base-colour quad, and writes 12 bytes
// of colour if opaque. The arithmetic is about 40 float operations a hit.
//
// Design: one thread a lane, 256 a block, every [Nb,128] array read and
// written at the thread's own index (coalesced). A lane G missed writes
// the park value and leaves, so a warp with no hit costs 256 bytes. A hit
// reads only bytes 0-15 of its heap row, the base map's four RGBA corners
// (scene/textures.py::MaterialHeap), as one 16-byte __ldg (rows are 48
// bytes, so a row starts 16-byte aligned when the heap does; the wrapper
// checks). No shared memory.
//
// Bits: the same as the plain version on CUDA tensors, by the rounding
// rules of common.cuh's heap helpers (`bilinear`, `blend`), which kernel K
// (sample_hits.cu) shares.
#include "common.cuh"

namespace vkrt {

constexpr int SAMPLE_THREADS = 256;

__global__ void __launch_bounds__(SAMPLE_THREADS) raster_sample_kernel(
    const int* __restrict__ slot, const float* __restrict__ u,
    const float* __restrict__ v, const int* __restrict__ mat,
    const float* __restrict__ z, const uint8_t* __restrict__ texels,
    const int* __restrict__ level_offset, const int* __restrict__ level_width,
    const int* __restrict__ level_height, int levels, int n,
    float alpha_discard, float park, float* __restrict__ color,
    float* __restrict__ zfloor) {
  const int i = blockIdx.x * SAMPLE_THREADS + threadIdx.x;
  if (i >= n) return;
  if (slot[i] < 0) {                       // a miss: parked next round
    zfloor[i] = park;
    return;
  }
  const int m = mat[i] * levels;           // the slot's level 0
  const int off = __ldg(level_offset + m);
  const int w = __ldg(level_width + m);
  const int h = __ldg(level_height + m);
  const Bilinear b = bilinear(u[i], v[i], off, w, h);
  const uint4 q = heap_quad(texels, b.row, 0);
  if (blend(q, 3, b) >= alpha_discard) {                      // opaque
    color[i] = blend(q, 0, b);
    color[n + i] = blend(q, 1, b);
    color[2 * n + i] = blend(q, 2, b);
    zfloor[i] = park;
  } else {                   // discarded: the next round looks behind it
    zfloor[i] = z[i];
  }
}

}  // namespace vkrt

// Plain C entry point (bound with ctypes): slot, u, v, mat, z, zfloor are
// [n] (n = Nb * 128), color [3, n] and updated in place where a fragment
// is opaque, the heap u8[N, 48] (16-byte aligned), the level tables
// i32[M, levels]. Returns cudaGetLastError() after the launch; the launch
// does not synchronise.
extern "C" int vkrt_raster_sample(const int* slot, const float* u,
                                  const float* v, const int* mat,
                                  const float* z, const uint8_t* texels,
                                  const int* level_offset,
                                  const int* level_width,
                                  const int* level_height, int levels, int n,
                                  float alpha_discard, float park,
                                  float* color, float* zfloor, void* stream) {
  using namespace vkrt;
  if (n > 0) {
    const int blocks = (n + SAMPLE_THREADS - 1) / SAMPLE_THREADS;
    raster_sample_kernel<<<blocks, SAMPLE_THREADS, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        slot, u, v, mat, z, texels, level_offset, level_width, level_height,
        levels, n, alpha_discard, park, color, zfloor);
  }
  return static_cast<int>(cudaGetLastError());
}
