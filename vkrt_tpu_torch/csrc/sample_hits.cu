// Kernel K: the ray tracer's level-0 material sample at one depth, on the
// lanes whose closest-hit ray hit.
//
// K replaces no Pallas kernel: the JAX package samples in XLA
// (vkrt_tpu/shade/sampling.py::sample_material and, at depth >= 1,
// sample_material_compact), and the port's plain PyTorch version
// (vkrt_tpu_torch/shade/sampling.py::sample_hits_plain, the CPU path)
// gathers every lane's 48-byte heap row, widens the rows to float32 and
// blends all twelve channels of the three maps in some 30 elementwise
// kernels, whatever share of the lanes hit (at config 5's depth 3 about a
// quarter).
//
// What bounds it on the H100: bytes. Every lane reads its hit mask (1 byte)
// and writes the seven channels the shader reads (28); a hit lane also
// reads its slot and uv (12), its slot's level-0 offset and size (12,
// cached: a few hundred slots) and its 48-byte heap row, which spans two
// 32-byte sectors. The arithmetic is about 90 float operations a hit.
//
// Design: one thread a lane, 256 a block, every [Nb,128] array read and
// written at the thread's own index (coalesced). A lane that did not hit
// writes zeros and leaves, with no heap read. A hit reads its row as three
// 16-byte __ldg (rows are 48 bytes, so a row starts 16-byte aligned when
// the heap does; the wrapper checks), blends the base, metallic-roughness
// and normal quads at the same weights, and writes base rgb, metallic (the
// metallic-roughness map's blue) and normal rgb. No shared memory.
//
// Bits: on every hit lane each channel equals the plain version's on CUDA
// tensors, by the rounding rules of common.cuh's heap helpers, which
// kernel I (raster_sample.cu) shares.
#include "common.cuh"

namespace vkrt {

constexpr int HITS_THREADS = 256;
constexpr int HITS_CHANNELS = 7;       // base rgb, metallic, normal rgb

__global__ void __launch_bounds__(HITS_THREADS) sample_hits_kernel(
    const int* __restrict__ slot, const float* __restrict__ uv,
    const uint8_t* __restrict__ hit, const uint8_t* __restrict__ texels,
    const int* __restrict__ level_offset, const int* __restrict__ level_width,
    const int* __restrict__ level_height, int levels, int n,
    float* __restrict__ out) {
  const int i = blockIdx.x * HITS_THREADS + threadIdx.x;
  if (i >= n) return;
  if (!hit[i]) {
#pragma unroll
    for (int c = 0; c < HITS_CHANNELS; ++c) out[c * n + i] = 0.0f;
    return;
  }
  const int m = slot[i] * levels;          // the slot's level 0
  const int off = __ldg(level_offset + m);
  const int w = __ldg(level_width + m);
  const int h = __ldg(level_height + m);
  const Bilinear b = bilinear(uv[i], uv[n + i], off, w, h);
  const uint4 base = heap_quad(texels, b.row, 0);
  const uint4 mr = heap_quad(texels, b.row, 1);
  const uint4 nrm = heap_quad(texels, b.row, 2);
  out[i] = blend(base, 0, b);
  out[n + i] = blend(base, 1, b);
  out[2 * n + i] = blend(base, 2, b);
  out[3 * n + i] = blend(mr, 2, b);
  out[4 * n + i] = blend(nrm, 0, b);
  out[5 * n + i] = blend(nrm, 1, b);
  out[6 * n + i] = blend(nrm, 2, b);
}

}  // namespace vkrt

// Plain C entry point (bound with ctypes): slot i32[n] and hit u8[n] (a
// torch.bool mask, one byte a lane), uv f32[2, n] (n = Nb * 128), the heap
// u8[N, 48] (16-byte aligned), the level tables i32[M, levels], out
// f32[7, n], written on every lane (n * 7 < 2^31). Returns
// cudaGetLastError() after the launch; the launch does not synchronise.
extern "C" int vkrt_sample_hits(const int* slot, const float* uv,
                                const uint8_t* hit, const uint8_t* texels,
                                const int* level_offset,
                                const int* level_width,
                                const int* level_height, int levels, int n,
                                float* out, void* stream) {
  using namespace vkrt;
  if (n > 0) {
    const int blocks = (n + HITS_THREADS - 1) / HITS_THREADS;
    sample_hits_kernel<<<blocks, HITS_THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        slot, uv, hit, texels, level_offset, level_width, level_height,
        levels, n, out);
  }
  return static_cast<int>(cudaGetLastError());
}
