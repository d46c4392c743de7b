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
// Bits: the same as the plain version on CUDA tensors. Each product and
// sum is rounded on its own, in the plain version's order (__fmul_rn /
// __fadd_rn / __fsub_rn; the library also builds with -fmad=false):
// x = u * w - 0.5, x0 = floor(x) as int32, fx = x - x0, the texel index a
// floor modulo (torch.remainder), texel / 255 as texel * (1 / 255) (how
// PyTorch's true division by a CPU scalar runs on CUDA), each bilinear
// weight its own product, and the four-term blend summed left to right.
#include <cuda_runtime.h>
#include <stdint.h>

namespace vkrt {

constexpr int SAMPLE_THREADS = 256;
constexpr int ROW_BYTES = 48;          // heap row: three maps' 2x2 quads
constexpr float INV_255 = 1.0f / 255.0f;

__device__ __forceinline__ int floor_mod(int a, int b) {
  const int r = a % b;
  return (r != 0 && ((r < 0) != (b < 0))) ? r + b : r;
}

// Channel c of one corner's RGBA word as a float in [0, 1].
__device__ __forceinline__ float unorm(unsigned word, int c) {
  return __fmul_rn(static_cast<float>((word >> (8 * c)) & 0xffu), INV_255);
}

// Channel c of the bilinear blend of the quad's corners 00, 10, 01, 11.
__device__ __forceinline__ float blend(const uint4& q, int c, float w00,
                                       float w10, float w01, float w11) {
  float s = __fmul_rn(unorm(q.x, c), w00);
  s = __fadd_rn(s, __fmul_rn(unorm(q.y, c), w10));
  s = __fadd_rn(s, __fmul_rn(unorm(q.z, c), w01));
  return __fadd_rn(s, __fmul_rn(unorm(q.w, c), w11));
}

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
  const float x = __fsub_rn(__fmul_rn(u[i], static_cast<float>(w)), 0.5f);
  const float y = __fsub_rn(__fmul_rn(v[i], static_cast<float>(h)), 0.5f);
  const int x0 = static_cast<int>(floorf(x));
  const int y0 = static_cast<int>(floorf(y));
  const float fx = __fsub_rn(x, static_cast<float>(x0));
  const float fy = __fsub_rn(y, static_cast<float>(y0));
  const int row = off + floor_mod(y0, h) * w + floor_mod(x0, w);
  const uint4 q = __ldg(reinterpret_cast<const uint4*>(
      texels + static_cast<long long>(row) * ROW_BYTES));
  const float gx = __fsub_rn(1.0f, fx), gy = __fsub_rn(1.0f, fy);
  const float w00 = __fmul_rn(gx, gy), w10 = __fmul_rn(fx, gy);
  const float w01 = __fmul_rn(gx, fy), w11 = __fmul_rn(fx, fy);
  if (blend(q, 3, w00, w10, w01, w11) >= alpha_discard) {     // opaque
    color[i] = blend(q, 0, w00, w10, w01, w11);
    color[n + i] = blend(q, 1, w00, w10, w01, w11);
    color[2 * n + i] = blend(q, 2, w00, w10, w01, w11);
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
