// Shared helpers of the trace kernels (trace_closest.cu: kernel A,
// trace_occluded.cu: A', occl_multi.cu: B), of the raster kernel
// (raster_edge.cu: G, which uses the list and key helpers) and of the two
// material samplers (raster_sample.cu: I, sample_hits.cu: K, which use the
// heap helpers at the end).
//
// Tree layout (vkrt_tpu_torch/accel/clusters.py, identical to the JAX
// package's ClusterTree):
//   sc_boxes  f32[8, c2p]         row a: min.xyz (a = 0..2), max.xyz (3..5)
//   cl_boxes  f32[n_sc, 8, 64]    per-supercluster cluster boxes, same rows
//   tri_data  f32[C1p, 128, 128]  per-triangle rows: cols 0-8 v0/e1/e2,
//                                 9-35 shading attributes
// Cluster c of supercluster s has id s*64 + c; triangle k of cluster id
// has slot id*128 + k (leaf order). Padding clusters carry inverted boxes
// (min > max) and all-zero triangles; they are skipped.
//
// Built with -fmad=false: every product and sum below rounds on its own,
// as the plain PyTorch versions do, so kernel and plain version make the
// same decisions on the same inputs.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace vkrt {

constexpr float TMIN = 0.001f;        // ref: shaders/shader.rgen:59
constexpr float DET_EPS = 1e-12f;
constexpr int K1 = 128;               // triangles per cluster
constexpr int K2 = 64;                // clusters per supercluster
constexpr int ROWS = 128;             // columns per triangle row
constexpr int N_ATTR = 36;            // attribute columns 0-35

typedef unsigned long long u64;

__device__ __forceinline__ float safe_inv(float x) {
  const float tiny = 1e-20f;
  float y = fabsf(x) < tiny ? (x < 0.0f ? -tiny : tiny) : x;
  return 1.0f / y;
}

struct Ray {
  float ox, oy, oz;
  float dx, dy, dz;
  float ix, iy, iz;
};

// Slab test of one box against one ray whose current far bound is t_s,
// given the box's corners relative to the ray's origin (lo - o, hi - o:
// taken once a box for rays that share an origin); `tn` receives the
// entry t (the walks' sort key). The `t_s > TMIN` clause makes parked
// rays (t_s = 0) gate nothing.
__device__ __forceinline__ bool slab_rel(float ax, float ay, float az,
                                         float bx, float by, float bz,
                                         float ix, float iy, float iz,
                                         float t_s, float& tn) {
  float t0x = ax * ix;
  float t1x = bx * ix;
  float t0y = ay * iy;
  float t1y = by * iy;
  float t0z = az * iz;
  float t1z = bz * iz;
  tn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fminf(t0z, t1z));
  float tf = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fmaxf(t0z, t1z));
  return (tn <= tf) && (tf >= TMIN) && (tn <= t_s) && (t_s > TMIN);
}

// The same test from the box's corners and the ray's origin.
__device__ __forceinline__ bool slab(float ox, float oy, float oz, float ix,
                                     float iy, float iz, float lo_x,
                                     float lo_y, float lo_z, float hi_x,
                                     float hi_y, float hi_z, float t_s,
                                     float& tn) {
  return slab_rel(lo_x - ox, lo_y - oy, lo_z - oz, hi_x - ox, hi_y - oy,
                  hi_z - oz, ix, iy, iz, t_s, tn);
}

// Möller–Trumbore terms of one triangle (v0, e1, e2), in the JAX kernel's
// operation order (vkrt_tpu/rt/dense.py:354-365). The one definition of
// the arithmetic: A, A' and B pass the nine values of a staged row (cols
// 0-8 of 3 float4 in shared memory), and A recomputes its winner from the
// tree (`mt_terms`), so every kernel decides every pair alike.
struct MT {
  float det, up, vp, tp;
};

__device__ __forceinline__ MT mt_values(const Ray& r, float v0x, float v0y,
                                        float v0z, float e1x, float e1y,
                                        float e1z, float e2x, float e2y,
                                        float e2z) {
  float hx = r.dy * e2z - r.dz * e2y;
  float hy = r.dz * e2x - r.dx * e2z;
  float hz = r.dx * e2y - r.dy * e2x;
  MT m;
  m.det = e1x * hx + e1y * hy + e1z * hz;
  float sx = r.ox - v0x, sy = r.oy - v0y, sz = r.oz - v0z;
  m.up = sx * hx + sy * hy + sz * hz;
  float qx = sy * e1z - sz * e1y;
  float qy = sz * e1x - sx * e1z;
  float qz = sx * e1y - sy * e1x;
  m.vp = r.dx * qx + r.dy * qy + r.dz * qz;
  m.tp = e2x * qx + e2y * qy + e2z * qz;
  return m;
}

// The same terms of a triangle row in device memory.
__device__ __forceinline__ MT mt_terms(const Ray& r,
                                       const float* __restrict__ row) {
  return mt_values(r, __ldg(row + 0), __ldg(row + 1), __ldg(row + 2),
                   __ldg(row + 3), __ldg(row + 4), __ldg(row + 5),
                   __ldg(row + 6), __ldg(row + 7), __ldg(row + 8));
}

// The any-hit test of kernels A' and B: division-free, against the
// sign-corrected determinant (dense.py:367-375).
__device__ __forceinline__ bool occludes(const MT& m, float t_s) {
  float adet = fabsf(m.det);
  float sgn = m.det < 0.0f ? -1.0f : 1.0f;
  float su = m.up * sgn, sv = m.vp * sgn, st = m.tp * sgn;
  return adet > DET_EPS && su >= 0.0f && sv >= 0.0f && su + sv <= adet &&
         st > TMIN * adet && st < t_s * adet;
}

// Append `item` to list[*count] for every lane with `hit`: one shared
// atomic a warp. Every lane of the warp must call it.
template <typename T>
__device__ __forceinline__ void push_hits(bool hit, T item, T* list,
                                          int* count, int lane) {
  const unsigned m = __ballot_sync(0xffffffffu, hit);
  int base = 0;
  if (lane == 0 && m) base = atomicAdd(count, __popc(m));
  base = __shfl_sync(0xffffffffu, base, 0);
  if (hit) list[base + __popc(m & ((1u << lane) - 1u))] = item;
}

// Order-preserving map of a float onto unsigned integers, and back.
__device__ __forceinline__ uint32_t ordered(float f) {
  uint32_t u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}
__device__ __forceinline__ float unordered(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// --- the material heap's level-0 bilinear sample (I and K) ---------------
// Heap layout (scene/textures.py::MaterialHeap): one 48-byte row a texel,
// the 2x2 RGBA quads of its base, metallic-roughness and normal maps, each
// corner 00, 10, 01, 11 one little-endian RGBA word. The arithmetic is
// shade/sampling.py::sample_material's, rounded as PyTorch rounds it on
// CUDA tensors: each product and sum on its own, in that order (the
// library builds with -fmad=false), x = u * w - 0.5, x0 = floor(x) as
// int32, fx = x - x0, the texel index a floor modulo (torch.remainder),
// texel / 255 as texel * (1 / 255) (how PyTorch's true division by a CPU
// scalar runs on CUDA), each bilinear weight its own product, and the
// four-term blend summed left to right.
constexpr int HEAP_ROW_BYTES = 48;
constexpr float INV_255 = 1.0f / 255.0f;

__device__ __forceinline__ int floor_mod(int a, int b) {
  const int r = a % b;
  return (r != 0 && ((r < 0) != (b < 0))) ? r + b : r;
}

// Channel c of one corner's RGBA word as a float in [0, 1].
__device__ __forceinline__ float unorm(unsigned word, int c) {
  return __fmul_rn(static_cast<float>((word >> (8 * c)) & 0xffu), INV_255);
}

// The heap row a sample at (u, v) reads in a map of w x h texels whose
// level 0 starts at row `off`, and its four bilinear weights.
struct Bilinear {
  int row;
  float w00, w10, w01, w11;
};

__device__ __forceinline__ Bilinear bilinear(float u, float v, int off, int w,
                                             int h) {
  const float x = __fsub_rn(__fmul_rn(u, static_cast<float>(w)), 0.5f);
  const float y = __fsub_rn(__fmul_rn(v, static_cast<float>(h)), 0.5f);
  const int x0 = static_cast<int>(floorf(x));
  const int y0 = static_cast<int>(floorf(y));
  const float fx = __fsub_rn(x, static_cast<float>(x0));
  const float fy = __fsub_rn(y, static_cast<float>(y0));
  const float gx = __fsub_rn(1.0f, fx), gy = __fsub_rn(1.0f, fy);
  Bilinear b;
  b.row = off + floor_mod(y0, h) * w + floor_mod(x0, w);
  b.w00 = __fmul_rn(gx, gy);
  b.w10 = __fmul_rn(fx, gy);
  b.w01 = __fmul_rn(gx, fy);
  b.w11 = __fmul_rn(fx, fy);
  return b;
}

// Quad `map` (0 base, 1 metallic-roughness, 2 normal) of heap row `row`.
__device__ __forceinline__ uint4 heap_quad(const uint8_t* __restrict__ texels,
                                           int row, int map) {
  return __ldg(reinterpret_cast<const uint4*>(
                   texels + static_cast<long long>(row) * HEAP_ROW_BYTES) +
               map);
}

// Channel c of the bilinear blend of the quad's corners 00, 10, 01, 11.
__device__ __forceinline__ float blend(const uint4& q, int c,
                                       const Bilinear& b) {
  float s = __fmul_rn(unorm(q.x, c), b.w00);
  s = __fadd_rn(s, __fmul_rn(unorm(q.y, c), b.w10));
  s = __fadd_rn(s, __fmul_rn(unorm(q.z, c), b.w01));
  return __fadd_rn(s, __fmul_rn(unorm(q.w, c), b.w11));
}

}  // namespace vkrt
