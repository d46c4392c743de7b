// Shared gating and layout helpers of the three trace kernels
// (trace_closest.cu: kernel A, trace_occluded.cu: A', occl_multi.cu: B).
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

namespace vkrt {

constexpr float TMIN = 0.001f;        // ref: shaders/shader.rgen:59
constexpr float DET_EPS = 1e-12f;
constexpr int K1 = 128;               // triangles per cluster
constexpr int K2 = 64;                // clusters per supercluster
constexpr int ROWS = 128;             // columns per triangle row
constexpr int N_ATTR = 36;            // attribute columns 0-35

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

// Slab test of one box against one ray whose current far bound is t_s.
// The `t_s > TMIN` clause makes parked rays (t_s = 0) gate nothing.
__device__ __forceinline__ bool slab_hit(const Ray& r, float lo_x, float lo_y,
                                         float lo_z, float hi_x, float hi_y,
                                         float hi_z, float t_s) {
  float t0x = (lo_x - r.ox) * r.ix;
  float t1x = (hi_x - r.ox) * r.ix;
  float t0y = (lo_y - r.oy) * r.iy;
  float t1y = (hi_y - r.oy) * r.iy;
  float t0z = (lo_z - r.oz) * r.iz;
  float t1z = (hi_z - r.oz) * r.iz;
  float tn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fminf(t0z, t1z));
  float tf = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fmaxf(t0z, t1z));
  return (tn <= tf) && (tf >= TMIN) && (tn <= t_s) && (t_s > TMIN);
}

__device__ __forceinline__ bool sc_gate(const Ray& r,
                                        const float* __restrict__ sc_boxes,
                                        int c2p, int s, float t_s) {
  return slab_hit(r, __ldg(sc_boxes + 0 * c2p + s), __ldg(sc_boxes + 1 * c2p + s),
                  __ldg(sc_boxes + 2 * c2p + s), __ldg(sc_boxes + 3 * c2p + s),
                  __ldg(sc_boxes + 4 * c2p + s), __ldg(sc_boxes + 5 * c2p + s),
                  t_s);
}

// Cluster c of supercluster s; false for padding clusters (min > max).
__device__ __forceinline__ bool cl_gate(const Ray& r,
                                        const float* __restrict__ cl_boxes,
                                        int s, int c, float t_s) {
  const float* b = cl_boxes + (size_t)s * 8 * K2 + c;
  float lo_x = __ldg(b + 0 * K2), hi_x = __ldg(b + 3 * K2);
  if (!(lo_x <= hi_x)) return false;
  return slab_hit(r, lo_x, __ldg(b + 1 * K2), __ldg(b + 2 * K2), hi_x,
                  __ldg(b + 4 * K2), __ldg(b + 5 * K2), t_s);
}

// Möller–Trumbore terms of one triangle row, in the JAX kernel's
// operation order (vkrt_tpu/rt/dense.py:354-365).
struct MT {
  float det, up, vp, tp;
};

__device__ __forceinline__ MT mt_terms(const Ray& r,
                                       const float* __restrict__ row) {
  float v0x = __ldg(row + 0), v0y = __ldg(row + 1), v0z = __ldg(row + 2);
  float e1x = __ldg(row + 3), e1y = __ldg(row + 4), e1z = __ldg(row + 5);
  float e2x = __ldg(row + 6), e2y = __ldg(row + 7), e2z = __ldg(row + 8);
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

}  // namespace vkrt
