// Kernel A: closest-hit trace with the 36-attribute select.
//
// Replaces the Pallas kernel vkrt_tpu/rt/dense.py::_trace_kernel (:238)
// in its closest-hit mode, with and without the attribute select and
// point_origin (:257-265), entry trace_dense (:802).
//
// What bounds it on the H100: the Möller–Trumbore sweeps, ~30 float ops
// per (ray, triangle) pair, and the divergence between neighbouring rays
// that gate different clusters. The TPU kernel swept whole 512-ray
// blocks against each gated cluster because its vector unit wants dense
// [128, R] tiles; on a GPU one thread per ray walks the tree on its own,
// gating each supercluster and cluster box against its own current hit
// distance, so a ray never sweeps a cluster that only its neighbours
// reach and skips every box beyond its nearest hit so far. Triangle rows
// are read through the read-only cache; rays of one warp are camera- or
// reflection-coherent (the engine's 8x16-pixel subtiles), so they mostly
// read the same rows. The 36 attributes of the winning triangle are
// loaded once at the end, by direct indexed loads in place of the TPU's
// one-hot MXU matmul.
//
// Semantics kept from the Pallas kernel:
//   commit needs |det| > 1e-12, u, v >= 0, u + v <= 1, TMIN < t < t_cur,
//   with exact IEEE division (no approximate reciprocal);
//   ties keep the smaller t, then the lower triangle index in a cluster;
//   across clusters a strict < keeps the first visited (here: the lower
//   cluster id, so every tie resolves to the lowest slot);
//   miss: t = inf, slot = -1, u = v = 0, attrs = 0.
// With `block` > 0 the rays of one block share an origin: ray i starts at
// o_pts[i / block] (the TPU kernel's point_origin operands); the
// arithmetic is the same, so the result equals the broadcast origins'.
// A null attr_out skips the attribute select (with_attributes=False).
#include "common.cuh"

namespace vkrt {

__global__ void __launch_bounds__(128)
trace_closest_kernel(const float* __restrict__ sc_boxes, int c2p, int n_sc,
                     const float* __restrict__ cl_boxes,
                     const float* __restrict__ tri_data,
                     const float* __restrict__ orig,   // [3, n] or [n/block, 3]
                     int block,                        // 0: per-ray origins
                     const float* __restrict__ dirs,   // [3, n]
                     const float* __restrict__ tmax,   // [n]
                     int n, float* __restrict__ t_out, int* __restrict__ slot_out,
                     float* __restrict__ u_out, float* __restrict__ v_out,
                     float* __restrict__ attr_out) {   // [36, n]
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Ray r;
  if (block > 0) {
    const float* p = orig + (size_t)(i / block) * 3;
    r.ox = __ldg(p + 0);
    r.oy = __ldg(p + 1);
    r.oz = __ldg(p + 2);
  } else {
    r.ox = orig[i];
    r.oy = orig[(size_t)n + i];
    r.oz = orig[2 * (size_t)n + i];
  }
  r.dx = dirs[i];
  r.dy = dirs[(size_t)n + i];
  r.dz = dirs[2 * (size_t)n + i];
  r.ix = safe_inv(r.dx);
  r.iy = safe_inv(r.dy);
  r.iz = safe_inv(r.dz);
  float t_cur = tmax[i];
  int best = -1;
  float bu = 0.0f, bv = 0.0f;

  for (int s = 0; s < n_sc; ++s) {
    if (!sc_gate(r, sc_boxes, c2p, s, t_cur)) continue;
    for (int c = 0; c < K2; ++c) {
      if (!cl_gate(r, cl_boxes, s, c, t_cur)) continue;
      int cid = s * K2 + c;
      const float* tri = tri_data + (size_t)cid * K1 * ROWS;
      for (int k = 0; k < K1; ++k) {
        MT m = mt_terms(r, tri + (size_t)k * ROWS);
        if (!(fabsf(m.det) > DET_EPS)) continue;
        float inv_det = 1.0f / m.det;
        float uu = m.up * inv_det;
        float vv = m.vp * inv_det;
        float tt = m.tp * inv_det;
        if (uu >= 0.0f && vv >= 0.0f && uu + vv <= 1.0f && tt > TMIN &&
            tt < t_cur) {
          t_cur = tt;
          best = cid * K1 + k;
          bu = uu;
          bv = vv;
        }
      }
    }
  }

  t_out[i] = best >= 0 ? t_cur : __int_as_float(0x7f800000);  // +inf
  slot_out[i] = best;
  u_out[i] = bu;
  v_out[i] = bv;
  if (attr_out == nullptr) return;
  const float* row = tri_data + (size_t)(best >= 0 ? best : 0) * ROWS;
  for (int a = 0; a < N_ATTR; ++a)
    attr_out[(size_t)a * n + i] = best >= 0 ? __ldg(row + a) : 0.0f;
}

}  // namespace vkrt

// Plain C entry point (bound with ctypes). Returns cudaGetLastError()
// after the launch; the launch does not synchronise.
extern "C" int vkrt_trace_closest(const float* sc_boxes, int c2p, int n_sc,
                                  const float* cl_boxes, const float* tri_data,
                                  const float* orig, int block,
                                  const float* dirs, const float* tmax,
                                  int n, float* t_out,
                                  int* slot_out, float* u_out, float* v_out,
                                  float* attr_out, void* stream) {
  if (n > 0) {
    const int threads = 128;
    const int blocks = (n + threads - 1) / threads;
    vkrt::trace_closest_kernel<<<blocks, threads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
        sc_boxes, c2p, n_sc, cl_boxes, tri_data, orig, block, dirs, tmax, n,
        t_out, slot_out, u_out, v_out, attr_out);
  }
  return static_cast<int>(cudaGetLastError());
}
