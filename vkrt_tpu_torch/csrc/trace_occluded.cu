// Kernel A': any-hit (occlusion) trace with per-ray or per-block origins.
//
// Replaces the Pallas kernel vkrt_tpu/rt/dense.py::_trace_kernel (:238)
// in its occlusion mode (the any-hit branch, :367-384) with and without
// point_origin (:257-265), entry trace_dense (:802).
//
// What bounds it on the H100: the Möller–Trumbore sweeps up to each
// ray's first blocker, as in kernel B. The TPU kernel kept a whole
// block's rays in flight until the block's last ray was blocked (a
// per-block max-t culled later gates) and read a shared origin from
// scalar memory to shrink its [K1,R] products; on a GPU one thread takes
// one ray, walks the boxes against its own segment and returns at its
// first blocking triangle, and a shared origin is just a broadcast load:
// with `block` > 0 ray i starts at o_pts[i / block], else at orig[:, i].
//
// Semantics kept from the Pallas kernel: the division-free test against
// the sign-corrected determinant, in kernel B's operation order, so the
// two kernels decide every segment alike: |det| > 1e-12, su, sv >= 0,
// su + sv <= |det|, st > TMIN*|det|, st < tmax*|det|. A parked ray
// (tmax = 0) is not blocked, and neither is a live one with
// 0 < tmax <= TMIN (its interval is empty). Outputs as the Pallas kernel
// leaves them: blocked → slot 1, t = TMIN; free → slot -1, t = +inf;
// u = v = 0 always.
#include "common.cuh"

namespace vkrt {

__global__ void __launch_bounds__(128)
trace_occluded_kernel(const float* __restrict__ sc_boxes, int c2p, int n_sc,
                      const float* __restrict__ cl_boxes,
                      const float* __restrict__ tri_data,
                      const float* __restrict__ orig,   // [3, n] or [n/block, 3]
                      int block,                        // 0: per-ray origins
                      const float* __restrict__ dirs,   // [3, n]
                      const float* __restrict__ tmax,   // [n]
                      int n, float* __restrict__ t_out, int* __restrict__ slot_out,
                      float* __restrict__ u_out, float* __restrict__ v_out) {
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
  const float t_s = tmax[i];
  bool hit = false;

  if (t_s > TMIN) {
    for (int sc = 0; sc < n_sc && !hit; ++sc) {
      if (!sc_gate(r, sc_boxes, c2p, sc, t_s)) continue;
      for (int c = 0; c < K2 && !hit; ++c) {
        if (!cl_gate(r, cl_boxes, sc, c, t_s)) continue;
        const float* tri = tri_data + (size_t)(sc * K2 + c) * K1 * ROWS;
        for (int k = 0; k < K1; ++k) {
          MT m = mt_terms(r, tri + (size_t)k * ROWS);
          float adet = fabsf(m.det);
          float sgn = m.det < 0.0f ? -1.0f : 1.0f;
          float su = m.up * sgn, sv = m.vp * sgn, st = m.tp * sgn;
          if (adet > DET_EPS && su >= 0.0f && sv >= 0.0f && su + sv <= adet &&
              st > TMIN * adet && st < t_s * adet) {
            hit = true;
            break;
          }
        }
      }
    }
  }
  t_out[i] = hit ? TMIN : __int_as_float(0x7f800000);  // +inf
  slot_out[i] = hit ? 1 : -1;
  u_out[i] = 0.0f;
  v_out[i] = 0.0f;
}

}  // namespace vkrt

// Plain C entry point (bound with ctypes). Returns cudaGetLastError()
// after the launch; the launch does not synchronise.
extern "C" int vkrt_trace_occluded(const float* sc_boxes, int c2p, int n_sc,
                                   const float* cl_boxes,
                                   const float* tri_data, const float* orig,
                                   int block, const float* dirs,
                                   const float* tmax, int n, float* t_out,
                                   int* slot_out, float* u_out, float* v_out,
                                   void* stream) {
  if (n > 0) {
    const int threads = 128;
    const int blocks = (n + threads - 1) / threads;
    vkrt::trace_occluded_kernel<<<blocks, threads, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
        sc_boxes, c2p, n_sc, cl_boxes, tri_data, orig, block, dirs, tmax, n,
        t_out, slot_out, u_out, v_out);
  }
  return static_cast<int>(cudaGetLastError());
}
