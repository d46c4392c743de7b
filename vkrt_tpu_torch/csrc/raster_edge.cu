// Kernel G: edge-function coverage + depth-min commit per pixel.
//
// Replaces the Pallas kernel vkrt_tpu/raster/edge.py::_raster_kernel
// (:204), entry raster_edge (:402).
//
// What bounds it on the H100: the edge-function evaluations. Each
// (pixel, triangle) pair of a gated cluster costs 19 float operations
// (three barycentric rows a*px + b*py + c, their sum, the depth
// sum(beta_i * Z_i)) plus 7 compares; the bytes are small beside them
// (the setup rows once, 80 bytes a triangle, and 32 bytes in and out per
// pixel). The TPU kernel swept whole 512-pixel blocks against each
// cluster a block-level box gate let through, with a front-to-back work
// list and a block-wide early-z bound, because its vector unit wants
// dense [128, R] tiles. Here one thread owns one pixel: it gates each
// supercluster and cluster box against its own position and its own
// committed depth, so it sweeps only the clusters that can cover it and
// skips every cluster whose screen zmin is >= the depth it already has.
// Neighbouring pixels of a warp (two rows of an 8x16 subtile) gate
// nearly the same clusters, so their setup loads are broadcasts served
// by L1: a triangle's row is read as five float4. Shared-memory staging
// of a cluster's rows, a front-to-back work list and TMA are left for a
// later kernel.
//
// Semantics (same as raster_edge_plain in vkrt_tpu_torch/raster/edge.py):
//   a fragment counts where beta_0,1,2 >= 0, sum beta > 0, 0 <= z <= 1
//   and z > zfloor (strict); zfloor >= 1e9 parks the pixel;
//   beta_i = (a_i*px + b_i*py) + c_i, z = (beta_0*Z0 + beta_1*Z1) +
//   beta_2*Z2 in this order and without FMA (-fmad=false), so kernel and
//   plain version compute the same bits; u = uw / sum(beta) by IEEE
//   division;
//   clusters in ascending id, triangles in ascending index, a strict <
//   commit: ties go to the lowest slot;
//   a box gates a pixel if lo - 1/64 <= p <= hi + 1/64 in x and y (the
//   boxes come from a division, coverage from homogeneous coordinates)
//   and its zmin < the pixel's committed depth (1e9 before any commit);
//   zmin lies below every depth this kernel computes in the box (the
//   setup lowers it by a bound on the float32 error), so the skip drops
//   no fragment that could win and the answer is the nearest fragment
//   of the gated clusters whatever the visit order;
//   miss: z = +inf, slot = -1, u = v = 0, mat = 0.
#include <cuda_runtime.h>

namespace vkrt {

constexpr int RK1 = 128;             // triangles per cluster
constexpr int RK2 = 64;              // clusters per supercluster
constexpr int SETUP_W = 20;          // floats per setup row (19 used)
constexpr float ZFAR_PARK = 1.0e9f;
constexpr float BOX_PAD = 0.015625f;

// Box b (rows lo x, y, z at 0-2 and hi x, y at 3-4, `stride` floats
// apart) against pixel (x, y) and its committed depth z_cur.
__device__ __forceinline__ bool in_box(const float* __restrict__ b, int stride,
                                       float x, float y, float z_cur) {
  return (__ldg(b + 0 * stride) - BOX_PAD <= x) &&
         (x <= __ldg(b + 3 * stride) + BOX_PAD) &&
         (__ldg(b + 1 * stride) - BOX_PAD <= y) &&
         (y <= __ldg(b + 4 * stride) + BOX_PAD) &&
         (__ldg(b + 2 * stride) < z_cur);
}

struct Row {
  float4 q0, q1, q2, q3, q4;  // columns 0-19
};

__device__ __forceinline__ Row load_row(const float* __restrict__ setup,
                                        int slot) {
  const float4* p =
      reinterpret_cast<const float4*>(setup + (size_t)slot * SETUP_W);
  Row r;
  r.q0 = __ldg(p + 0);
  r.q1 = __ldg(p + 1);
  r.q2 = __ldg(p + 2);
  r.q3 = __ldg(p + 3);
  r.q4 = __ldg(p + 4);
  return r;
}

__global__ void __launch_bounds__(128)
raster_edge_kernel(const float* __restrict__ setup,   // [C1p, 128, 20]
                   const float* __restrict__ scb, int c2p, int n_sc,
                   const float* __restrict__ clb,     // [n_sc, 8, 64]
                   const float* __restrict__ px, const float* __restrict__ py,
                   const float* __restrict__ zfloor, int n,
                   float* __restrict__ z_out, int* __restrict__ slot_out,
                   float* __restrict__ u_out, float* __restrict__ v_out,
                   int* __restrict__ mat_out) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float x = px[i], y = py[i], zf = zfloor[i];
  float z_cur = zf < ZFAR_PARK ? ZFAR_PARK : -ZFAR_PARK;
  int best = -1;

  for (int s = 0; s < n_sc; ++s) {
    if (!in_box(scb + s, c2p, x, y, z_cur)) continue;
    const float* cb = clb + (size_t)s * 8 * RK2;
    for (int c = 0; c < RK2; ++c) {
      if (!in_box(cb + c, RK2, x, y, z_cur)) continue;
      const int base = (s * RK2 + c) * RK1;
      for (int k = 0; k < RK1; ++k) {
        Row r = load_row(setup, base + k);
        float b0 = (r.q0.x * x + r.q0.y * y) + r.q0.z;
        float b1 = (r.q0.w * x + r.q1.x * y) + r.q1.y;
        float b2 = (r.q1.z * x + r.q1.w * y) + r.q2.x;
        float sumb = (b0 + b1) + b2;
        float zz = (b0 * r.q2.y + b1 * r.q2.z) + b2 * r.q2.w;
        if (b0 >= 0.0f && b1 >= 0.0f && b2 >= 0.0f && sumb > 0.0f &&
            zz >= 0.0f && zz <= 1.0f && zz > zf && zz < z_cur) {
          z_cur = zz;
          best = base + k;
        }
      }
    }
  }

  if (best < 0) {
    z_out[i] = __int_as_float(0x7f800000);  // +inf
    slot_out[i] = -1;
    u_out[i] = 0.0f;
    v_out[i] = 0.0f;
    mat_out[i] = 0;
    return;
  }
  // the winner's attributes, recomputed once with the sweep's arithmetic
  Row r = load_row(setup, best);
  float b0 = (r.q0.x * x + r.q0.y * y) + r.q0.z;
  float b1 = (r.q0.w * x + r.q1.x * y) + r.q1.y;
  float b2 = (r.q1.z * x + r.q1.w * y) + r.q2.x;
  float sumb = (b0 + b1) + b2;
  float uw = (b0 * r.q3.x + b1 * r.q3.z) + b2 * r.q4.x;   // u0, u1, u2
  float vw = (b0 * r.q3.y + b1 * r.q3.w) + b2 * r.q4.y;   // v0, v1, v2
  z_out[i] = z_cur;
  slot_out[i] = best;
  u_out[i] = uw / sumb;
  v_out[i] = vw / sumb;
  mat_out[i] = static_cast<int>(r.q4.z);                  // column 18
}

}  // namespace vkrt

// Plain C entry point (bound with ctypes). Returns cudaGetLastError()
// after the launch; the launch does not synchronise.
extern "C" int vkrt_raster_edge(const float* setup, const float* scb, int c2p,
                                int n_sc, const float* clb, const float* px,
                                const float* py, const float* zfloor, int n,
                                float* z_out, int* slot_out, float* u_out,
                                float* v_out, int* mat_out, void* stream) {
  if (n > 0) {
    const int threads = 128;
    const int blocks = (n + threads - 1) / threads;
    vkrt::raster_edge_kernel<<<blocks, threads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
        setup, scb, c2p, n_sc, clb, px, py, zfloor, n, z_out, slot_out, u_out,
        v_out, mat_out);
  }
  return static_cast<int>(cudaGetLastError());
}
