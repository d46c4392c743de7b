// Kernel J: the screen box and least depth of the fragments kernel G can
// keep from a triangle that crosses w = 0.
//
// Replaces no Pallas kernel: the JAX package gives such a triangle's
// cluster a full-screen box with zmin 0 (vkrt_tpu/raster/edge.py,
// build_raster_setup), and so did the port, which made every block of G
// sweep those clusters first in every launch. Its plain version is
// vkrt_tpu_torch/raster/clip.py::clip_boxes_plain.
//
// What G keeps of a triangle: the samples p of the screen [0, W] x [0, H]
// where its three float32 edge rows beta_i(p) = (a_i x + b_i y) + c_i are
// >= 0 and its depth z(p) = sum_i beta_i Z_i lies in [0, 1]. All of
// these are linear in p, so the set is a convex polygon of the screen:
// the screen rectangle clipped (Sutherland-Hodgman) by five half-planes,
// each widened by a bound on G's float32 error so that it holds every
// sample G's arithmetic can admit, not only the exact ones:
//   edge i:  (a_i x + b_i y) + c_i + e_i >= 0,  e_i = 2^-20 T_i,
//            T_i = |a_i| W + |b_i| H + |c_i| (G's rounding of beta_i is
//            at most ~3 ulps of T_i on the screen);
//   near:    z(p) + ez >= 0,   ez = 2^-20 sum_i |Z_i| T_i;
//   far:     1 + ez - z(p) >= 0
// (G's z is off by at most ~6 ulps of sum_i |Z_i| T_i). The rows are the
// setup's own float32 values, read exactly as float64. The box is the
// polygon's vertices' extent, rounded outward to float32; zmin is their
// least exact depth, lowered by ez and by 2^-22 of itself (the setup's pad
// for its other triangles), clamped at 0, rounded down. A polygon that
// clipping empties gives the empty box (lo 1e8, hi -1e8, zmin 1e8).
// Every clipped vertex lies on the screen and needs no division by w.
//
// One thread a triangle slot, in float64, every product, sum and
// quotient rounded on its own (__dmul_rn, __dadd_rn, __dsub_rn,
// __ddiv_rn) in the plain version's order, so the two agree bit for bit.
// A slot not marked `crossing` writes the empty box and leaves: about
// 1,000 of the 270,336 slots of the raster cell's tree do work. A clip
// that would pass MAX_VERTS vertices (rounding can bend the polygon by an
// ulp) stops, keeping the polygon before that plane: its box holds the
// clipped one.
#include <cuda_runtime.h>
#include <stdint.h>

namespace vkrt {

constexpr int CLIP_THREADS = 256;
constexpr int MAX_VERTS = 16;          // 4 corners + 1 a plane, with room
constexpr double ERR_ULPS = 0.00000095367431640625;   // 2^-20
constexpr double ZPAD = 0.0000002384185791015625;     // 2^-22
constexpr float EMPTY = 1.0e8f;
constexpr int SETUP_W = 20;

__device__ __forceinline__ double lin(double a, double b, double c, double x,
                                      double y) {
  return __dadd_rn(__dadd_rn(__dmul_rn(a, x), __dmul_rn(b, y)), c);
}

__global__ void __launch_bounds__(CLIP_THREADS)
raster_clip_kernel(const float* __restrict__ setup,      // [n, 20]
                   const uint8_t* __restrict__ crossing,  // [n]
                   int n, double width, double height,
                   float* __restrict__ out) {             // [5, n]
  const int i = blockIdx.x * CLIP_THREADS + threadIdx.x;
  if (i >= n) return;
  float lo_x = EMPTY, lo_y = EMPTY, hi_x = -EMPTY, hi_y = -EMPTY;
  float zlo = EMPTY;
  if (crossing[i]) {
    const float* r = setup + (size_t)i * SETUP_W;
    double a[3], b[3], c[3], zc[3], t[3];
    for (int k = 0; k < 3; ++k) {
      a[k] = r[3 * k];
      b[k] = r[3 * k + 1];
      c[k] = r[3 * k + 2];
      zc[k] = r[9 + k];
      t[k] = __dadd_rn(__dadd_rn(__dmul_rn(fabs(a[k]), width),
                                 __dmul_rn(fabs(b[k]), height)),
                       fabs(c[k]));
    }
    const double az = __dadd_rn(__dadd_rn(__dmul_rn(a[0], zc[0]),
                                          __dmul_rn(a[1], zc[1])),
                                __dmul_rn(a[2], zc[2]));
    const double bz = __dadd_rn(__dadd_rn(__dmul_rn(b[0], zc[0]),
                                          __dmul_rn(b[1], zc[1])),
                                __dmul_rn(b[2], zc[2]));
    const double cz = __dadd_rn(__dadd_rn(__dmul_rn(c[0], zc[0]),
                                          __dmul_rn(c[1], zc[1])),
                                __dmul_rn(c[2], zc[2]));
    const double ez = __dmul_rn(
        __dadd_rn(__dadd_rn(__dmul_rn(fabs(zc[0]), t[0]),
                            __dmul_rn(fabs(zc[1]), t[1])),
                  __dmul_rn(fabs(zc[2]), t[2])),
        ERR_ULPS);
    // the five half-planes A x + B y + C >= 0
    double pa[5], pb[5], pc[5];
    for (int k = 0; k < 3; ++k) {
      pa[k] = a[k];
      pb[k] = b[k];
      pc[k] = __dadd_rn(c[k], __dmul_rn(t[k], ERR_ULPS));
    }
    pa[3] = az;
    pb[3] = bz;
    pc[3] = __dadd_rn(cz, ez);
    pa[4] = -az;
    pb[4] = -bz;
    pc[4] = __dsub_rn(__dadd_rn(1.0, ez), cz);

    double x[2][MAX_VERTS], y[2][MAX_VERTS];
    int cur = 0, m = 4;
    x[0][0] = 0.0;   y[0][0] = 0.0;
    x[0][1] = width; y[0][1] = 0.0;
    x[0][2] = width; y[0][2] = height;
    x[0][3] = 0.0;   y[0][3] = height;
    for (int p = 0; p < 5 && m > 0; ++p) {
      double d[MAX_VERTS];
      for (int k = 0; k < m; ++k)
        d[k] = lin(pa[p], pb[p], pc[p], x[cur][k], y[cur][k]);
      int q = 0;
      bool over = false;
      for (int k = 0; k < m; ++k) {
        const int j = k + 1 < m ? k + 1 : 0;
        const bool in = d[k] >= 0.0, in_j = d[j] >= 0.0;
        if (in) {
          if (q == MAX_VERTS) { over = true; break; }
          x[cur ^ 1][q] = x[cur][k];
          y[cur ^ 1][q] = y[cur][k];
          ++q;
        }
        if (in != in_j) {
          if (q == MAX_VERTS) { over = true; break; }
          const double s = __ddiv_rn(d[k], __dsub_rn(d[k], d[j]));
          x[cur ^ 1][q] = __dadd_rn(
              x[cur][k], __dmul_rn(s, __dsub_rn(x[cur][j], x[cur][k])));
          y[cur ^ 1][q] = __dadd_rn(
              y[cur][k], __dmul_rn(s, __dsub_rn(y[cur][j], y[cur][k])));
          ++q;
        }
      }
      if (over) break;           // keep the polygon before this plane
      cur ^= 1;
      m = q;
    }
    if (m > 0) {
      double xl = x[cur][0], xh = xl, yl = y[cur][0], yh = yl;
      double zm = lin(az, bz, cz, xl, yl);
      for (int k = 1; k < m; ++k) {
        xl = fmin(xl, x[cur][k]);
        xh = fmax(xh, x[cur][k]);
        yl = fmin(yl, y[cur][k]);
        yh = fmax(yh, y[cur][k]);
        zm = fmin(zm, lin(az, bz, cz, x[cur][k], y[cur][k]));
      }
      double zp = __dsub_rn(__dsub_rn(zm, __dmul_rn(fabs(zm), ZPAD)), ez);
      zp = zp > 0.0 ? zp : 0.0;
      lo_x = __double2float_rd(xl);
      lo_y = __double2float_rd(yl);
      hi_x = __double2float_ru(xh);
      hi_y = __double2float_ru(yh);
      zlo = __double2float_rd(zp);
    }
  }
  out[i] = lo_x;
  out[n + i] = lo_y;
  out[2 * (size_t)n + i] = hi_x;
  out[3 * (size_t)n + i] = hi_y;
  out[4 * (size_t)n + i] = zlo;
}

}  // namespace vkrt

// Plain C entry point (bound with ctypes): setup f32[n, 20] (the raster
// setup's rows), crossing u8[n], out f32[5, n] (lo x, lo y, hi x, hi y,
// zmin). Returns cudaGetLastError() after the launch; the launch does not
// synchronise.
extern "C" int vkrt_raster_clip(const float* setup, const uint8_t* crossing,
                                int n, double width, double height,
                                float* out, void* stream) {
  using namespace vkrt;
  if (n > 0) {
    const int blocks = (n + CLIP_THREADS - 1) / CLIP_THREADS;
    raster_clip_kernel<<<blocks, CLIP_THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        setup, crossing, n, width, height, out);
  }
  return static_cast<int>(cudaGetLastError());
}
