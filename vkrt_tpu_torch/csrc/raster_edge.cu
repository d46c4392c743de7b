// Kernel G: edge-function coverage + depth-min commit per pixel.
//
// Replaces the Pallas kernel vkrt_tpu/raster/edge.py::_raster_kernel
// (:204), entry raster_edge (:402).
//
// What bounds it on the H100: the edge-function evaluations. Each
// (pixel, triangle) pair of a gated cluster costs 19 float operations
// (three barycentric rows a*px + b*py + c, their sum, the depth
// sum(beta_i * Z_i)) plus the compares, none of them an FMA (the plain
// version rounds every product and sum, and the two must agree bit for
// bit); the bytes are small beside them (the setup rows once, 80 bytes a
// triangle, and 32 bytes in and out per pixel). So the design spends its
// effort on evaluating fewer pairs and on keeping loads out of the
// arithmetic's way:
//
//   * One block of 128 threads owns PPT consecutive 128-lane groups, PPT
//     pixels a thread (in the engine's tile order a group is one 8x16
//     subtile, and two neighbours make an 8x32 strip). It reduces the
//     bounding box of its LIVE lanes' positions; the kernel takes any
//     positions, the tile order only makes that box small. A block with
//     no live lane writes its misses and leaves: in the alpha-discard
//     rounds, where a few pixels of the frame are live, almost every
//     block ends here, and a block with one live pixel gates a one-pixel
//     box.
//   * The block gates the tree cooperatively: a thread per supercluster
//     box, then a thread per cluster of each gated supercluster (a row of
//     64 floats of `clb` is one coalesced read). Hits are compacted (warp
//     ballot + one shared atomic a warp) into a work list in shared
//     memory of (zmin, cluster id) keys, which a bitonic network then
//     sorts by zmin.
//   * The walk is front to back. Before each cluster the block asks
//     whether any live lane's committed depth is still >= the cluster's
//     zmin; the list is sorted, so the first cluster nobody needs ends
//     the walk. A warp none of whose pixels lies in the cluster's own
//     box (or needs its depth range) skips the sweep.
//   * The 12 floats of each row that the sweep reads (48 of its 80
//     bytes) are staged in shared memory with cp.async, 16 bytes a copy,
//     double-buffered: cluster e+1 arrives while cluster e is swept, one
//     barrier a cluster. A thread reads a row as three broadcast 16-byte
//     shared loads and feeds them to all of its PPT pixels; a pixel
//     outside the first edge skips the other two, and the depth is
//     computed only where all three pass.
//
// The list lives in shared memory, 8 bytes a cluster, so the block takes
// the tree in chunks of at most `chunk` superclusters by id (MAX_LIST_SC,
// 256 = 16,384 clusters, about 2M triangles, by default): it gates,
// sorts and walks one chunk, then the next, carrying each pixel's
// committed depth and slot across them. By the tie rule below the answer
// does not depend on the order in which clusters are visited, so the
// chunks give the same answer as one list; a chunk's walk ends where
// nobody needs its next cluster, and the next chunk starts its own.
//
// Semantics (same as raster_edge_plain in vkrt_tpu_torch/raster/edge.py):
//   a fragment counts where beta_0,1,2 >= 0, sum beta > 0, 0 <= z <= 1
//   and z > zfloor (strict); zfloor >= 1e9 parks the pixel;
//   beta_i = (a_i*px + b_i*py) + c_i, z = (beta_0*Z0 + beta_1*Z1) +
//   beta_2*Z2 in this order and without FMA (-fmad=false), so kernel and
//   plain version compute the same bits; u = uw / sum(beta) by IEEE
//   division;
//   the nearest fragment wins and, among fragments of equal depth, the
//   lowest slot (cluster id * 128 + triangle): a fragment commits if
//   z < committed z, or z == committed z and its slot is lower. The rule
//   is explicit because clusters are visited by zmin, not by id;
//   a pixel evaluates a cluster only if lo - 1/64 <= p <= hi + 1/64 in x
//   and y (the boxes come from a division, coverage from homogeneous
//   coordinates) and commits nothing from a cluster whose box does not
//   hold it so;
//   a cluster is skipped, for a pixel and for the block, only where its
//   zmin > the committed depth: zmin lies at or below every depth this
//   kernel computes in the box (the setup lowers it by a bound on the
//   float32 error and clamps it at 0), so a cluster whose zmin EQUALS the
//   committed depth may still hold an equal fragment of a lower slot and
//   is kept, and the answer is the nearest fragment of the gated
//   clusters, ties to the lowest slot, whatever the visit order;
//   miss: z = +inf, slot = -1, u = v = 0, mat = 0.
#include "common.cuh"

namespace vkrt {

constexpr int RK1 = 128;             // triangles per cluster
constexpr int RK2 = 64;              // clusters per supercluster
constexpr int SETUP_W = 20;          // floats per setup row (19 used)
constexpr int SWEEP_Q = 3;           // float4 of a row the sweep reads (0-11)
constexpr int THREADS = 128;         // one lane group
constexpr int PPT = 2;               // pixels (lane groups) per thread
constexpr int MAX_LIST_SC = 256;     // superclusters a chunk may hold
constexpr float ZFAR_PARK = 1.0e9f;
constexpr float BOX_PAD = 0.015625f;
constexpr float BIG = 3.0e38f;

// Box b (rows lo x, y at 0-1 and hi x, y at 3-4, `stride` floats apart),
// widened by BOX_PAD, against the rectangle [xlo, xhi] x [ylo, yhi]. With
// xlo == xhi and ylo == yhi this is the per-pixel gate of the plain
// version; a pixel inside the rectangle that passes its own gate makes
// the rectangle pass.
__device__ __forceinline__ bool box_meets(const float* __restrict__ b,
                                          int stride, float xlo, float xhi,
                                          float ylo, float yhi) {
  return (__ldg(b + 0 * stride) - BOX_PAD <= xhi) &&
         (xlo <= __ldg(b + 3 * stride) + BOX_PAD) &&
         (__ldg(b + 1 * stride) - BOX_PAD <= yhi) &&
         (ylo <= __ldg(b + 4 * stride) + BOX_PAD);
}

// Sort list[0..n) ascending: the bitonic network with every comparator
// ascending (a merge's first step compares mirrored positions), in which
// a padding of +inf past n would never move, so a partner at or past n is
// simply skipped and n need not be a power of two.
__device__ __forceinline__ void sort_list(u64* list, int n, int t) {
  for (int k = 2; (k >> 1) < n; k <<= 1) {
    for (int d = k >> 1; d > 0; d >>= 1) {
      const int flip = (d == (k >> 1)) ? (k - 1) : d;
      for (int i = t; i < n; i += THREADS) {
        const int j = i ^ flip;
        if (j > i && j < n) {
          const u64 a = list[i], b = list[j];
          if (b < a) {
            list[i] = b;
            list[j] = a;
          }
        }
      }
      __syncthreads();
    }
  }
}

// One staged cluster against the thread's pixels. `sweep` has bit p set
// where some pixel p of the warp needs the cluster (ALL: every bit is
// set); bit p of `mine` says whether this thread's own pixel p does.
template <bool ALL>
__device__ __forceinline__ void sweep_rows(
    const float4* rows, int base, unsigned sweep, const float (&x)[PPT],
    const float (&y)[PPT], const float (&zf)[PPT], unsigned mine,
    float (&z_cur)[PPT], int (&best)[PPT]) {
#pragma unroll 4
  for (int k = 0; k < RK1; ++k) {
    const float4 q0 = rows[SWEEP_Q * k + 0];   // a0 b0 c0 a1
    const float4 q1 = rows[SWEEP_Q * k + 1];   // b1 c1 a2 b2
    const float4 q2 = rows[SWEEP_Q * k + 2];   // c2 Z0 Z1 Z2
#pragma unroll
    for (int p = 0; p < PPT; ++p) {
      if (!ALL && !(sweep >> p & 1u)) continue;  // the warp as one
      const float b0 = (q0.x * x[p] + q0.y * y[p]) + q0.z;
      if (!(b0 >= 0.0f)) continue;   // most pairs end at the first edge
      const float b1 = (q0.w * x[p] + q1.x * y[p]) + q1.y;
      const float b2 = (q1.z * x[p] + q1.w * y[p]) + q2.x;
      if (b1 >= 0.0f && b2 >= 0.0f) {
        const float sumb = (b0 + b1) + b2;
        const float zz = (b0 * q2.y + b1 * q2.z) + b2 * q2.w;
        if ((mine >> p & 1u) && sumb > 0.0f && zz >= 0.0f && zz <= 1.0f &&
            zz > zf[p] &&
            (zz < z_cur[p] || (zz == z_cur[p] && base + k < best[p]))) {
          z_cur[p] = zz;
          best[p] = base + k;
        }
      }
    }
  }
}

__global__ void __launch_bounds__(THREADS)
raster_edge_kernel(const float* __restrict__ setup,   // [C1p, 128, 20]
                   const float* __restrict__ scb, int c2p, int n_sc,
                   int chunk,                          // superclusters a pass
                   const float* __restrict__ clb,     // [n_sc, 8, 64]
                   const float* __restrict__ px, const float* __restrict__ py,
                   const float* __restrict__ zfloor, int n,
                   float* __restrict__ z_out, int* __restrict__ slot_out,
                   float* __restrict__ u_out, float* __restrict__ v_out,
                   int* __restrict__ mat_out) {
  // dynamic shared memory: a chunk's work list, two staging buffers,
  // their clusters' boxes (lo x, lo y, hi x, hi y), the chunk's gated
  // superclusters
  extern __shared__ __align__(16) unsigned char smem[];
  const int lc = min(n_sc, chunk);                             // list length
  u64* list = reinterpret_cast<u64*>(smem);                    // [lc*64]
  float4* stage = reinterpret_cast<float4*>(list + lc * RK2);
  float* sbox = reinterpret_cast<float*>(stage + 2 * RK1 * SWEEP_Q);  // [2][4]
  int* sc_hit = reinterpret_cast<int*>(sbox + 8);              // [lc]
  __shared__ float red[4][THREADS / 32];
  __shared__ int counts[2];

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int i0 = blockIdx.x * (PPT * THREADS) + t;
  float x[PPT], y[PPT], zf[PPT], z_cur[PPT];
  int best[PPT];
  float xlo = BIG, xhi = -BIG, ylo = BIG, yhi = -BIG;
#pragma unroll
  for (int p = 0; p < PPT; ++p) {
    const int i = i0 + p * THREADS;
    const bool in = i < n;
    x[p] = in ? px[i] : 0.0f;
    y[p] = in ? py[i] : 0.0f;
    zf[p] = in ? zfloor[i] : ZFAR_PARK;
    const bool live = zf[p] < ZFAR_PARK;
    z_cur[p] = live ? ZFAR_PARK : -ZFAR_PARK;
    best[p] = -1;
    if (live) {
      xlo = fminf(xlo, x[p]);
      xhi = fmaxf(xhi, x[p]);
      ylo = fminf(ylo, y[p]);
      yhi = fmaxf(yhi, y[p]);
    }
  }
  // the live lanes' bounding box, over the block
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    xlo = fminf(xlo, __shfl_xor_sync(0xffffffffu, xlo, o));
    xhi = fmaxf(xhi, __shfl_xor_sync(0xffffffffu, xhi, o));
    ylo = fminf(ylo, __shfl_xor_sync(0xffffffffu, ylo, o));
    yhi = fmaxf(yhi, __shfl_xor_sync(0xffffffffu, yhi, o));
  }
  if (lane == 0) {
    red[0][warp] = xlo;
    red[1][warp] = xhi;
    red[2][warp] = ylo;
    red[3][warp] = yhi;
  }
  __syncthreads();
  xlo = fminf(fminf(red[0][0], red[0][1]), fminf(red[0][2], red[0][3]));
  xhi = fmaxf(fmaxf(red[1][0], red[1][1]), fmaxf(red[1][2], red[1][3]));
  ylo = fminf(fminf(red[2][0], red[2][1]), fminf(red[2][2], red[2][3]));
  yhi = fmaxf(fmaxf(red[3][0], red[3][1]), fmaxf(red[3][2], red[3][3]));

  // (the whole block takes this branch or none of it does, and every
  // thread runs the same chunks)
  for (int c0 = 0; xlo <= xhi && c0 < n_sc; c0 += chunk) {
    const int c1 = min(n_sc, c0 + chunk);
    __syncthreads();      // the last chunk's walk is done with the list
    if (t == 0) counts[0] = counts[1] = 0;
    __syncthreads();
    // gate the chunk's superclusters, a thread each
    for (int s0 = c0; s0 < c1; s0 += THREADS) {
      const int s = s0 + t;
      const bool hit = s < c1 && box_meets(scb + s, c2p, xlo, xhi, ylo, yhi);
      push_hits(hit, s, sc_hit, &counts[0], lane);
    }
    __syncthreads();
    // gate the clusters of the gated superclusters, two superclusters
    // a pass, a thread each
    const int nh = counts[0];
    for (int q0 = 0; q0 < nh; q0 += THREADS / RK2) {
      const int q = q0 + (t >> 6), c = t & (RK2 - 1);
      bool hit = false;
      u64 key = 0;
      if (q < nh) {
        const int s = sc_hit[q];
        const float* b = clb + (size_t)s * 8 * RK2 + c;
        hit = box_meets(b, RK2, xlo, xhi, ylo, yhi);
        key = ((u64)ordered(__ldg(b + 2 * RK2)) << 32) |
              (u64)(uint32_t)(s * RK2 + c);
      }
      push_hits(hit, key, list, &counts[1], lane);
    }
    __syncthreads();
    const int nl = counts[1];
    sort_list(list, nl, t);

    // cluster `e` of the list into staging buffer `buf`
    auto stage_cluster = [&](int e, int buf) {
      const int id = (int)(uint32_t)list[e];
      const float* src = setup + (size_t)id * RK1 * SETUP_W;
      float4* dst = stage + buf * RK1 * SWEEP_Q;
      for (int q = t; q < RK1 * SWEEP_Q; q += THREADS) {
        const int row = q / SWEEP_Q, part = q - row * SWEEP_Q;
        cp_async16(dst + q, src + row * SETUP_W + part * 4);
      }
      if (t < 4)   // box rows 0, 1, 3, 4: lo x, lo y, hi x, hi y
        cp_async4(sbox + buf * 4 + t,
                  clb + (size_t)(id / RK2) * 8 * RK2 +
                      (t < 2 ? t : t + 1) * RK2 + id % RK2);
      cp_async_commit();
    };

    if (nl > 0) stage_cluster(0, 0);
    for (int e = 0; e < nl; ++e) {
      cp_async_wait_all();                 // my copies of cluster e
      const u64 key = list[e];
      const float zmin = unordered((uint32_t)(key >> 32));
      const int base = (int)(uint32_t)key * RK1;
      bool wanted = false;
#pragma unroll
      for (int p = 0; p < PPT; ++p) wanted |= zmin <= z_cur[p];
      // barrier: cluster e is staged, cluster e-1 is swept; and the
      // list is sorted, so a cluster nobody wants ends the chunk's walk
      if (!__syncthreads_or(wanted)) break;
      if (e + 1 < nl) stage_cluster(e + 1, (e + 1) & 1);
      const float* bx = sbox + (e & 1) * 4;
      const float lx = bx[0] - BOX_PAD, ly = bx[1] - BOX_PAD;
      const float hx = bx[2] + BOX_PAD, hy = bx[3] + BOX_PAD;
      unsigned mine = 0, sweep = 0;   // bit p: my pixel p, the warp's
#pragma unroll
      for (int p = 0; p < PPT; ++p) {
        const bool in = lx <= x[p] && x[p] <= hx && ly <= y[p] &&
                        y[p] <= hy && zmin <= z_cur[p];
        if (in) mine |= 1u << p;
        if (__any_sync(0xffffffffu, in)) sweep |= 1u << p;
      }
      if (!sweep) continue;
      const float4* rows = stage + (e & 1) * RK1 * SWEEP_Q;
      if (sweep == (1u << PPT) - 1u)
        sweep_rows<true>(rows, base, sweep, x, y, zf, mine, z_cur, best);
      else
        sweep_rows<false>(rows, base, sweep, x, y, zf, mine, z_cur, best);
    }
  }

#pragma unroll
  for (int p = 0; p < PPT; ++p) {
    const int i = i0 + p * THREADS;
    if (i >= n) continue;
    if (best[p] < 0) {
      z_out[i] = __int_as_float(0x7f800000);  // +inf
      slot_out[i] = -1;
      u_out[i] = 0.0f;
      v_out[i] = 0.0f;
      mat_out[i] = 0;
      continue;
    }
    // the winner's attributes, recomputed once with the sweep's arithmetic
    const float4* r = reinterpret_cast<const float4*>(
        setup + (size_t)best[p] * SETUP_W);
    const float4 q0 = __ldg(r + 0), q1 = __ldg(r + 1), q2 = __ldg(r + 2);
    const float4 q3 = __ldg(r + 3), q4 = __ldg(r + 4);
    const float b0 = (q0.x * x[p] + q0.y * y[p]) + q0.z;
    const float b1 = (q0.w * x[p] + q1.x * y[p]) + q1.y;
    const float b2 = (q1.z * x[p] + q1.w * y[p]) + q2.x;
    const float sumb = (b0 + b1) + b2;
    const float uw = (b0 * q3.x + b1 * q3.z) + b2 * q4.x;   // u0, u1, u2
    const float vw = (b0 * q3.y + b1 * q3.w) + b2 * q4.y;   // v0, v1, v2
    z_out[i] = z_cur[p];
    slot_out[i] = best[p];
    u_out[i] = uw / sumb;
    v_out[i] = vw / sumb;
    mat_out[i] = static_cast<int>(q4.z);                    // column 18
  }
}

}  // namespace vkrt

// Plain C entry point (bound with ctypes). Returns cudaGetLastError()
// after the launch; the launch does not synchronise.
extern "C" int vkrt_raster_edge(const float* setup, const float* scb, int c2p,
                                int n_sc, int chunk, const float* clb,
                                const float* px,
                                const float* py, const float* zfloor, int n,
                                float* z_out, int* slot_out, float* u_out,
                                float* v_out, int* mat_out, void* stream) {
  using namespace vkrt;
  if (n > 0) {
    if (n_sc < 0 || chunk < 1 || chunk > MAX_LIST_SC)
      return static_cast<int>(cudaErrorInvalidValue);
    const int lc = n_sc < chunk ? n_sc : chunk;
    const size_t shared = (size_t)lc * RK2 * sizeof(u64) +
                          2 * RK1 * SWEEP_Q * sizeof(float4) +
                          8 * sizeof(float) + lc * sizeof(int);
    if (shared > 48 * 1024) {
      cudaError_t err = cudaFuncSetAttribute(
          raster_edge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)shared);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    const int per_block = PPT * THREADS;
    const int blocks = (n + per_block - 1) / per_block;
    raster_edge_kernel<<<blocks, THREADS, shared,
                         static_cast<cudaStream_t>(stream)>>>(
        setup, scb, c2p, n_sc, chunk, clb, px, py, zfloor, n, z_out,
        slot_out, u_out, v_out, mat_out);
  }
  return static_cast<int>(cudaGetLastError());
}
