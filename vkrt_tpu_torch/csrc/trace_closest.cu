// Kernel A: closest-hit trace with the 36-attribute select.
//
// Replaces the Pallas kernel vkrt_tpu/rt/dense.py::_trace_kernel (:238)
// in its closest-hit mode, with and without the attribute select and
// point_origin (:257-265), entry trace_dense (:802).
//
// What bounds it on the H100: the Möller–Trumbore sweeps, 46 float
// operations a (ray, triangle) pair, none of them an FMA (-fmad=false:
// the plain version rounds every product and sum, and the two agree bit
// for bit), so the card issues them at most at half its published f32
// rate; the bytes are small beside them. One thread a ray loses 2-29x on
// top of that (tools/trace_work_split.py): a warp issues the union of
// its 32 rays' cluster sweeps (reflection rays scatter: 6.7x the needed
// pairs at depth 1, up to 29x at config 5's depth 3), and every (thread,
// triangle) pair reads 9 scalars of a 512-byte row through the cache.
// Walking clusters in ascending id costs at most 1.5x. This kernel walks
// each 128-lane group front to back in shared memory (walk.cuh): the
// clusters by the least entry t of any lane, a block-wide stop at the
// first cluster that no lane can still need, every cluster's rows staged
// once by cp.async while the previous one is swept, and a pair-parallel
// sweep (thread k: triangle k against every lane whose own box tests
// pass at its own t_cur), which issues the pairs the lanes need and no
// others.
//
// Semantics kept from the Pallas kernel:
//   a hit needs |det| > 1e-12, u, v >= 0, u + v <= 1, TMIN < t < tmax,
//   with exact IEEE division (no approximate reciprocal); it commits
//   where t < the committed t, or t equals it and its slot is lower
//   (`hit_key`: the tie rule is explicit because clusters are visited by
//   entry t, not by id); a lane sweeps a cluster only where its slab
//   tests pass at its committed t, which keeps a box whose entry t equals
//   it; so the answer is the nearest hit of the gated clusters, ties to
//   the lowest slot, as trace_dense_plain's; u, v are those of the
//   winner, recomputed with the same arithmetic;
//   miss: t = inf, slot = -1, u = v = 0, attrs = 0.
// With `block` > 0 the rays of one block share an origin: ray i starts at
// o_pts[i / block] (the TPU kernel's point_origin operands); the
// arithmetic is the same, so the result equals the broadcast origins'.
// A null attr_out skips the attribute select (with_attributes=False).
//
// Two modes (walk.cuh; the TPU kernel's `sub_gate` sweep, dense.py
// :438-494, and `pregate="recheck"`, :674-727): sub_gate sweeps only the
// 16-triangle sub-runs whose widened box a lane's ray enters before its
// t_cur; with a candidate list (wl_cid non-null: per 128-ray group,
// `wl_stride` entries a row, wl_count[g] of them used; wl_smask null, as
// kernel A has one set) the block walks
// that list in place of its own supercluster and cluster gates. Both
// give the default's outputs bit for bit.
//
// The modes of walk.cuh's `Modes` (the TPU kernel's `stats`, :247 and
// :636-637, `ablate`, :573-588, and the interval pregate, :589-623, on
// the lists above with `interval` set) run in an instance of their own
// (MODES), so the default kernel is the walk without them. A cut
// `ablate` commits nothing: every ray misses.
#include <type_traits>

#include "walk.cuh"

namespace vkrt {

// A committed hit as one 64-bit key: t's bits (t > 0, so they order as
// the floats do) above the slot. The least key is the nearest hit, and
// among hits of equal t the lowest slot: a shared atomicMin commits by
// the tie rule whatever order the pairs arrive in. A lane starts at
// (tmax, NO_KEY), and a hit must also have t < tmax.
__device__ __forceinline__ u64 hit_key(float t, uint32_t slot) {
  return ((u64)__float_as_uint(t) << 32) | slot;
}

struct Closest {
  typedef u64 State;

  static __device__ __forceinline__ float far(
      const WalkShared<1, u64>& sh, int j) {
    return __uint_as_float((uint32_t)(sh.state[j] >> 32));
  }

  static __device__ __forceinline__ void pair(WalkShared<1, u64>& sh, int j,
                                              float4 q0, float4 q1,
                                              float4 q2, int slot) {
    const float4 o = sh.org[j], d = sh.dir[j];
    Ray r;
    r.ox = o.x;
    r.oy = o.y;
    r.oz = o.z;
    r.dx = d.x;
    r.dy = d.y;
    r.dz = d.z;
    const MT m = mt_values(r, q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z,
                           q1.w, q2.x);
    if (!(fabsf(m.det) > DET_EPS)) return;
    const float inv_det = 1.0f / m.det;
    const float uu = m.up * inv_det;
    const float vv = m.vp * inv_det;
    const float tt = m.tp * inv_det;
    if (uu >= 0.0f && vv >= 0.0f && uu + vv <= 1.0f && tt > TMIN &&
        tt < o.w) {
      const u64 key = hit_key(tt, (uint32_t)slot);
      if (key < sh.state[j]) atomicMin(&sh.state[j], key);
    }
  }
};

template <bool SUB, bool RECHECK, bool MODES>
__global__ void __launch_bounds__(K1, 8)
trace_closest_kernel(const float* __restrict__ sc_boxes, int c2p, int n_sc,
                     const float* __restrict__ cl_boxes,
                     const float* __restrict__ tri_data,
                     const float* __restrict__ orig,   // [3, n] or [n/block, 3]
                     int block,                        // 0: per-ray origins
                     const float* __restrict__ dirs,   // [3, n]
                     const float* __restrict__ tmax,   // [n]
                     int n, WorkLists wls, Modes modes,
                     float* __restrict__ t_out,
                     int* __restrict__ slot_out,
                     float* __restrict__ u_out, float* __restrict__ v_out,
                     float* __restrict__ attr_out) {   // [36, n]
  extern __shared__ __align__(16) unsigned char dyn[];
  u64* sc_list = reinterpret_cast<u64*>(dyn);                  // [n_sc]
  uint32_t* sc_key = reinterpret_cast<uint32_t*>(sc_list + n_sc);
  __shared__ WalkShared<1, u64> sh;

  const int t = threadIdx.x;
  const int i = blockIdx.x * K1 + t;               // n is a multiple of 128
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
  const float tm = tmax[i];
  sh.org[t] = make_float4(r.ox, r.oy, r.oz, tm);
  sh.dir[t] = make_float4(r.dx, r.dy, r.dz, 0.0f);
  sh.inv[t] = make_float4(r.ix, r.iy, r.iz, 0.0f);
  sh.state[t] = hit_key(tm, NO_KEY);

  group_walk<1, Closest, false, SUB, RECHECK, MODES>(
      sh, sc_boxes, c2p, n_sc, cl_boxes, tri_data, sc_key, sc_list,
      wls.row(blockIdx.x), modes);

  const u64 key = sh.state[t];
  const int best = (uint32_t)key == NO_KEY ? -1 : (int)(uint32_t)key;
  slot_out[i] = best;
  if (best < 0) {
    t_out[i] = __int_as_float(0x7f800000);                   // +inf
    u_out[i] = v_out[i] = 0.0f;
  } else {
    // the winner's u, v, recomputed once with the sweep's arithmetic
    const MT m = mt_terms(r, tri_data + (size_t)best * ROWS);
    const float inv_det = 1.0f / m.det;
    t_out[i] = __uint_as_float((uint32_t)(key >> 32));
    u_out[i] = m.up * inv_det;
    v_out[i] = m.vp * inv_det;
  }
  if (attr_out == nullptr) return;
  const float* row = tri_data + (size_t)(best >= 0 ? best : 0) * ROWS;
  for (int a = 0; a < N_ATTR; ++a)
    attr_out[(size_t)a * n + i] = best >= 0 ? __ldg(row + a) : 0.0f;
}

template <bool SUB, bool RECHECK, bool MODES>
static int launch(const float* sc_boxes, int c2p, int n_sc,
                  const float* cl_boxes, const float* tri_data,
                  const float* orig, int block, const float* dirs,
                  const float* tmax, int n, WorkLists wls, Modes modes,
                  float* t_out, int* slot_out, float* u_out, float* v_out,
                  float* attr_out, cudaStream_t stream) {
  const size_t dyn =
      RECHECK ? 0 : (size_t)n_sc * (sizeof(u64) + sizeof(uint32_t));
  cudaError_t err = cudaFuncSetAttribute(
      trace_closest_kernel<SUB, RECHECK, MODES>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
  if (err != cudaSuccess) return static_cast<int>(err);
  trace_closest_kernel<SUB, RECHECK, MODES><<<n / K1, K1, dyn, stream>>>(
      sc_boxes, c2p, n_sc, cl_boxes, tri_data, orig, block, dirs, tmax, n,
      wls, modes, t_out, slot_out, u_out, v_out, attr_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace vkrt

// Plain C entry point (bound with ctypes). Returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue for a ray count that is not
// a multiple of 128 (the wrapper's lanes), a stats block that is not a
// whole number of groups or a tree whose supercluster keys do not fit in
// shared memory; the launch does not synchronise. sub_gate and a non-null
// wl_cid select the modes (see above); ablate, interval (with lists) and
// a non-null stats (i32[n / (128 stat_groups), 2], zeroed; stat_mask
// u32[same, mask_words], zeroed; stat_btmax f32[same]) the run-time ones.
extern "C" int vkrt_trace_closest(const float* sc_boxes, int c2p, int n_sc,
                                  const float* cl_boxes, const float* tri_data,
                                  const float* orig, int block,
                                  const float* dirs, const float* tmax,
                                  int n, int sub_gate, const int* wl_cid,
                                  const float* wl_tlb, const int* wl_smask,
                                  const int* wl_count, int wl_stride,
                                  int ablate, int interval, int* stats,
                                  unsigned* stat_mask, int mask_words,
                                  int stat_groups, const float* stat_btmax,
                                  float* t_out,
                                  int* slot_out, float* u_out, float* v_out,
                                  float* attr_out, void* stream) {
  using namespace vkrt;
  if (n == 0) return static_cast<int>(cudaGetLastError());
  if (n % K1 != 0 || n_sc < 0 || (stats && stat_groups <= 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const WorkLists wls{wl_cid, wl_tlb, wl_smask, wl_count, wl_stride};
  const Modes modes{ablate,    VISIT_NEAR, interval,    stats,
                    stat_mask, mask_words, stat_groups, stat_btmax};
  const bool any_mode = ablate != ABL_NONE || interval || stats;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto go = [&](auto sub, auto recheck, auto with_modes) {
    return launch<decltype(sub)::value, decltype(recheck)::value,
                  decltype(with_modes)::value>(
        sc_boxes, c2p, n_sc, cl_boxes, tri_data, orig, block, dirs, tmax, n,
        wls, modes, t_out, slot_out, u_out, v_out, attr_out, st);
  };
  using T = std::true_type;
  using F = std::false_type;
  auto by_lists = [&](auto sub, auto with_modes) {
    return wl_cid ? go(sub, T{}, with_modes) : go(sub, F{}, with_modes);
  };
  auto by_sub = [&](auto with_modes) {
    return sub_gate ? by_lists(T{}, with_modes) : by_lists(F{}, with_modes);
  };
  return any_mode ? by_sub(T{}) : by_sub(F{});
}
