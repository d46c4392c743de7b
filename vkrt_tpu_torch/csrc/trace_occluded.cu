// Kernel A': any-hit (occlusion) trace with per-ray or per-block origins.
//
// Replaces the Pallas kernel vkrt_tpu/rt/dense.py::_trace_kernel (:238)
// in its occlusion mode (the any-hit branch, :367-384) with and without
// point_origin (:257-265), entry trace_dense (:802).
//
// What bounds it on the H100: the Möller–Trumbore sweeps up to each
// ray's first blocker, 47 float operations a (ray, triangle) pair, none
// of them an FMA (-fmad=false), as in kernel B. One thread a ray would
// have a warp issue the union of its 32 rays' sweeps (1.5-14x the needed
// pairs, tools/trace_work_split.py) with 9 scalar loads a pair. So A' is
// kernel B's body with one segment set: one block of 128 threads owns
// one 128-lane group and walks it front to back (walk.cuh `group_walk`
// with the `Occl` policy), each cluster staged once by cp.async and
// swept pair-parallel. A lane stops at its first blocker, and the block
// leaves once no live lane is left unblocked. With `block` > 0 ray i
// starts at o_pts[i / block], else at orig[:, i]. `block` is a multiple
// of 128, so a group never spans two origins: the point-origin kernel
// (ONE_ORIGIN) keys each box against the group's origin with one
// `lo - o` a box, not a lane (the same floats, so the same keys; timed
// against the per-lane form with tools/port_kernel_timing.py, PERF.md).
// Per-ray origins differ inside a group, and there every gate uses the
// lane's own.
//
// Semantics kept from the Pallas kernel: the division-free test against
// the sign-corrected determinant, kernel B's own (common.cuh `occludes`),
// so the two kernels decide every segment alike: |det| > 1e-12, su, sv
// >= 0, su + sv <= |det|, st > TMIN*|det|, st < tmax*|det|. A parked ray
// (tmax = 0) is not blocked, and neither is a live one with 0 < tmax <=
// TMIN (its interval is empty). Outputs as the Pallas kernel leaves
// them: blocked → slot 1, t = TMIN; free → slot -1, t = +inf; u = v = 0.
//
// Modes, as kernel B's at one segment set (walk.cuh): sub_gate (SUB),
// candidate lists (RECHECK: per 128-ray group, wl_smask null; the lists
// of kernel A's re-check, rt/dense.py::closest_worklists) re-tested per
// lane or, with `interval`, trusted; and walk.cuh's run-time `Modes`
// (stats, ablate) in an instance of their own (MODES). The TPU kernel
// reaches them through trace_dense(occlusion=True, ...) (dense.py:802).
// None changes a mask; a cut `ablate` blocks nothing.
#include <type_traits>

#include "walk.cuh"

namespace vkrt {

template <bool ONE_ORIGIN, bool SUB, bool RECHECK, bool MODES>
__global__ void __launch_bounds__(K1, 4)
trace_occluded_kernel(const float* __restrict__ sc_boxes, int c2p, int n_sc,
                      const float* __restrict__ cl_boxes,
                      const float* __restrict__ tri_data,
                      const float* __restrict__ orig,   // [3, n] or [n/block, 3]
                      int block,                        // 0: per-ray origins
                      const float* __restrict__ dirs,   // [3, n]
                      const float* __restrict__ tmax,   // [n]
                      int n, WorkLists wls, Modes modes,
                      float* __restrict__ t_out, int* __restrict__ slot_out,
                      float* __restrict__ u_out, float* __restrict__ v_out) {
  extern __shared__ __align__(16) unsigned char dyn[];
  u64* sc_list = reinterpret_cast<u64*>(dyn);                  // [n_sc]
  uint32_t* sc_key = reinterpret_cast<uint32_t*>(sc_list + n_sc);
  __shared__ WalkShared<1, unsigned char> sh;

  const int t = threadIdx.x;
  const int i = blockIdx.x * K1 + t;               // n is a multiple of 128
  float ox, oy, oz;
  if (block > 0) {
    const float* p = orig + (size_t)(i / block) * 3;
    ox = __ldg(p + 0);
    oy = __ldg(p + 1);
    oz = __ldg(p + 2);
  } else {
    ox = orig[i];
    oy = orig[(size_t)n + i];
    oz = orig[2 * (size_t)n + i];
  }
  const float dx = dirs[i], dy = dirs[(size_t)n + i], dz = dirs[2 * (size_t)n + i];
  sh.org[t] = make_float4(ox, oy, oz, tmax[i]);
  sh.dir[t] = make_float4(dx, dy, dz, 0.0f);
  sh.inv[t] = make_float4(safe_inv(dx), safe_inv(dy), safe_inv(dz), 0.0f);
  sh.state[t] = 0;

  group_walk<1, Occl, ONE_ORIGIN, SUB, RECHECK, MODES>(
      sh, sc_boxes, c2p, n_sc, cl_boxes, tri_data, sc_key, sc_list,
      wls.row(blockIdx.x), modes);
  // (an all-parked group returns from the walk at once: written here too)
  const bool hit = sh.state[t];
  t_out[i] = hit ? TMIN : __int_as_float(0x7f800000);  // +inf
  slot_out[i] = hit ? 1 : -1;
  u_out[i] = 0.0f;
  v_out[i] = 0.0f;
}

template <bool ONE_ORIGIN, bool SUB, bool RECHECK, bool MODES>
static int launch(const float* sc_boxes, int c2p, int n_sc,
                  const float* cl_boxes, const float* tri_data,
                  const float* orig, int block, const float* dirs,
                  const float* tmax, int n, WorkLists wls, Modes modes,
                  float* t_out, int* slot_out, float* u_out, float* v_out,
                  cudaStream_t stream) {
  auto kern = trace_occluded_kernel<ONE_ORIGIN, SUB, RECHECK, MODES>;
  const size_t dyn =
      RECHECK ? 0 : (size_t)n_sc * (sizeof(u64) + sizeof(uint32_t));
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<n / K1, K1, dyn, stream>>>(sc_boxes, c2p, n_sc, cl_boxes, tri_data,
                                    orig, block, dirs, tmax, n, wls, modes,
                                    t_out, slot_out, u_out, v_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace vkrt

// Plain C entry point (bound with ctypes). Returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue for a ray count that is not
// a multiple of 128, a stats block that is not a whole number of groups
// or a tree whose supercluster keys do not fit in shared memory; the
// launch does not synchronise. The mode arguments are kernel A's
// (trace_closest.cu's entry point).
extern "C" int vkrt_trace_occluded(const float* sc_boxes, int c2p, int n_sc,
                                   const float* cl_boxes,
                                   const float* tri_data, const float* orig,
                                   int block, const float* dirs,
                                   const float* tmax, int n, int sub_gate,
                                   const int* wl_cid, const float* wl_tlb,
                                   const int* wl_count, int wl_stride,
                                   int ablate, int interval, int* stats,
                                   unsigned* stat_mask, int mask_words,
                                   int stat_groups, const float* stat_btmax,
                                   float* t_out, int* slot_out, float* u_out,
                                   float* v_out, void* stream) {
  using namespace vkrt;
  if (n == 0) return static_cast<int>(cudaGetLastError());
  if (n % K1 != 0 || n_sc < 0 || (stats && stat_groups <= 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const WorkLists wls{wl_cid, wl_tlb, nullptr, wl_count, wl_stride};
  const Modes modes{ablate,    VISIT_NEAR, interval,    stats,
                    stat_mask, mask_words, stat_groups, stat_btmax};
  const bool any_mode = ablate != ABL_NONE || interval || stats;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto go = [&](auto one, auto sub, auto recheck, auto with_modes) {
    return launch<decltype(one)::value, decltype(sub)::value,
                  decltype(recheck)::value, decltype(with_modes)::value>(
        sc_boxes, c2p, n_sc, cl_boxes, tri_data, orig, block, dirs, tmax, n,
        wls, modes, t_out, slot_out, u_out, v_out, st);
  };
  using T = std::true_type;
  using F = std::false_type;
  auto by_modes = [&](auto one, auto sub, auto recheck) {
    return any_mode ? go(one, sub, recheck, T{}) : go(one, sub, recheck, F{});
  };
  auto by_lists = [&](auto one, auto sub) {
    return wl_cid ? by_modes(one, sub, T{}) : by_modes(one, sub, F{});
  };
  auto by_sub = [&](auto one) {
    return sub_gate ? by_lists(one, T{}) : by_lists(one, F{});
  };
  return block > 0 ? by_sub(T{}) : by_sub(F{});
}
