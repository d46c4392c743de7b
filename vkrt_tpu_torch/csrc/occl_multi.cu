// Kernel B: multi-light occlusion (any-hit) trace.
//
// Replaces the Pallas kernel vkrt_tpu/rt/occl_multi.py::_occl_multi_kernel
// (:40), entry occluded_multi (:559).
//
// What bounds it on the H100: the Möller–Trumbore sweeps up to each
// segment's first blocker, 47 float operations a (segment, triangle)
// pair, none of them an FMA (-fmad=false, as in kernel A), so at most
// half the published f32 rate. A kernel with one thread a segment,
// numbered set-major over the whole wavefront, has a warp issue the
// union of its 32 segments' sweeps (4.7x the needed pairs at config 4's
// depth 1, up to 14x at config 5's depth 3; tools/trace_work_split.py),
// and the NS lights' segments of one surface point run in unrelated
// blocks, each fetching the same cluster rows. Here, as the TPU kernel
// did, one block of 128 threads owns one 128-lane group of surface
// points and all NS segment sets (NS x 128 segments in shared memory).
// It walks the union of its segments' clusters front to back (walk.cuh),
// each entry keyed by the least entry t over every set, stages each
// cluster once for all lights, and sweeps it pair-parallel (thread k:
// triangle k against every unblocked segment whose own box tests pass).
// A segment stops at its first blocker, and the block leaves once no
// live segment is left unblocked.
//
// Semantics kept from the Pallas kernel: the division-free test against
// the sign-corrected determinant (common.cuh `occludes`): |det| > 1e-12,
// su, sv >= 0, su + sv <= |det|, st > TMIN*|det|, st < tmax*|det|.
// A parked segment (tmax = 0) is not blocked, and neither is a live one
// with 0 < tmax <= TMIN: its interval is empty (tests/test_dense.py:271).
// The answer is whether any gated cluster holds a blocker, so the visit
// order cannot change it.
//
// Two modes (walk.cuh; the TPU kernel's `sub_gate` sweep_cluster,
// occl_multi.py:157-210, and `pregate="recheck"`, :404-450): sub_gate
// sweeps only the 16-triangle sub-runs whose widened box a segment
// enters; with a candidate list (wl_cid non-null: per 128-lane group of
// surface points, the clusters that any set's interval test passes, with
// the sets' bits in wl_smask) the block walks that list in place of its
// own gates. Both give the default's masks.
//
// walk.cuh's run-time `Modes` (the TPU kernel's `visit`, :244-290 and
// :362-390, `ablate`, :297-308 and :455, and the interval pregate,
// :611-630, on the lists above with `interval` set) run in an instance
// of their own (MODES), so the default kernel is the walk without them.
// None changes a mask; a cut `ablate` blocks nothing.
#include <type_traits>

#include "walk.cuh"

namespace vkrt {

template <int NS, bool SUB, bool RECHECK, bool MODES>
__global__ void __launch_bounds__(K1, 4)
occl_multi_kernel(const float* __restrict__ sc_boxes, int c2p, int n_sc,
                  const float* __restrict__ cl_boxes,
                  const float* __restrict__ tri_data,
                  const float* __restrict__ light_pts,  // [ns, 3]
                  const float* __restrict__ dirs,       // [ns, 3, n]
                  const float* __restrict__ tmax,       // [ns, n]
                  int n, WorkLists wls, Modes modes,
                  unsigned char* __restrict__ blocked) {        // [ns, n]
  extern __shared__ __align__(16) unsigned char dyn[];
  u64* sc_list = reinterpret_cast<u64*>(dyn);                  // [n_sc]
  uint32_t* sc_key = reinterpret_cast<uint32_t*>(sc_list + n_sc);
  __shared__ WalkShared<NS, unsigned char> sh;

  const int t = threadIdx.x;
  const int i = blockIdx.x * K1 + t;               // n is a multiple of 128
#pragma unroll
  for (int s = 0; s < NS; ++s) {                   // lane j = t + 128 s
    const int j = t + s * K1;
    const float* d = dirs + (size_t)s * 3 * n;
    const float dx = d[i], dy = d[(size_t)n + i], dz = d[2 * (size_t)n + i];
    sh.org[j] = make_float4(__ldg(light_pts + 3 * s + 0),
                            __ldg(light_pts + 3 * s + 1),
                            __ldg(light_pts + 3 * s + 2),
                            tmax[(size_t)s * n + i]);
    sh.dir[j] = make_float4(dx, dy, dz, 0.0f);
    sh.inv[j] = make_float4(safe_inv(dx), safe_inv(dy), safe_inv(dz), 0.0f);
    sh.state[j] = 0;
  }

  group_walk<NS, Occl, false, SUB, RECHECK, MODES>(
      sh, sc_boxes, c2p, n_sc, cl_boxes, tri_data, sc_key, sc_list,
      wls.row(blockIdx.x), modes);
#pragma unroll
  for (int s = 0; s < NS; ++s) blocked[(size_t)s * n + i] = sh.state[t + s * K1];
}

template <int NS, bool SUB, bool RECHECK, bool MODES>
int launch(const float* sc_boxes, int c2p, int n_sc, const float* cl_boxes,
           const float* tri_data, const float* light_pts, const float* dirs,
           const float* tmax, int n, WorkLists wls, Modes modes,
           unsigned char* blocked, cudaStream_t stream) {
  const size_t dyn =
      RECHECK ? 0 : (size_t)n_sc * (sizeof(u64) + sizeof(uint32_t));
  cudaError_t err = cudaFuncSetAttribute(
      occl_multi_kernel<NS, SUB, RECHECK, MODES>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
  if (err != cudaSuccess) return static_cast<int>(err);
  occl_multi_kernel<NS, SUB, RECHECK, MODES><<<n / K1, K1, dyn, stream>>>(
      sc_boxes, c2p, n_sc, cl_boxes, tri_data, light_pts, dirs, tmax, n, wls,
      modes, blocked);
  return static_cast<int>(cudaGetLastError());
}

template <int NS>
int launch_modes(bool sub, const float* sc_boxes, int c2p, int n_sc,
                 const float* cl_boxes, const float* tri_data,
                 const float* light_pts, const float* dirs, const float* tmax,
                 int n, WorkLists wls, Modes modes, unsigned char* blocked,
                 cudaStream_t st) {
  auto go = [&](auto s, auto r, auto w) {
    return launch<NS, decltype(s)::value, decltype(r)::value,
                  decltype(w)::value>(sc_boxes, c2p, n_sc, cl_boxes,
                                      tri_data, light_pts, dirs, tmax, n,
                                      wls, modes, blocked, st);
  };
  using T = std::true_type;
  using F = std::false_type;
  auto by_lists = [&](auto s, auto w) {
    return wls.cid ? go(s, T{}, w) : go(s, F{}, w);
  };
  auto by_sub = [&](auto w) {
    return sub ? by_lists(T{}, w) : by_lists(F{}, w);
  };
  const bool any_mode =
      modes.ablate != ABL_NONE || modes.visit != VISIT_NEAR || modes.interval;
  return any_mode ? by_sub(T{}) : by_sub(F{});
}

}  // namespace vkrt

// Plain C entry point (bound with ctypes). Returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue for ns outside 1..4, a ray
// count that is not a multiple of 128 or a tree whose supercluster keys
// do not fit in shared memory; the launch does not synchronise.
// sub_gate and a non-null wl_cid select the modes (see above); ablate,
// visit and interval (with lists) the run-time ones.
extern "C" int vkrt_occl_multi(const float* sc_boxes, int c2p, int n_sc,
                               const float* cl_boxes, const float* tri_data,
                               const float* light_pts, const float* dirs,
                               const float* tmax, int ns, int n, int sub_gate,
                               const int* wl_cid, const float* wl_tlb,
                               const int* wl_smask, const int* wl_count,
                               int wl_stride, int ablate, int visit,
                               int interval, unsigned char* blocked,
                               void* stream) {
  using namespace vkrt;
  if (n == 0) return static_cast<int>(cudaGetLastError());
  if (n % K1 != 0 || n_sc < 0) return static_cast<int>(cudaErrorInvalidValue);
  const WorkLists wls{wl_cid, wl_tlb, wl_smask, wl_count, wl_stride};
  const Modes modes{ablate, visit, interval, nullptr, nullptr, 0, 0, nullptr};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool sub = sub_gate != 0;
  switch (ns) {
    case 1: return launch_modes<1>(sub, sc_boxes, c2p, n_sc, cl_boxes,
                                   tri_data, light_pts, dirs, tmax, n, wls,
                                   modes, blocked, st);
    case 2: return launch_modes<2>(sub, sc_boxes, c2p, n_sc, cl_boxes,
                                   tri_data, light_pts, dirs, tmax, n, wls,
                                   modes, blocked, st);
    case 3: return launch_modes<3>(sub, sc_boxes, c2p, n_sc, cl_boxes,
                                   tri_data, light_pts, dirs, tmax, n, wls,
                                   modes, blocked, st);
    case 4: return launch_modes<4>(sub, sc_boxes, c2p, n_sc, cl_boxes,
                                   tri_data, light_pts, dirs, tmax, n, wls,
                                   modes, blocked, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
