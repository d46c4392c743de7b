// The front-to-back group walk of kernels A (trace_closest.cu), A'
// (trace_occluded.cu) and B (occl_multi.cu). One block of 128 threads
// owns one 128-lane group (an 8x16-pixel subtile in the engine's tile
// order) and, for B, that group's segments toward each of NS lights:
// NL = 128 x NS lanes, whose rays and results live in shared memory
// (A and A' walk with NS = 1).
//
//   1. Every supercluster gets a key: the least entry t of its box over
//      the block's live lanes whose slab test passes at their far bound
//      (A: tmax; A', B: the segment's end). A thread per (supercluster, 32
//      live lanes), a shared atomicMin; the gated keys are sorted (rank
//      sort: keys are unique, the id sits in their low bits).
//   2. The superclusters are visited in that order. Each lane tests the
//      box against its own current far bound (A: the t of its nearest
//      hit so far); the lanes that pass are compacted into a list, and
//      the block gates the 64 clusters for them the same way, a thread
//      per (cluster, half of that list), into a sorted list of at most 64
//      keys.
//   3. The list is walked in order. Cluster q+1's rows (cols 0-11, 48 of
//      a row's 512 bytes) arrive by cp.async while q is swept. Before
//      each cluster the block asks whether any lane's far bound is still
//      >= the entry's key: a lane's entry t into a box is at least the
//      key, and keys only grow along a list, so the first "no" ends the
//      list for every lane (at the supercluster level, the walk).
//      Equality is kept: a box whose entry t equals a lane's far bound
//      may hold a hit at that t with a lower slot.
//   4. The lanes whose own tests of the supercluster's and the cluster's
//      box pass at their own far bound (those that the one-thread-a-ray
//      kernels would have swept it for) are compacted into a list, and
//      the sweep is pair-parallel: thread k takes staged triangle k and
//      runs it against every listed lane in turn (the ray a broadcast
//      from shared memory), so a warp never idles on lanes that do not
//      need the cluster. A hit is committed through shared memory
//      (`P::pair`).
//
// Two modes of kernels A and B (template flags, off by default; the
// JAX kernels' `sub_gate` and `pregate="recheck"`). Neither changes an
// output bit: both only skip work that cannot commit.
//
//   SUB      step 4 with the cluster's 8 sub-run boxes (tri_data rows 0-7,
//            cols 40-45: 16 triangles each), staged with the rows. Each
//            listed lane tests them at its own far bound, the boxes widened
//            by SUB_MARGIN (so that rounding cannot drop a hit on a box
//            face); thread k sweeps only the lanes whose bit k/16 is set.
//            Inverted boxes (empty sub-runs: zeroed rows) are skipped.
//   RECHECK  steps 1-2 replaced by a candidate list made before the launch
//            (rt/dense.py::closest_worklists, rt/occl_multi.py::
//            multi_worklists): per 128-lane group, the clusters whose
//            interval slab test (all the group's rays at once) passes,
//            sorted by that test's entry lower bound `tlb`, with B's set
//            bits. The block reads it from global memory in chunks of 64:
//            it stops where no lane's far bound reaches the chunk's first
//            `tlb`; else each lane re-tests the chunk's cluster boxes at
//            its own far bound, which gives exact keys, and the chunk is
//            walked as step 3 walks a supercluster's list. A lane sweeps
//            a cluster where its own test of the cluster's box passes,
//            which implies the supercluster's (the boxes nest and the
//            rounding of the slab test is monotone): the pairs of the
//            default walk.
//
// The modes the JAX kernels reach only from tools/ and kernel tests
// (`Modes`, run-time values; a kernel instantiated with MODES = false
// compiles them out, so the default walk is the code above). None changes
// an output bit, except that an `ablate` cut commits nothing.
//
//   interval  RECHECK's lists trusted as the JAX kernel's interval pregate
//            trusts its own (dense.py:589-623): no lane re-tests a listed
//            cluster's box; every lane whose far bound is at least the
//            entry's `tlb` sweeps it (the list is a superset of the pairs
//            each lane's own gate passes, and the triangle test decides).
//   visit    (B) the order of the lists: NEAR (the default, least entry t
//            first), MID (least |entry t - half the set's largest far
//            bound in the group| first; occl_multi.py:244-290 keys each
//            cluster so) or FAR (greatest least-entry first), at both the
//            supercluster and the cluster level. Neither order ascends by
//            entry t, so step 3's "the first no ends the list" becomes a
//            skip of that entry: every entry is visited, and a lane
//            sweeps it where its own test passes.
//   stats    (A, A') per dispatch block of `stat_groups` groups: lane 0,
//            the JAX work-list length (the clusters of every supercluster
//            that some live ray passes at its tmax whose box some live ray
//            passes at its tmax with entry t < the block's largest tmax,
//            and the padding clusters of those superclusters, whose
//            inverted boxes the JAX slab test passes), one bit a cluster
//            in `stat_mask` for the wrapper to count; lane 1, the
//            (group, cluster) sweeps run (a cluster that some lane needs,
//            step 4 reached), summed over the block's groups.
//   ablate   the JAX cut points (dense.py:573-588, phase timing), mapped
//            onto the steps above:
//              onlysc        step 1 only (keys and the supercluster order);
//              noemit        steps 1-2's box tests (each lane's
//                            supercluster test and the cluster keys),
//                            no cluster list built;
//              nodma_nosort  the cluster lists built in id order, no
//                            staging, no sweep;
//              nodma         the same, sorted by key;
//              nosweep       everything but the Möller–Trumbore pass (the
//                            cp.async staging and the sub-run masks kept);
//              nosort        the full walk, each cluster list in id order
//                            (a skip where step 3 would end the list).
//            Under RECHECK there is no step 1-2 to cut (the JAX kernel's
//            pregate skips its prepass): onlysc and noemit walk in full,
//            the others cut the candidate chunks at the same points.
//
// Shared memory: WalkShared (static, 23,712 bytes for A, 22,816 for A'
// and B at NS 1, 44,336 for B at NS 4, by ptxas) and 12 bytes a
// supercluster (dynamic: the keys and the sorted list; none under
// RECHECK).
#pragma once

#include "common.cuh"

namespace vkrt {

constexpr uint32_t NO_KEY = 0xffffffffu;
constexpr int STAGE_Q = 3;               // float4 a staged row (cols 0-11)
constexpr int SUBRUNS = 8;               // sub-run boxes a cluster
constexpr int SUB_COL = 40;              // their columns 40-45 (of 40-47)
constexpr int SUB_Q = 2;                 // float4 a staged sub-run box
constexpr float SUB_MARGIN_ABS = 1e-3f;  // sub-box widening: abs + rel x
constexpr float SUB_MARGIN_REL = 1e-4f;  // the corner's magnitude

enum : int {                             // Modes::ablate
  ABL_NONE = 0, ABL_ONLYSC, ABL_NOEMIT, ABL_NODMA_NOSORT, ABL_NODMA,
  ABL_NOSWEEP, ABL_NOSORT
};
enum : int { VISIT_NEAR = 0, VISIT_MID, VISIT_FAR };   // Modes::visit

// The run-time modes of the header (all zero: the default walk).
struct Modes {
  int ablate;
  int visit;
  int interval;
  int* stats;                  // i32[dispatch blocks, 2]: lane 1 added here
  unsigned* stat_mask;         // u32[dispatch blocks, mask_words]: lane 0
  int mask_words;
  int stat_groups;             // 128-lane groups a dispatch block
  const float* stat_btmax;     // f32[dispatch blocks]: the largest tmax
};

// The block's candidate list (RECHECK): cluster ids, entry lower bounds
// (ascending) and, for B, set bits; `count` entries.
struct WorkList {
  const int* cid;
  const float* tlb;
  const int* smask;                      // null: every set
  int count;
};

// Every group's list: rows of `stride` entries, count[g] of row g used
// (cid null: no lists, the default walk).
struct WorkLists {
  const int* cid;
  const float* tlb;
  const int* smask;
  const int* count;
  int stride;

  __device__ __forceinline__ WorkList row(int g) const {
    if (cid == nullptr) return WorkList{nullptr, nullptr, nullptr, 0};
    const size_t o = (size_t)g * stride;
    return WorkList{cid + o, tlb + o, smask ? smask + o : nullptr,
                    __ldg(count + g)};
  }
};

template <int NS, class State>
struct WalkShared {
  static constexpr int NL = NS * K1;
  float4 stage[2][K1 * STAGE_Q];         // two clusters' rows
  float4 org[NL];                        // ox oy oz, tmax
  float4 dir[NL];                        // dx dy dz, -
  float4 inv[NL];                        // ix iy iz, far bound of the gates
  float4 sub[2][SUBRUNS * SUB_Q];        // SUB: two clusters' sub-run boxes
  State state[NL];                       // A: (t, slot) key; A', B: blocked
  short live[NL];                        // lanes with tmax > TMIN
  short need[NL];                        // lanes that need the cluster
  short pass[NL];                        // lanes that pass the supercluster
  unsigned char sub_mask[NL];            // SUB: need[p]'s sub-run bits
  float box[6][K2];                      // the supercluster's cluster boxes
  int ch_cid[K2];                        // RECHECK: the chunk's cluster ids
  int ch_smask[K2];                      // ... and set bits
  uint32_t cl_key[K2];
  u64 cl_list[K2];                       // sorted cluster keys
  int far_max[NS];                       // visit MID: a set's largest far
  int n_live, n_gated, n_pass, n_need[2];
  int n_swept;                           // stats: lane 1 of this group
};

// Sub-run box test (SUB): the box (lo, hi as 6 floats) widened by
// SUB_MARGIN_ABS + SUB_MARGIN_REL x max(|lo|, |hi|) on each axis, then
// the slab test at far bound t_s; an inverted box (lo.x > hi.x) fails.
__device__ __forceinline__ bool sub_pass(const float* b, float ox, float oy,
                                         float oz, float ix, float iy,
                                         float iz, float t_s) {
  if (!(b[0] <= b[3])) return false;
  float w[6];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float m = SUB_MARGIN_ABS +
                    SUB_MARGIN_REL * fmaxf(fabsf(b[a]), fabsf(b[a + 3]));
    w[a] = b[a] - m;
    w[a + 3] = b[a + 3] + m;
  }
  float tn;
  return slab(ox, oy, oz, ix, iy, iz, w[0], w[1], w[2], w[3], w[4], w[5],
              t_s, tn);
}

// The least entry t, as an ordered key (NO_KEY if none), over the lanes
// list[begin, end) whose slab test of the box passes at their gate bound
// (inv.w; 0 for a lane that wants nothing). ONE_ORIGIN: every lane
// starts at lane 0's origin, so the box's corners relative to it are
// taken once (bit for bit the values each lane's own test computes).
// `mid` (visit MID): the key of a lane is |entry t - half of its set's
// largest far bound| (mid[set], the float's bits) in place of its entry t.
template <bool ONE_ORIGIN, int NS, class State>
__device__ __forceinline__ uint32_t least_entry(
    const WalkShared<NS, State>& sh, const short* list, int begin, int end,
    float lx, float ly, float lz, float hx, float hy, float hz,
    const int* mid = nullptr) {
  uint32_t best = NO_KEY;
  if (ONE_ORIGIN) {
    const float4 o = sh.org[0];
    const float ax = lx - o.x, ay = ly - o.y, az = lz - o.z;
    const float bx = hx - o.x, by = hy - o.y, bz = hz - o.z;
    for (int q = begin; q < end; ++q) {
      const float4 v = sh.inv[list[q]];
      float tn;
      if (slab_rel(ax, ay, az, bx, by, bz, v.x, v.y, v.z, v.w, tn))
        best = min(best, ordered(tn));
    }
    return best;
  }
  for (int q = begin; q < end; ++q) {
    const int j = list[q];
    const float4 o = sh.org[j], v = sh.inv[j];
    float tn;
    if (slab(o.x, o.y, o.z, v.x, v.y, v.z, lx, ly, lz, hx, hy, hz, v.w,
             tn)) {
      if (mid) tn = fabsf(tn - 0.5f * __int_as_float(mid[j / K1]));
      best = min(best, ordered(tn));
    }
  }
  return best;
}

// The rank key of a list entry from its least key (NO_KEY: not gated):
// ascending least key (sorted), descending (visit FAR) or none, so that
// the ids (list order) decide. Only the rank uses it: the list keeps the
// least key itself, which steps 3-4 read as the entry's bound.
__device__ __forceinline__ uint32_t sort_key(uint32_t k, bool far,
                                             bool unsorted) {
  if (k == NO_KEY) return NO_KEY;
  return unsorted ? 0u : far ? ~k : k;
}

// The key of a list entry: its least key above, its id below.
__device__ __forceinline__ u64 list_key(uint32_t key, int id) {
  return ((u64)key << 32) | (uint32_t)id;
}

// Steps 3-4 over the list sh.cl_list[0, ncl): entry keys hold the least
// key above and, below, the cluster id (default: its box is
// sh.box[.][id & 63]) or, under RECHECK, its chunk position (id in
// sh.ch_cid, box in sh.box). `sorted`: the rank keys are the least entry
// t (ascending), so the first entry that no lane wants ends the list;
// otherwise that entry is skipped. Ends with a barrier.
template <int NS, class P, bool SUB, bool RECHECK, bool MODES>
__device__ __forceinline__ void walk_list(
    WalkShared<NS, typename P::State>& sh, int ncl,
    const float* __restrict__ tri_data, const Modes& m, bool sorted) {
  const int t = threadIdx.x, lane = t & 31;
  const bool interval = MODES && RECHECK && m.interval;
  const bool sweep = !MODES || m.ablate != ABL_NOSWEEP;
  const bool stats = MODES && m.stats != nullptr;
  auto cluster = [&](int q, int& c) {
    const int low = (int)(uint32_t)sh.cl_list[q];
    c = RECHECK ? low : (low & (K2 - 1));
    return RECHECK ? sh.ch_cid[low] : low;
  };
  auto stage = [&](int q, int buf) {
    int c;
    const float* src = tri_data + (size_t)cluster(q, c) * K1 * ROWS;
    float4* dst = sh.stage[buf];
    for (int i = t; i < K1 * STAGE_Q; i += K1) {
      const int row = i / STAGE_Q, part = i - row * STAGE_Q;
      cp_async16(dst + i, src + (size_t)row * ROWS + part * 4);
    }
    if (SUB && t < SUBRUNS * SUB_Q)
      cp_async16(&sh.sub[buf][t], src + (size_t)(t / SUB_Q) * ROWS +
                                      SUB_COL + (t % SUB_Q) * 4);
    cp_async_commit();
  };

  if (ncl > 0) stage(0, 0);
  for (int q = 0; q < ncl; ++q) {
    cp_async_wait_all();                 // my copies of cluster q
    __syncthreads();                     // cluster q staged, q-1 swept
    const u64 ckey = sh.cl_list[q];
    const float centry = unordered((uint32_t)(ckey >> 32));
    int c;
    const int cid = cluster(q, c);
    const int sets = (RECHECK && NS > 1) ? sh.ch_smask[c] : ~0;
    bool wanted = false;
#pragma unroll
    for (int k = 0; k < NS; ++k) {
      const int j = t + k * K1;
      const float far = P::far(sh, j);
      const float4 o = sh.org[j], v = sh.inv[j];
      float tn;
      const bool reach = far > TMIN && centry <= far;
      const bool need =
          ((sets >> k) & 1) && v.w > 0.0f &&
          (interval ? reach
                    : slab(o.x, o.y, o.z, v.x, v.y, v.z, sh.box[0][c],
                           sh.box[1][c], sh.box[2][c], sh.box[3][c],
                           sh.box[4][c], sh.box[5][c], far, tn));
      wanted |= reach;
      push_hits(need, (short)j, sh.need, &sh.n_need[q & 1], lane);
    }
    // a sorted list: a cluster no lane wants ends it
    if (!__syncthreads_or(wanted) && (!MODES || sorted)) break;
    if (q + 1 < ncl) stage(q + 1, (q + 1) & 1);
    if (t == 0) sh.n_need[(q + 1) & 1] = 0;
    const int nn = sh.n_need[q & 1];
    if (stats && t == 0 && nn > 0) ++sh.n_swept;
    if (SUB) {
      // each listed lane's sub-run bits at its own far bound
      const float* sb = reinterpret_cast<const float*>(sh.sub[q & 1]);
      for (int p = t; p < nn; p += K1) {
        const int j = sh.need[p];
        const float far = P::far(sh, j);
        const float4 o = sh.org[j], v = sh.inv[j];
        unsigned bits = 0;
#pragma unroll
        for (int r = 0; r < SUBRUNS; ++r)
          bits |= (unsigned)sub_pass(sb + r * SUB_Q * 4, o.x, o.y, o.z, v.x,
                                     v.y, v.z, far) << r;
        sh.sub_mask[p] = (unsigned char)bits;
      }
      __syncthreads();
    }
    if (!sweep) continue;
    // 4. thread t: triangle t against every lane that needs the cluster
    const float4* row = sh.stage[q & 1] + STAGE_Q * t;
    const float4 q0 = row[0], q1 = row[1], q2 = row[2];
    const int slot = cid * K1 + t;
    if (SUB) {
      const unsigned bit = 1u << (t / (K1 / SUBRUNS));
      for (int p = 0; p < nn; ++p)
        if (sh.sub_mask[p] & bit) P::pair(sh, sh.need[p], q0, q1, q2, slot);
    } else {
      for (int p = 0; p < nn; ++p) P::pair(sh, sh.need[p], q0, q1, q2, slot);
    }
  }
  __syncthreads();                       // the last sweep's commits
}

// Rank the chunk's or the supercluster's K2 cluster keys into
// sh.cl_list (ids: `base` + position) and return how many are gated.
// Every thread must call it (it ends with a barrier).
template <int NS, class State>
__device__ __forceinline__ int rank_clusters(WalkShared<NS, State>& sh,
                                             int base, bool far,
                                             bool unsorted) {
  const int t = threadIdx.x;
  bool hit = false;
  if (t < K2) {
    const u64 key = list_key(sort_key(sh.cl_key[t], far, unsorted),
                             base + t);
    int rank = 0;
    for (int j = 0; j < K2; ++j)
      rank += list_key(sort_key(sh.cl_key[j], far, unsorted), base + j) <
              key;
    sh.cl_list[rank] = list_key(sh.cl_key[t], base + t);
    hit = sh.cl_key[t] != NO_KEY;
  }
  return __syncthreads_count(hit);
}

// stats, lane 0 (see the header): this group's share of its dispatch
// block's work list, from step 1's keys (NO_KEY: no live lane passes the
// supercluster at its tmax). A lane's test of a cluster implies its test
// of the supercluster (the boxes nest and the rounding is monotone), so
// the groups of a block find every listed cluster between them. Thread
// t: cluster t % 64 against half of the live lanes.
template <int NS, class State>
__device__ __forceinline__ void stats_gate(const WalkShared<NS, State>& sh,
                                           const uint32_t* sc_key, int n_sc,
                                           const float* __restrict__ cl_boxes,
                                           int nlive, const Modes& m) {
  const int t = threadIdx.x, db = blockIdx.x / m.stat_groups;
  const float btmax = __ldg(m.stat_btmax + db);
  unsigned* mask = m.stat_mask + (size_t)db * m.mask_words;
  const int c = t & (K2 - 1), h = t / K2, half = (nlive + 1) / 2;
  const int end = min(nlive, h * half + half);
  for (int s = 0; s < n_sc; ++s) {
    if (sc_key[s] == NO_KEY) continue;
    const float* b = cl_boxes + (size_t)s * 8 * K2 + c;
    const float lx = __ldg(b + 0 * K2), ly = __ldg(b + 1 * K2);
    const float lz = __ldg(b + 2 * K2), hx = __ldg(b + 3 * K2);
    const float hy = __ldg(b + 4 * K2), hz = __ldg(b + 5 * K2);
    bool on = h == 0 && !(lx <= hx);                 // padding
    for (int q = h * half; q < end && lx <= hx && !on; ++q) {
      const int j = sh.live[q];
      const float4 o = sh.org[j], v = sh.inv[j];
      float tn;
      on = slab(o.x, o.y, o.z, v.x, v.y, v.z, lx, ly, lz, hx, hy, hz, o.w,
                tn) && tn < btmax;
    }
    if (on) atomicOr(mask + ((s * K2 + c) >> 5), 1u << (c & 31));
  }
}

// RECHECK in place of steps 1-2: the block's candidate list, in chunks
// of K2 (see the header). Every thread must call it.
template <int NS, class P, bool SUB, bool MODES>
__device__ __forceinline__ void walk_worklist(
    WalkShared<NS, typename P::State>& sh, const float* __restrict__ cl_boxes,
    const float* __restrict__ tri_data, WorkList wl, const Modes& m) {
  const int t = threadIdx.x, lane = t & 31;
  const int ablate = MODES ? m.ablate : ABL_NONE;
  const bool interval = MODES && m.interval;
  for (int e0 = 0; e0 < wl.count; e0 += K2) {
    // every lane's far bound against the least bound left (ascending)
    const float lb = __ldg(wl.tlb + e0);
    bool want = false;
#pragma unroll
    for (int k = 0; k < NS; ++k) {
      const int j = t + k * K1;
      const float far = P::far(sh, j);
      sh.inv[j].w = far;
      want |= far > TMIN && lb <= far;
      push_hits(far > TMIN, (short)j, sh.pass, &sh.n_pass, lane);
    }
    if (t < K2) sh.cl_key[t] = NO_KEY;
    if (t == 0) sh.n_need[0] = sh.n_need[1] = 0;
    // (every lane is past the previous chunk's walk here)
    if (!__syncthreads_or(want)) break;
    {
      const int npass = sh.n_pass, n = min(K2, wl.count - e0);
      const int c = t & (K2 - 1), h = t / K2, half = (npass + 1) / 2;
      if (c < n) {
        const int cid = __ldg(wl.cid + e0 + c);
        const float* b = cl_boxes + (size_t)(cid / K2) * 8 * K2 + (cid % K2);
        const float lx = __ldg(b + 0 * K2), ly = __ldg(b + 1 * K2);
        const float lz = __ldg(b + 2 * K2), hx = __ldg(b + 3 * K2);
        const float hy = __ldg(b + 4 * K2), hz = __ldg(b + 5 * K2);
        if (h == 0) {
          sh.box[0][c] = lx;
          sh.box[1][c] = ly;
          sh.box[2][c] = lz;
          sh.box[3][c] = hx;
          sh.box[4][c] = hy;
          sh.box[5][c] = hz;
          sh.ch_cid[c] = cid;
          sh.ch_smask[c] = wl.smask ? __ldg(wl.smask + e0 + c) : ~0;
          // interval: the listed bound is the key; no lane re-tests
          if (interval) sh.cl_key[c] = ordered(__ldg(wl.tlb + e0 + c));
        }
        if (!interval && lx <= hx) {        // padding clusters: min > max
          const uint32_t k = least_entry<false>(
              sh, sh.pass, h * half, min(npass, h * half + half), lx, ly,
              lz, hx, hy, hz);
          if (k != NO_KEY) atomicMin(&sh.cl_key[c], k);
        }
      }
    }
    __syncthreads();
    if (t == 0) sh.n_pass = 0;             // (read above, pushed next time)
    const bool unsorted = ablate == ABL_NODMA_NOSORT || ablate == ABL_NOSORT;
    const int ncl = rank_clusters(sh, 0, false, unsorted);
    if (ablate == ABL_NODMA_NOSORT || ablate == ABL_NODMA) continue;
    walk_list<NS, P, SUB, true, MODES>(sh, ncl, tri_data, m, !unsorted);
  }
}

// Walk the tree for the block's lanes. Before the call each thread has
// written org, dir, inv (xyz) and state of its lanes t + 128 k; after it
// (the last step is a barrier) every lane's state is final. The policy P
// gives `far(sh, j)`, lane j's current far bound (0 once it wants
// nothing), and `pair(sh, j, q0, q1, q2, slot)`, one (lane, staged
// triangle) test. ONE_ORIGIN: every lane has the same origin (A' with
// point origins). SUB, RECHECK: the modes of the header; `wl` is the
// block's candidate list under RECHECK. MODES: the run-time modes `m`
// (else they are compiled out). Every thread of the block must call it.
template <int NS, class P, bool ONE_ORIGIN = false, bool SUB = false,
          bool RECHECK = false, bool MODES = false>
__device__ __forceinline__ void group_walk(
    WalkShared<NS, typename P::State>& sh, const float* __restrict__ sc_boxes,
    int c2p, int n_sc, const float* __restrict__ cl_boxes,
    const float* __restrict__ tri_data, uint32_t* sc_key, u64* sc_list,
    WorkList wl = WorkList{}, const Modes& m = Modes{}) {
  const int t = threadIdx.x, lane = t & 31;
  const int ablate = MODES ? m.ablate : ABL_NONE;
  const int visit = MODES ? m.visit : VISIT_NEAR;
  const bool stats = MODES && m.stats != nullptr;
  const int* mid = visit == VISIT_MID ? sh.far_max : nullptr;
  if (t == 0) sh.n_live = sh.n_gated = sh.n_pass = sh.n_swept = 0;
  if (t < NS) sh.far_max[t] = 0;
  if (!RECHECK)
    for (int s = t; s < n_sc; s += K1) sc_key[s] = NO_KEY;
  __syncthreads();
#pragma unroll
  for (int k = 0; k < NS; ++k) {
    const int j = t + k * K1;
    const float far = P::far(sh, j);
    sh.inv[j].w = far;
    if (mid) atomicMax(&sh.far_max[k], __float_as_int(far));  // far >= 0
    push_hits(far > TMIN, (short)j, sh.live, &sh.n_live, lane);
  }
  __syncthreads();
  const int nlive = sh.n_live;
  if (nlive == 0) return;                       // (the whole block)
  auto done = [&]() {                           // stats: lane 1
    if (stats && t == 0 && sh.n_swept)
      atomicAdd(m.stats + 2 * (blockIdx.x / m.stat_groups) + 1, sh.n_swept);
  };
  if (RECHECK) {
    walk_worklist<NS, P, SUB, MODES>(sh, cl_boxes, tri_data, wl, m);
    done();
    return;
  }

  // 1. supercluster keys: neighbouring threads on neighbouring
  // superclusters and the same 32 live lanes (broadcast reads)
  const int chunks = (nlive + 31) / 32;
  for (int it = t; it < n_sc * chunks; it += K1) {
    const int chunk = it / n_sc, s = it - chunk * n_sc;
    const uint32_t k = least_entry<ONE_ORIGIN>(
        sh, sh.live, chunk * 32, min(nlive, chunk * 32 + 32),
        __ldg(sc_boxes + 0 * c2p + s), __ldg(sc_boxes + 1 * c2p + s),
        __ldg(sc_boxes + 2 * c2p + s), __ldg(sc_boxes + 3 * c2p + s),
        __ldg(sc_boxes + 4 * c2p + s), __ldg(sc_boxes + 5 * c2p + s), mid);
    if (k != NO_KEY) atomicMin(&sc_key[s], k);
  }
  __syncthreads();
  if (stats) stats_gate(sh, sc_key, n_sc, cl_boxes, nlive, m);
  const bool far_first = visit == VISIT_FAR;
  int gated = 0;
  for (int s = t; s < n_sc; s += K1) {
    const u64 key = list_key(sort_key(sc_key[s], far_first, false), s);
    int rank = 0;
    for (int j = 0; j < n_sc; ++j)
      rank += list_key(sort_key(sc_key[j], far_first, false), j) < key;
    sc_list[rank] = list_key(sc_key[s], s);
    gated += sc_key[s] != NO_KEY;
  }
  if (gated) atomicAdd(&sh.n_gated, gated);
  if (mid && t < NS) sh.far_max[t] = 0;         // (read above)
  __syncthreads();
  const int nsc = sh.n_gated;
  if (ablate == ABL_ONLYSC) return;
  // the lists ascend by entry t only in the default order
  const bool sc_sorted = visit == VISIT_NEAR;
  const bool cl_unsorted =
      ablate == ABL_NODMA_NOSORT || ablate == ABL_NOSORT;

  for (int e = 0; e < nsc; ++e) {
    // 2. this supercluster: each lane's own test, then the cluster keys
    const u64 skey = sc_list[e];
    const int s = (int)(uint32_t)skey;
    const float entry = unordered((uint32_t)(skey >> 32));
    bool want = false;
#pragma unroll
    for (int k = 0; k < NS; ++k) {
      const int j = t + k * K1;
      const float far = P::far(sh, j);
      const float4 o = sh.org[j], v = sh.inv[j];
      float tn;
      const bool pass = slab(
          o.x, o.y, o.z, v.x, v.y, v.z, __ldg(sc_boxes + 0 * c2p + s),
          __ldg(sc_boxes + 1 * c2p + s), __ldg(sc_boxes + 2 * c2p + s),
          __ldg(sc_boxes + 3 * c2p + s), __ldg(sc_boxes + 4 * c2p + s),
          __ldg(sc_boxes + 5 * c2p + s), far, tn);
      sh.inv[j].w = pass ? far : 0.0f;
      if (mid) atomicMax(&sh.far_max[k], __float_as_int(far));
      want |= far > TMIN && entry <= far;
      push_hits(pass, (short)j, sh.pass, &sh.n_pass, lane);
    }
    if (t < K2) sh.cl_key[t] = NO_KEY;
    if (t == 0) sh.n_need[0] = sh.n_need[1] = 0;
    // (every lane is past the previous supercluster's walk here)
    if (!__syncthreads_or(want) && (!MODES || sc_sorted)) break;
    {
      const int npass = sh.n_pass;
      const int c = t & (K2 - 1), h = t / K2, half = (npass + 1) / 2;
      const float* b = cl_boxes + (size_t)s * 8 * K2 + c;
      const float lx = __ldg(b + 0 * K2), ly = __ldg(b + 1 * K2);
      const float lz = __ldg(b + 2 * K2), hx = __ldg(b + 3 * K2);
      const float hy = __ldg(b + 4 * K2), hz = __ldg(b + 5 * K2);
      if (h == 0) {
        sh.box[0][c] = lx;
        sh.box[1][c] = ly;
        sh.box[2][c] = lz;
        sh.box[3][c] = hx;
        sh.box[4][c] = hy;
        sh.box[5][c] = hz;
      }
      if (lx <= hx) {                       // padding clusters: min > max
        const uint32_t k = least_entry<ONE_ORIGIN>(
            sh, sh.pass, h * half, min(npass, h * half + half), lx, ly, lz,
            hx, hy, hz, mid);
        if (k != NO_KEY) atomicMin(&sh.cl_key[c], k);
      }
    }
    __syncthreads();
    if (t == 0) sh.n_pass = 0;             // (read above, pushed next time)
    if (mid && t < NS) sh.far_max[t] = 0;  // (read above)
    if (ablate == ABL_NOEMIT) {
      __syncthreads();
      continue;
    }
    // 3. the clusters in order, and 4. their sweeps
    const int ncl = rank_clusters(sh, s * K2, far_first, cl_unsorted);
    if (ablate == ABL_NODMA_NOSORT || ablate == ABL_NODMA) continue;
    walk_list<NS, P, SUB, false, MODES>(sh, ncl, tri_data, m,
                                        sc_sorted && !cl_unsorted);
  }
  done();
}

// The any-hit policy of kernels A' (NS = 1) and B: a lane's far bound is
// its segment's end until a blocker is found, then 0 (it wants nothing
// more). The answer is whether any gated cluster holds a blocker, so
// the visit order cannot change it.
struct Occl {
  typedef unsigned char State;           // 1: blocked

  template <int NS>
  static __device__ __forceinline__ float far(
      const WalkShared<NS, unsigned char>& sh, int j) {
    return sh.state[j] ? 0.0f : sh.org[j].w;
  }

  template <int NS>
  static __device__ __forceinline__ void pair(
      WalkShared<NS, unsigned char>& sh, int j, float4 q0, float4 q1,
      float4 q2, int) {
    const float4 o = sh.org[j], d = sh.dir[j];
    Ray r;
    r.ox = o.x;
    r.oy = o.y;
    r.oz = o.z;
    r.dx = d.x;
    r.dy = d.y;
    r.dz = d.z;
    if (occludes(mt_values(r, q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w,
                           q2.x),
                 o.w))
      sh.state[j] = 1;
  }
};

}  // namespace vkrt
