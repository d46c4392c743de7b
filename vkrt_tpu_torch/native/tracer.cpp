// Native CPU ray tracer — the host-side runtime component.
//
// Role: the reference implements its entire host runtime in C++ (SURVEY.md
// §2 — all 20 components are native). In this framework the TPU compute
// path is JAX/Pallas, and this library is the native host-side engine:
// a median-split BVH + closest-hit/occlusion traversal used by
//   * the golden-image oracle (exact same intersection contract as the
//     device kernels, at CPU speed the numpy brute force cannot reach),
//   * any CPU fallback rendering path.
//
// Exposed as a C API consumed via ctypes (no pybind11 in this image).
// Intersection semantics mirror rt/intersect.py: Möller–Trumbore, no
// culling, det guard 1e-12, hit iff tmin < t < tmax.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Vec3 {
    float x, y, z;
};

static inline Vec3 sub(Vec3 a, Vec3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
static inline Vec3 cross(Vec3 a, Vec3 b) {
    return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
static inline float dot(Vec3 a, Vec3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
static inline Vec3 vmin(Vec3 a, Vec3 b) {
    return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
static inline Vec3 vmax(Vec3 a, Vec3 b) {
    return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}

struct Tri {
    Vec3 v0, e1, e2;
};

struct Node {
    Vec3 bmin, bmax;
    int32_t left;    // internal: child index; leaf: -(first+1)
    int32_t count;   // leaf triangle count (0 for internal)
};

struct BVH {
    std::vector<Tri> tris;       // reordered
    std::vector<int32_t> ids;    // reordered -> original
    std::vector<Node> nodes;
};

constexpr float kInf = 3.0e38f;
constexpr double kDetEps = 1e-12;

static void build_recursive(BVH& bvh, std::vector<int32_t>& order,
                            std::vector<Vec3>& centroids,
                            const std::vector<Tri>& src,
                            int node_index, int first, int count) {
    Vec3 bmin = {kInf, kInf, kInf}, bmax = {-kInf, -kInf, -kInf};
    Vec3 cmin = {kInf, kInf, kInf}, cmax = {-kInf, -kInf, -kInf};
    for (int i = first; i < first + count; ++i) {
        const Tri& t = src[order[i]];
        Vec3 p0 = t.v0;
        Vec3 p1 = {t.v0.x + t.e1.x, t.v0.y + t.e1.y, t.v0.z + t.e1.z};
        Vec3 p2 = {t.v0.x + t.e2.x, t.v0.y + t.e2.y, t.v0.z + t.e2.z};
        bmin = vmin(bmin, vmin(p0, vmin(p1, p2)));
        bmax = vmax(bmax, vmax(p0, vmax(p1, p2)));
        cmin = vmin(cmin, centroids[order[i]]);
        cmax = vmax(cmax, centroids[order[i]]);
    }
    Node& node = bvh.nodes[node_index];
    node.bmin = bmin;
    node.bmax = bmax;

    if (count <= 4) {
        node.left = -(first + 1);
        node.count = count;
        return;
    }
    Vec3 ext = sub(cmax, cmin);
    int axis = 0;
    if (ext.y > ext.x) axis = 1;
    if (ext.z > (axis == 0 ? ext.x : ext.y)) axis = 2;

    int mid = first + count / 2;
    std::nth_element(order.begin() + first, order.begin() + mid,
                     order.begin() + first + count,
                     [&](int32_t a, int32_t b) {
                         const Vec3& ca = centroids[a];
                         const Vec3& cb = centroids[b];
                         return (axis == 0 ? ca.x < cb.x
                                : axis == 1 ? ca.y < cb.y : ca.z < cb.z);
                     });

    int left_index = static_cast<int>(bvh.nodes.size());
    bvh.nodes.emplace_back();
    bvh.nodes.emplace_back();
    bvh.nodes[node_index].left = left_index;
    bvh.nodes[node_index].count = 0;
    build_recursive(bvh, order, centroids, src, left_index, first, count / 2);
    build_recursive(bvh, order, centroids, src, left_index + 1, mid,
                    count - count / 2);
}

static inline bool intersect_box(const Node& n, Vec3 o, Vec3 inv, float tmin,
                                 float tmax) {
    float t0 = (n.bmin.x - o.x) * inv.x, t1 = (n.bmax.x - o.x) * inv.x;
    float tn = std::min(t0, t1), tf = std::max(t0, t1);
    t0 = (n.bmin.y - o.y) * inv.y; t1 = (n.bmax.y - o.y) * inv.y;
    tn = std::max(tn, std::min(t0, t1)); tf = std::min(tf, std::max(t0, t1));
    t0 = (n.bmin.z - o.z) * inv.z; t1 = (n.bmax.z - o.z) * inv.z;
    tn = std::max(tn, std::min(t0, t1)); tf = std::min(tf, std::max(t0, t1));
    return tn <= tf && tf >= tmin && tn <= tmax;
}

static inline bool intersect_tri(const Tri& tri, Vec3 o, Vec3 d, float tmin,
                                 float tmax, float& t, float& u, float& v) {
    Vec3 h = cross(d, tri.e2);
    float det = dot(tri.e1, h);
    if (std::fabs(det) <= kDetEps) return false;
    float inv_det = 1.0f / det;
    Vec3 s = sub(o, tri.v0);
    u = dot(s, h) * inv_det;
    if (u < 0.0f) return false;
    Vec3 q = cross(s, tri.e1);
    v = dot(d, q) * inv_det;
    if (v < 0.0f || u + v > 1.0f) return false;
    t = dot(tri.e2, q) * inv_det;
    return t > tmin && t < tmax;
}

// --- Stability classification (golden-gate support) ------------------------
//
// Two independent, both-correct f32 tracers legitimately disagree on rays
// that pass within float-rounding distance of an acceptance boundary
// (triangle edges via u/v/u+v, the t window, near-tie closest commits,
// near-degenerate determinants). The flagged variants below certify each
// ray: stable==1 means every correct f32 tracer must reproduce the result,
// so the golden gate can demand raw-RMSE conformance on the certified set
// and exclude only ORACLE-identified boundary rays (never observed-diff
// trimming). Margins: mu — absolute barycentric margin; mt — relative t
// margin; determinant flagged when |det| is a heavy cancellation of its
// terms.

struct TriMargin {
    bool strict;    // standard accept
    bool widened;   // accept with +margin slack (could flip to hit)
    bool interior;  // accept with -margin slack (solidly inside)
    float t;
};

// Margins are PHYSICS-DERIVED, not fixed: two correct tracers produce the
// same ray with direction error ~deps (relative, a few f32 ulps through
// independent raygen arithmetic) and origin error ~oeps (world units;
// nonzero for secondary rays whose origin is an interpolated hit point).
// The hit point then shifts by dx = t*deps + oeps in-plane after the
// 1/sin(incidence) grazing amplification |n|/|det|, giving
//   du = dx * |e2| / |det|      (and |e1| for v; 2A = |n| cancels)
//   dt = dx * |n|  / |det|
// plus a base arithmetic margin mu/mt for the intersection math itself.
// Measured on hardware (round 4): fixed mu=1e-4 margins MISSED the
// engine-vs-oracle flips — t/edge amplification on small distant
// triangles exceeds any fixed barycentric slack.
static inline TriMargin intersect_tri_margin(const Tri& tri, Vec3 o, Vec3 d,
                                             float tmin, float tlim,
                                             float mu, float mt,
                                             float deps, float oeps) {
    TriMargin r{false, false, false, kInf};
    Vec3 h = cross(d, tri.e2);
    float det = dot(tri.e1, h);
    float adet = std::fabs(det);
    float cancel = std::fabs(tri.e1.x * h.x) + std::fabs(tri.e1.y * h.y)
                 + std::fabs(tri.e1.z * h.z);
    if (adet <= kDetEps) {
        // near-parallel: too ill-conditioned to evaluate; a widened
        // candidate (flags the ray) iff the determinant is a genuine
        // cancellation of non-trivial terms
        r.widened = cancel > 1e-12f;
        return r;
    }
    float inv_det = 1.0f / det;
    Vec3 s = sub(o, tri.v0);
    float u = dot(s, h) * inv_det;
    Vec3 q = cross(s, tri.e1);
    float v = dot(d, q) * inv_det;
    float t = dot(tri.e2, q) * inv_det;
    r.t = t;
    float w = 1.0f - u - v;
    r.strict = u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > tmin && t < tlim;

    float le1 = std::sqrt(dot(tri.e1, tri.e1));
    float le2 = std::sqrt(dot(tri.e2, tri.e2));
    Vec3 nrm = cross(tri.e1, tri.e2);
    float ln = std::sqrt(dot(nrm, nrm));
    float dx = std::fabs(t) * deps + oeps;          // world-space shift
    float du = mu + dx * le2 / adet;
    float dv = mu + dx * le1 / adet;
    float dw = mu + dx * (le1 + le2) / adet;
    float dt = mt * std::fabs(t) + dx * ln / adet;
    // arithmetic conditioning of det itself: heavy cancellation makes
    // u/v/t unreliable regardless of geometry
    bool det_solid = adet > 1e-5f * cancel;

    r.widened = u >= -du && v >= -dv && w >= -dw
             && t > tmin - dt && t < tlim + dt;
    r.interior = det_solid && u > du && v > dv && w > dw
              && t > tmin + dt && t < tlim - dt;
    return r;
}

// box test with slabs widened by a small relative epsilon so marginal
// candidates are never pruned before the triangle-level margin test
static inline bool intersect_box_wide(const Node& n, Vec3 o, Vec3 inv,
                                      float tmin, float tmax) {
    auto wide = [](float lo, float hi) {
        float w = 1e-5f * (std::fabs(lo) + std::fabs(hi)) + 1e-30f;
        return w;
    };
    float wx = wide(n.bmin.x, n.bmax.x);
    float wy = wide(n.bmin.y, n.bmax.y);
    float wz = wide(n.bmin.z, n.bmax.z);
    float t0 = (n.bmin.x - wx - o.x) * inv.x, t1 = (n.bmax.x + wx - o.x) * inv.x;
    float tn = std::min(t0, t1), tf = std::max(t0, t1);
    t0 = (n.bmin.y - wy - o.y) * inv.y; t1 = (n.bmax.y + wy - o.y) * inv.y;
    tn = std::max(tn, std::min(t0, t1)); tf = std::min(tf, std::max(t0, t1));
    t0 = (n.bmin.z - wz - o.z) * inv.z; t1 = (n.bmax.z + wz - o.z) * inv.z;
    tn = std::max(tn, std::min(t0, t1)); tf = std::min(tf, std::max(t0, t1));
    return tn <= tf && tf >= tmin && tn <= tmax;
}

static inline Vec3 safe_inv(Vec3 d) {
    auto inv1 = [](float x) {
        const float tiny = 1e-20f;
        if (std::fabs(x) < tiny) x = x < 0 ? -tiny : tiny;
        return 1.0f / x;
    };
    return {inv1(d.x), inv1(d.y), inv1(d.z)};
}

}  // namespace

extern "C" {

void* vkrt_bvh_create(const float* v0, const float* e1, const float* e2,
                      int32_t num_tris) {
    BVH* bvh = new BVH();
    std::vector<Tri> src(num_tris);
    std::vector<Vec3> centroids(num_tris);
    std::vector<int32_t> order(num_tris);
    for (int i = 0; i < num_tris; ++i) {
        src[i].v0 = {v0[3 * i], v0[3 * i + 1], v0[3 * i + 2]};
        src[i].e1 = {e1[3 * i], e1[3 * i + 1], e1[3 * i + 2]};
        src[i].e2 = {e2[3 * i], e2[3 * i + 1], e2[3 * i + 2]};
        centroids[i] = {src[i].v0.x + (src[i].e1.x + src[i].e2.x) / 3.0f,
                        src[i].v0.y + (src[i].e1.y + src[i].e2.y) / 3.0f,
                        src[i].v0.z + (src[i].e1.z + src[i].e2.z) / 3.0f};
        order[i] = i;
    }
    bvh->nodes.reserve(2 * num_tris);
    bvh->nodes.emplace_back();
    build_recursive(*bvh, order, centroids, src, 0, 0, num_tris);
    bvh->tris.resize(num_tris);
    bvh->ids.resize(num_tris);
    for (int i = 0; i < num_tris; ++i) {
        bvh->tris[i] = src[order[i]];
        bvh->ids[i] = order[i];
    }
    return bvh;
}

void vkrt_bvh_destroy(void* handle) { delete static_cast<BVH*>(handle); }

void vkrt_trace_closest(void* handle, const float* origins, const float* dirs,
                        const float* tmax, int32_t num_rays, float tmin,
                        float* t_out, int32_t* tri_out, float* u_out,
                        float* v_out) {
    const BVH& bvh = *static_cast<BVH*>(handle);
    #pragma omp parallel for schedule(dynamic, 64)
    for (int r = 0; r < num_rays; ++r) {
        Vec3 o = {origins[3 * r], origins[3 * r + 1], origins[3 * r + 2]};
        Vec3 d = {dirs[3 * r], dirs[3 * r + 1], dirs[3 * r + 2]};
        Vec3 inv = safe_inv(d);
        float best_t = tmax[r];
        int32_t best = -1;
        float best_u = 0, best_v = 0;

        int32_t stack[96];
        int sp = 0;
        stack[sp++] = 0;
        while (sp > 0) {
            const Node& n = bvh.nodes[stack[--sp]];
            if (!intersect_box(n, o, inv, tmin, best_t)) continue;
            if (n.count > 0) {
                int first = -n.left - 1;
                for (int i = first; i < first + n.count; ++i) {
                    float t, u, v;
                    if (intersect_tri(bvh.tris[i], o, d, tmin, best_t, t, u, v)) {
                        best_t = t;
                        best = bvh.ids[i];
                        best_u = u;
                        best_v = v;
                    }
                }
            } else {
                stack[sp++] = n.left;
                stack[sp++] = n.left + 1;
            }
        }
        t_out[r] = best >= 0 ? best_t : kInf;
        tri_out[r] = best;
        u_out[r] = best_u;
        v_out[r] = best_v;
    }
}

void vkrt_trace_occluded(void* handle, const float* origins, const float* dirs,
                         const float* tmax, int32_t num_rays, float tmin,
                         uint8_t* out) {
    const BVH& bvh = *static_cast<BVH*>(handle);
    #pragma omp parallel for schedule(dynamic, 64)
    for (int r = 0; r < num_rays; ++r) {
        Vec3 o = {origins[3 * r], origins[3 * r + 1], origins[3 * r + 2]};
        Vec3 d = {dirs[3 * r], dirs[3 * r + 1], dirs[3 * r + 2]};
        Vec3 inv = safe_inv(d);
        float tr = tmax[r];
        uint8_t hit = 0;

        int32_t stack[96];
        int sp = 0;
        stack[sp++] = 0;
        while (sp > 0 && !hit) {
            const Node& n = bvh.nodes[stack[--sp]];
            if (!intersect_box(n, o, inv, tmin, tr)) continue;
            if (n.count > 0) {
                int first = -n.left - 1;
                for (int i = first; i < first + n.count; ++i) {
                    float t, u, v;
                    if (intersect_tri(bvh.tris[i], o, d, tmin, tr, t, u, v)) {
                        hit = 1;
                        break;
                    }
                }
            } else {
                stack[sp++] = n.left;
                stack[sp++] = n.left + 1;
            }
        }
        out[r] = hit;
    }
}

// Stability-flagged closest hit: identical results to vkrt_trace_closest,
// plus stable_out[r]=1 iff the committed result is boundary-safe — the
// winner is margin-interior AND no other candidate came within the widened
// acceptance or within mt of the winning t (two-phase: exact traversal for
// best_t, then a widened re-traversal classifying every candidate against
// the final answer).
void vkrt_trace_closest_stable(void* handle, const float* origins,
                               const float* dirs, const float* tmax,
                               int32_t num_rays, float tmin, float mu,
                               float mt, float deps, float oeps,
                               float* t_out, int32_t* tri_out,
                               float* u_out, float* v_out,
                               uint8_t* stable_out) {
    const BVH& bvh = *static_cast<BVH*>(handle);
    #pragma omp parallel for schedule(dynamic, 64)
    for (int r = 0; r < num_rays; ++r) {
        Vec3 o = {origins[3 * r], origins[3 * r + 1], origins[3 * r + 2]};
        Vec3 d = {dirs[3 * r], dirs[3 * r + 1], dirs[3 * r + 2]};
        Vec3 inv = safe_inv(d);
        float best_t = tmax[r];
        int32_t best = -1, best_slot = -1;
        float best_u = 0, best_v = 0;

        int32_t stack[96];
        int sp = 0;
        stack[sp++] = 0;
        while (sp > 0) {
            const Node& n = bvh.nodes[stack[--sp]];
            if (!intersect_box(n, o, inv, tmin, best_t)) continue;
            if (n.count > 0) {
                int first = -n.left - 1;
                for (int i = first; i < first + n.count; ++i) {
                    float t, u, v;
                    if (intersect_tri(bvh.tris[i], o, d, tmin, best_t, t, u, v)) {
                        best_t = t;
                        best = bvh.ids[i];
                        best_slot = i;
                        best_u = u;
                        best_v = v;
                    }
                }
            } else {
                stack[sp++] = n.left;
                stack[sp++] = n.left + 1;
            }
        }
        t_out[r] = best >= 0 ? best_t : kInf;
        tri_out[r] = best;
        u_out[r] = best_u;
        v_out[r] = best_v;

        // phase 2: widened classification vs the final answer
        float tlim = best >= 0 ? best_t : tmax[r];
        bool unstable = false;
        if (best >= 0) {
            TriMargin wm = intersect_tri_margin(bvh.tris[best_slot], o, d,
                                                tmin, tmax[r], mu, mt,
                                                deps, oeps);
            if (!wm.interior) unstable = true;
        }
        sp = 0;
        stack[sp++] = 0;
        // traversal bound: candidates beyond ~0.1% of the committed t
        // whose own dt-margin still reaches back are near-parallel
        // grazers behind committed geometry — vanishing and accepted
        float wide_lim = tlim * (1.0f + mt + 1e-3f);
        while (sp > 0 && !unstable) {
            const Node& n = bvh.nodes[stack[--sp]];
            if (!intersect_box_wide(n, o, inv, tmin * (1.0f - mt), wide_lim))
                continue;
            if (n.count > 0) {
                int first = -n.left - 1;
                for (int i = first; i < first + n.count; ++i) {
                    if (i == best_slot) continue;
                    TriMargin m = intersect_tri_margin(
                        bvh.tris[i], o, d, tmin, tlim, mu, mt, deps, oeps);
                    // any other candidate that could win under rounding:
                    // widened-accepted against the committed t window
                    if (m.widened) { unstable = true; break; }
                }
            } else {
                stack[sp++] = n.left;
                stack[sp++] = n.left + 1;
            }
        }
        stable_out[r] = unstable ? 0 : 1;
    }
}

// Stability-flagged occlusion: out identical to vkrt_trace_occluded;
// stable_out[r]=1 iff the answer cannot flip under float rounding —
// either some blocker is margin-interior (solidly occluded) or no
// candidate even enters the widened acceptance (solidly clear).
void vkrt_trace_occluded_stable(void* handle, const float* origins,
                                const float* dirs, const float* tmax,
                                int32_t num_rays, float tmin, float mu,
                                float mt, float deps, float oeps,
                                uint8_t* out, uint8_t* stable_out) {
    const BVH& bvh = *static_cast<BVH*>(handle);
    #pragma omp parallel for schedule(dynamic, 64)
    for (int r = 0; r < num_rays; ++r) {
        Vec3 o = {origins[3 * r], origins[3 * r + 1], origins[3 * r + 2]};
        Vec3 d = {dirs[3 * r], dirs[3 * r + 1], dirs[3 * r + 2]};
        Vec3 inv = safe_inv(d);
        float tr = tmax[r];
        bool any_strict = false, any_solid = false, any_widened = false;

        int32_t stack[96];
        int sp = 0;
        stack[sp++] = 0;
        while (sp > 0 && !any_solid) {
            const Node& n = bvh.nodes[stack[--sp]];
            if (!intersect_box_wide(n, o, inv, tmin * (1.0f - mt),
                                    tr * (1.0f + mt + 1e-3f)))
                continue;
            if (n.count > 0) {
                int first = -n.left - 1;
                for (int i = first; i < first + n.count; ++i) {
                    TriMargin m = intersect_tri_margin(
                        bvh.tris[i], o, d, tmin, tr, mu, mt, deps, oeps);
                    any_strict |= m.strict;
                    any_widened |= m.widened;
                    if (m.interior) { any_solid = true; break; }
                }
            } else {
                stack[sp++] = n.left;
                stack[sp++] = n.left + 1;
            }
        }
        out[r] = (any_strict || any_solid) ? 1 : 0;
        stable_out[r] = (any_solid || !any_widened) ? 1 : 0;
    }
}

}  // extern "C"
