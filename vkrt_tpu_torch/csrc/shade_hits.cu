// Kernel L: the ray tracer's hit shading at one depth, in three steps around
// the material sample (kernel K) and the shadow trace (kernel B).
//
// L replaces no Pallas kernel: the JAX package shades in XLA
// (vkrt_tpu/shade/shading.py and the engine's combine,
// vkrt_tpu/wavefront/engine.py:700-736), and the port's plain PyTorch
// versions (vkrt_tpu_torch/shade/shading.py::shade_*_plain, the CPU path)
// run some 40 elementwise kernels a depth over the whole [Nb,128]
// wavefront, every intermediate a round trip to memory, whatever share of
// the lanes is live (at config 5's depth 3 about a fifth).
//
//   shade_interp   a hit's position (rows 0-8 of the attribute block), uv
//                  (rows 18-23) and base-map slot (row 33, truncated), and
//                  the hit mask;
//   shade_lights   a hit's perturbed normal (normal rows 9-17, tangent rows
//                  24-32, the sampled normal map) and, per light, whether
//                  it faces the light (the cast bitmask) and the shadow
//                  segment kernel B takes (-ldir, ldist - TMIN);
//   shade_combine  the miss shader, the light sum with the shadow
//                  multiplier, the attenuation quirk (shader.rchit:165-167),
//                  the colour and ray count added in place (or written, for
//                  the lane-sorted depth iteration), and the reflection
//                  carry updated in place. Light geometry is elementwise, so
//                  it is recomputed from the point and the normal rather
//                  than stored by shade_lights and read back.
//
// What bounds it on the H100: bytes. A lane that is not live reads its mask
// and writes zeros (interp: 25 bytes; lights: 16 + 16 a light with
// segments) or nothing (combine). A hit reads about 100 bytes in
// shade_interp, 105 + the segments in shade_lights and 60-110 in
// shade_combine; the arithmetic, under 400 float operations a hit with four
// lights, is far below the bytes' time.
//
// Design: one thread a lane, 256 a block, every array in the lane-major
// [rows, Nb * 128] layout read and written at the thread's own index
// (coalesced, nothing packed or permuted). The light count is a template
// parameter, so the per-light loops unroll.
//
// Bits: every value is the plain version's on CUDA tensors. The library is
// built with -fmad=false, IEEE division and square root; sums run in
// PyTorch's order ((a + b) + c, w = (1 - u) - v); a clamp keeps a NaN as
// torch.clamp does; `s / x` for a Python scalar s is PyTorch's
// reciprocal(x) * s, and `x / s` (none here) would be x * (1 / s).
#include "common.cuh"

namespace vkrt {

constexpr int SHADE_THREADS = 256;
constexpr int MAX_LIGHTS = 4;
constexpr float LIGHT_INTENSITY = 10.0f;    // ref: shader.rchit:111
constexpr float SHADOW_MULTIPLIER = 0.3f;   // ref: shader.rchit:147
constexpr float AMBIENT = 0.1f;             // ref: shader.rchit:154
constexpr float METALLIC_THRESHOLD = 0.1f;  // ref: shader.rchit:162
constexpr float REFLECT_SCALE = 0.5f;       // ref: shader.rchit:165
constexpr float NORM_EPS = 1e-20f;          // layout.normalize3, light_geometry
__constant__ float SKY[3] = {0.8f, 0.8f, 1.0f};  // ref: shader.rmiss:17

// torch.clamp(x, min=lo) and torch.clamp(x, lo, hi) on CUDA: a NaN passes.
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return isnan(x) ? x : fmaxf(x, lo);
}
__device__ __forceinline__ float clamp01(float x) {
  return isnan(x) ? x : fminf(fmaxf(x, 0.0f), 1.0f);
}

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ float dot3(V3 a, V3 b) {
  return (a.x * b.x + a.y * b.y) + a.z * b.z;
}

// layout.normalize3: a / clamp(sqrt(clamp(dot(a, a), 0)), 1e-20).
__device__ __forceinline__ V3 normalize3(V3 a) {
  const float d = clamp_min(sqrtf(clamp_min(dot3(a, a), 0.0f)), NORM_EPS);
  return {a.x / d, a.y / d, a.z / d};
}

// Row r of a [rows, n] array at lane i.
__device__ __forceinline__ float row(const float* __restrict__ a, int r,
                                     int n, int i) {
  return __ldg(a + static_cast<size_t>(r) * n + i);
}

__device__ __forceinline__ V3 load3(const float* __restrict__ a, int r, int n,
                                    int i) {
  return {row(a, r, n, i), row(a, r + 1, n, i), row(a, r + 2, n, i)};
}

// shading._blend: corner 0 at w, corner 1 at u, corner 2 at v, rows
// r.., r + k.., r + 2k.. of the attribute block.
__device__ __forceinline__ float blend(const float* __restrict__ attrs, int r,
                                       int k, int n, int i, float w, float u,
                                       float v) {
  return (row(attrs, r, n, i) * w + row(attrs, r + k, n, i) * u) +
         row(attrs, r + 2 * k, n, i) * v;
}

// shading.light_geometry at one lane: direction, distance and power.
struct LightGeo {
  V3 dir;
  float dist, power;
};

__device__ __forceinline__ LightGeo light_geometry(
    const float* __restrict__ lights, int s, V3 p) {
  const V3 l = {__ldg(lights + 3 * s) - p.x, __ldg(lights + 3 * s + 1) - p.y,
                __ldg(lights + 3 * s + 2) - p.z};
  LightGeo g;
  g.dist = sqrtf(clamp_min(dot3(l, l), 0.0f));
  const float d = clamp_min(g.dist, NORM_EPS);
  g.dir = {l.x / d, l.y / d, l.z / d};
  g.power = (1.0f / clamp_min(g.dist * g.dist, NORM_EPS)) * LIGHT_INTENSITY;
  return g;
}

__global__ void __launch_bounds__(SHADE_THREADS) shade_interp_kernel(
    const uint8_t* __restrict__ active, const uint8_t* __restrict__ hitm,
    const float* __restrict__ u, const float* __restrict__ v,
    const float* __restrict__ attrs, int n, float* __restrict__ out,
    uint8_t* __restrict__ hit) {
  const int i = blockIdx.x * SHADE_THREADS + threadIdx.x;
  if (i >= n) return;
  const bool h = active[i] && hitm[i];
  hit[i] = h;
  if (!h) {
#pragma unroll
    for (int c = 0; c < 6; ++c) out[c * n + i] = 0.0f;
    return;
  }
  const float uu = __ldg(u + i), vv = __ldg(v + i);
  const float w = (1.0f - uu) - vv;
#pragma unroll
  for (int c = 0; c < 3; ++c)            // v0 + u * e1 + v * e2
    out[c * n + i] = (row(attrs, c, n, i) + uu * row(attrs, 3 + c, n, i)) +
                     vv * row(attrs, 6 + c, n, i);
#pragma unroll
  for (int c = 0; c < 2; ++c)
    out[(3 + c) * n + i] = blend(attrs, 18 + c, 2, n, i, w, uu, vv);
  reinterpret_cast<int*>(out)[5 * n + i] =
      static_cast<int>(row(attrs, 33, n, i));
}

// out: pn [3, n]; with NL > 0 the cast bitmask [n] (as f32), and with
// `segments` sd [NL, 3, n] and st [NL, n].
template <int NL>
__global__ void __launch_bounds__(SHADE_THREADS) shade_lights_kernel(
    const uint8_t* __restrict__ hit, const float* __restrict__ u,
    const float* __restrict__ v, const float* __restrict__ attrs,
    const float* __restrict__ map_n, const float* __restrict__ pos,
    const float* __restrict__ lights, int segments, int n,
    float* __restrict__ out) {
  const int i = blockIdx.x * SHADE_THREADS + threadIdx.x;
  if (i >= n) return;
  const bool h = hit[i];
  V3 pn = {0.0f, 0.0f, 0.0f}, p = {0.0f, 0.0f, 0.0f};
  if (h) {
    const float uu = __ldg(u + i), vv = __ldg(v + i);
    const float w = (1.0f - uu) - vv;
    const V3 nw = normalize3({blend(attrs, 9, 3, n, i, w, uu, vv),
                              blend(attrs, 10, 3, n, i, w, uu, vv),
                              blend(attrs, 11, 3, n, i, w, uu, vv)});
    const V3 t = normalize3({blend(attrs, 24, 3, n, i, w, uu, vv),
                             blend(attrs, 25, 3, n, i, w, uu, vv),
                             blend(attrs, 26, 3, n, i, w, uu, vv)});
    const V3 b = {t.y * nw.z - t.z * nw.y, t.z * nw.x - t.x * nw.z,
                  t.x * nw.y - t.y * nw.x};
    const V3 mn = load3(map_n, 0, n, i);
    const V3 m = normalize3({mn.x * 2.0f - 1.0f, mn.y * 2.0f - 1.0f,
                             mn.z * 2.0f - 1.0f});
    pn = normalize3({(t.x * m.x + b.x * m.y) + nw.x * m.z,
                     (t.y * m.x + b.y * m.y) + nw.y * m.z,
                     (t.z * m.x + b.z * m.y) + nw.z * m.z});
    p = load3(pos, 0, n, i);
  }
  out[i] = pn.x;
  out[n + i] = pn.y;
  out[2 * n + i] = pn.z;
  if (NL == 0) return;
  float* sd = out + 4 * static_cast<size_t>(n);
  float* st = sd + 3 * NL * static_cast<size_t>(n);
  int bits = 0;
  if (h || segments) {
#pragma unroll
    for (int s = 0; s < NL; ++s) {
      const LightGeo g = light_geometry(lights, s, p);
      const bool cast = h && dot3(pn, g.dir) > 0.0f;
      bits |= static_cast<int>(cast) << s;
      if (segments) {
        sd[(3 * s) * static_cast<size_t>(n) + i] = -g.dir.x;
        sd[(3 * s + 1) * static_cast<size_t>(n) + i] = -g.dir.y;
        sd[(3 * s + 2) * static_cast<size_t>(n) + i] = -g.dir.z;
        st[s * static_cast<size_t>(n) + i] = cast ? g.dist - TMIN : 0.0f;
      }
    }
  }
  out[3 * n + i] = static_cast<float>(bits);
}

// The in-place carry (origins, dirs: [3, n]; attenuation, active: [n]) and
// either accum [3, n] and ray_count [n] updated in place or, where accum is
// null, dacc [3, n] and dcount [n] written (`out`, [4, n]). `occ` [NL, n] is
// null without shadows; with `flat` only accum and ray_count are touched.
template <int NL>
__global__ void __launch_bounds__(SHADE_THREADS) shade_combine_kernel(
    uint8_t* __restrict__ active, const uint8_t* __restrict__ hitm,
    const float* __restrict__ base, const float* __restrict__ metallic,
    const float* __restrict__ pn, const float* __restrict__ pos,
    const float* __restrict__ lights, const uint8_t* __restrict__ occ,
    float* __restrict__ origins, float* __restrict__ dirs,
    float* __restrict__ attenuation, float* __restrict__ accum,
    int* __restrict__ ray_count, float* __restrict__ out, int reflections,
    int flat, int n) {
  const int i = blockIdx.x * SHADE_THREADS + threadIdx.x;
  if (i >= n) return;
  if (!active[i]) {
    if (out != nullptr) {
#pragma unroll
      for (int c = 0; c < 4; ++c) out[c * n + i] = 0.0f;
    }
    return;
  }
  const bool h = hitm[i];
  if (flat) {                      // (accum + sky or 0) + (base or 0)
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float a = accum[c * n + i] + (h ? 0.0f : SKY[c]);
      accum[c * n + i] = a + (h ? row(base, c, n, i) : 0.0f);
    }
    ray_count[i] += 1;
    return;
  }
  float d[3] = {SKY[0], SKY[1], SKY[2]};
  float count = 1.0f;
  bool refl = false;
  if (h) {
    const V3 p = load3(pos, 0, n, i), nrm = load3(pn, 0, n, i);
    const float m = __ldg(metallic + i), att = attenuation[i];
    float att_up = att;
    if (reflections) {
      refl = m > METALLIC_THRESHOLD;
      const float new_att = att * (REFLECT_SCALE * m);
      att_up = refl ? new_att : att;
    }
    float total = 0.0f;
#pragma unroll
    for (int s = 0; s < NL; ++s) {
      const LightGeo g = light_geometry(lights, s, p);
      const float nd = dot3(nrm, g.dir);
      float mult = 1.0f;
      if (occ != nullptr) {
        const bool cast = nd > 0.0f;
        const size_t k = s * static_cast<size_t>(n) + i;
        mult = (cast && occ[k]) ? SHADOW_MULTIPLIER : 1.0f;
        count = count + (cast ? 1.0f : 0.0f);
      }
      total = total + (clamp01(nd) * g.power) * mult;
    }
    const float lit = total * att;
    const float keep = 1.0f - att_up;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float b = row(base, c, n, i);
      float hv = b * lit + b * AMBIENT;
      if (refl) hv = hv * keep;
      d[c] = 0.0f + hv;
    }
    if (refl) {
      attenuation[i] = att_up;
      // dirs is written here, so read without __ldg
      const float dv[3] = {dirs[i], dirs[n + i], dirs[2 * n + i]};
      const float k = dot3({dv[0], dv[1], dv[2]}, nrm) * 2.0f;
      const float nv[3] = {nrm.x, nrm.y, nrm.z}, pv[3] = {p.x, p.y, p.z};
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        dirs[c * n + i] = dv[c] - k * nv[c];
        origins[c * n + i] = pv[c];
      }
    }
  }
  if (out != nullptr) {
#pragma unroll
    for (int c = 0; c < 3; ++c) out[c * n + i] = d[c];
    out[3 * n + i] = count;
  } else {
#pragma unroll
    for (int c = 0; c < 3; ++c) accum[c * n + i] = accum[c * n + i] + d[c];
    ray_count[i] += static_cast<int>(count);
  }
  active[i] = refl;
}

inline int shade_blocks(int n) {
  return (n + SHADE_THREADS - 1) / SHADE_THREADS;
}

}  // namespace vkrt

// Plain C entry points (bound with ctypes). Every [Nb,128] array is passed
// as its [rows, n] buffer (n = Nb * 128, 36 * n < 2^31), masks as one byte
// a lane (torch.bool). Each returns cudaGetLastError() after its launch; no
// launch synchronises.

// active, hitm u8[n], u, v f32[n], attrs f32[36, n] -> out f32[6, n] (pos,
// uv, the slot's int32 bits), hit u8[n]; 0 where not hit.
extern "C" int vkrt_shade_interp(const uint8_t* active, const uint8_t* hitm,
                                 const float* u, const float* v,
                                 const float* attrs, int n, float* out,
                                 uint8_t* hit, void* stream) {
  using namespace vkrt;
  if (n > 0)
    shade_interp_kernel<<<shade_blocks(n), SHADE_THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        active, hitm, u, v, attrs, n, out, hit);
  return static_cast<int>(cudaGetLastError());
}

// hit u8[n], u, v, attrs, map_n f32[3, n], pos f32[3, n], lights f32[nl, 3]
// (0 <= nl <= 4) -> out f32[3 + (nl > 0) + 4 * nl * segments, n].
extern "C" int vkrt_shade_lights(const uint8_t* hit, const float* u,
                                 const float* v, const float* attrs,
                                 const float* map_n, const float* pos,
                                 const float* lights, int nl, int segments,
                                 int n, float* out, void* stream) {
  using namespace vkrt;
  if (nl < 0 || nl > MAX_LIGHTS) return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define VKRT_SHADE_LIGHTS(NL)                                             \
  shade_lights_kernel<NL><<<shade_blocks(n), SHADE_THREADS, 0, s>>>(      \
      hit, u, v, attrs, map_n, pos, lights, segments, n, out)
    switch (nl) {
      case 0: VKRT_SHADE_LIGHTS(0); break;
      case 1: VKRT_SHADE_LIGHTS(1); break;
      case 2: VKRT_SHADE_LIGHTS(2); break;
      case 3: VKRT_SHADE_LIGHTS(3); break;
      default: VKRT_SHADE_LIGHTS(4); break;
    }
#undef VKRT_SHADE_LIGHTS
  }
  return static_cast<int>(cudaGetLastError());
}

// See shade_combine_kernel; lights f32[nl, 3] (0 <= nl <= 4), occ u8[nl, n]
// or null, accum/ray_count or out null.
extern "C" int vkrt_shade_combine(uint8_t* active, const uint8_t* hitm,
                                  const float* base, const float* metallic,
                                  const float* pn, const float* pos,
                                  const float* lights, int nl,
                                  const uint8_t* occ, float* origins,
                                  float* dirs, float* attenuation,
                                  float* accum, int* ray_count, float* out,
                                  int reflections, int flat, int n,
                                  void* stream) {
  using namespace vkrt;
  if (nl < 0 || nl > MAX_LIGHTS) return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define VKRT_SHADE_COMBINE(NL)                                            \
  shade_combine_kernel<NL><<<shade_blocks(n), SHADE_THREADS, 0, s>>>(     \
      active, hitm, base, metallic, pn, pos, lights, occ, origins, dirs,  \
      attenuation, accum, ray_count, out, reflections, flat, n)
    switch (nl) {
      case 0: VKRT_SHADE_COMBINE(0); break;
      case 1: VKRT_SHADE_COMBINE(1); break;
      case 2: VKRT_SHADE_COMBINE(2); break;
      case 3: VKRT_SHADE_COMBINE(3); break;
      default: VKRT_SHADE_COMBINE(4); break;
    }
#undef VKRT_SHADE_COMBINE
  }
  return static_cast<int>(cudaGetLastError());
}
