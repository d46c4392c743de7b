// Kernels E and F: stable in-block lane sort and its inverse.
//
// E replaces the Pallas kernel vkrt_tpu/wavefront/lanesort.py
// ::_lane_sort_kernel (:79, entry lane_sort :128); F replaces
// ::_lane_unsort_kernel (:162, entry lane_unsort :179).
//
// What bounds them on the H100: E is bound by its compares. Each lane's
// stable rank is #{keys < its key} + #{equal keys at a lower lane}, R
// compares per lane: at 1080p the packed depth-1 prefix is 510 blocks of
// 1024 lanes, 535M compares, against ~26 MB of channel traffic. F is a
// gather, bound by memory (4 mask channels of the same prefix).
//
// Design: E runs one CUDA block per sort block of R = blockDim.x lanes
// (512 or 1024), one thread per lane. The block's keys go into shared
// memory once; every thread then walks them in the same order, so each
// 16-byte shared load is a broadcast to the whole warp (no bank
// conflicts), and the rank is exact integer counting. The thread then
// stores its lane's channels at the rank (a permutation inside the block,
// so the stores of a block land in one 4 KB span per channel) and writes
// the rank in ORIGINAL lane order. The TPU kernel built the permutation as
// one-hot matmuls because its vector unit cannot scatter; here a store
// does.
//
// F moves 4 bytes in and 4 out per lane and channel plus the rank, a few
// microseconds of memory traffic at the main path's shape (19 MB), so what
// it can lose is time per instruction and bytes in flight, not bandwidth.
// One thread takes four consecutive lanes (n is a multiple of 128, so a
// quad never straddles a block): one 16-byte load of their ranks, then for
// up to four channels at a time all 16 gathers before any store (they land
// in the block's 2-4 KB span per channel, so they hit the same few lines),
// then one 16-byte store a channel: a quarter of the threads, rank loads
// and stores of a lane-per-thread kernel, and 16 independent loads in
// flight a thread. out[s, j] = res[s, base + rank[j]]; a rank outside
// [0, R) (never made by E) reads nothing and gives 0.
#include <cuda_runtime.h>

namespace vkrt {

__global__ void __launch_bounds__(1024)
lane_sort_kernel(const float* __restrict__ x,     // [c, n]
                 const int* __restrict__ key,     // [n]
                 int c, int n, float* __restrict__ out,  // [c, n]
                 int* __restrict__ rank) {        // [n]
  extern __shared__ int4 keys4[];                  // R keys
  int* keys = reinterpret_cast<int*>(keys4);
  const int R = blockDim.x;
  const int j = threadIdx.x;
  const size_t base = (size_t)blockIdx.x * R;
  const int k = key[base + j];
  keys[j] = k;
  __syncthreads();

  int r = 0;
  for (int q = 0; q < R / 4; ++q) {
    int4 v = keys4[q];
    int i = 4 * q;
    r += (v.x < k) | ((v.x == k) & (i + 0 < j));
    r += (v.y < k) | ((v.y == k) & (i + 1 < j));
    r += (v.z < k) | ((v.z == k) & (i + 2 < j));
    r += (v.w < k) | ((v.w == k) & (i + 3 < j));
  }
  rank[base + j] = r;
  for (int ch = 0; ch < c; ++ch)
    out[(size_t)ch * n + base + r] = x[(size_t)ch * n + base + j];
}

__global__ void __launch_bounds__(256)
lane_unsort_kernel(const float* __restrict__ res,  // [s, n] sorted order
                   const int4* __restrict__ rank,  // [n / 4] lane quads
                   int s, int n, int R, float4* __restrict__ out) {  // [s, n/4]
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  const int nq = n >> 2;
  if (q >= nq) return;
  const int i = q << 2;
  const int4 r = __ldg(rank + q);
  const bool ok0 = (unsigned)r.x < (unsigned)R, ok1 = (unsigned)r.y < (unsigned)R;
  const bool ok2 = (unsigned)r.z < (unsigned)R, ok3 = (unsigned)r.w < (unsigned)R;
  const float* src = res + (i - i % R);            // the quad's sort block
  for (int ch0 = 0; ch0 < s; ch0 += 4) {
    float4 v[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (ch0 + c < s) {
        const float* p = src + (size_t)(ch0 + c) * n;
        v[c].x = ok0 ? __ldg(p + r.x) : 0.0f;
        v[c].y = ok1 ? __ldg(p + r.y) : 0.0f;
        v[c].z = ok2 ? __ldg(p + r.z) : 0.0f;
        v[c].w = ok3 ? __ldg(p + r.w) : 0.0f;
      }
    }
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (ch0 + c < s) out[(size_t)(ch0 + c) * nq + q] = v[c];
  }
}

}  // namespace vkrt

static bool bad_block(int n, int block) {
  return block < 128 || block > 1024 || block % 128 != 0 || n % block != 0;
}

// Plain C entry points (bound with ctypes). Each returns cudaGetLastError()
// after its launch (cudaErrorInvalidValue for a block the kernels do not
// take); the launch does not synchronise.
extern "C" int vkrt_lane_sort(const float* x, const int* key, int c, int n,
                              int block, float* out, int* rank, void* stream) {
  if (bad_block(n, block)) return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0) {
    vkrt::lane_sort_kernel<<<n / block, block, block * sizeof(int),
                             static_cast<cudaStream_t>(stream)>>>(
        x, key, c, n, out, rank);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int vkrt_lane_unsort(const float* res, const int* rank, int s,
                                int n, int block, float* out, void* stream) {
  if (bad_block(n, block)) return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0 && s > 0) {
    const int threads = 256, quads = n / 4;   // block % 128 == 0 divides n
    vkrt::lane_unsort_kernel<<<(quads + threads - 1) / threads, threads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
        res, reinterpret_cast<const int4*>(rank), s, n, block,
        reinterpret_cast<float4*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
