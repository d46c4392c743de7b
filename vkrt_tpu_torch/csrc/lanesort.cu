// Kernels E and F: stable in-block lane sort and its inverse.
//
// E replaces the Pallas kernel vkrt_tpu/wavefront/lanesort.py
// ::_lane_sort_kernel (:79, entry lane_sort :128); F replaces
// ::_lane_unsort_kernel (:162, entry lane_unsort :179).
//
// What bounds them on the H100: memory. E reads each channel value and
// key once and writes each value and rank once (at 1080p the packed
// depth-1 prefix is 510 blocks of 1024 lanes, 4 channels: 20.9 MB,
// ~6 us at 3.35 TB/s); a sort of 1024 keys in shared memory is cheap
// beside that if every thread does O(1) work a digit. F is a gather,
// bound by memory (4 mask channels of the same prefix).
//
// Design: E runs one CUDA block per sort block of R = blockDim.x lanes
// (128-1024), one thread per lane, and sorts the block's keys by a
// stable least-significant-digit radix sort in shared memory, 8 bits a
// pass. The pass count comes from the OR of the block's keys (the
// engine's keys are below 2**18 + 1: 3 passes; an all-zero block takes
// none); a negative key flips every key's sign bit and takes 4 passes,
// so any int32 key sorts as torch.sort does. A pass ranks each key in
// two steps: inside its warp by __match_any_sync on the digit (lanes
// below it with the same digit), across the block by an exclusive scan
// of the (digit, warp) counts in digit-major order (each thread scans 8
// consecutive counts, then a warp-shuffle scan of the thread sums).
// Keys of equal digit keep their order, so the sort is stable by
// construction: equal keys keep lane order, the rule of lane_sort_plain.
// After the last pass thread t holds the lane `src` that lands at
// position t: it writes rank[src] = t and out[:, t] = x[:, src], so the
// stores are coalesced and the loads gather inside one 4 KB span. The
// TPU kernel built the permutation as one-hot matmuls from an O(R)
// compare count; here a store moves a value.
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
#include <stdint.h>

namespace vkrt {

constexpr int RADIX_BITS = 8;
constexpr int DIGITS = 1 << RADIX_BITS;
constexpr int MAX_WARPS = 32;                     // R = 1024
constexpr int SCAN_PER_THREAD = DIGITS / 32;      // counts a thread scans

// Exclusive block-wide prefix sum of one value a thread (`wsum`: the
// warps' totals). Every thread must call it.
__device__ __forceinline__ int block_exclusive_scan(int v, int* wsum) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  int inc = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int up = __shfl_up_sync(0xffffffffu, inc, d);
    if (lane >= d) inc += up;
  }
  if (lane == 31) wsum[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    int w = lane < nwarps ? wsum[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int up = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w += up;
    }
    if (lane < nwarps) wsum[lane] = w;           // inclusive over warps
  }
  __syncthreads();
  return inc - v + (warp > 0 ? wsum[warp - 1] : 0);
}

__global__ void __launch_bounds__(1024)
lane_sort_kernel(const float* __restrict__ x,     // [c, n]
                 const int* __restrict__ key,     // [n]
                 int c, int n, float* __restrict__ out,  // [c, n]
                 int* __restrict__ rank) {        // [n]
  // (digit, warp) counts, digit-major: count[d * nwarps + w]
  __shared__ __align__(16) int count[DIGITS * MAX_WARPS];
  __shared__ uint32_t s_key[1024];
  __shared__ short s_src[1024];
  __shared__ int wsum[MAX_WARPS];
  __shared__ uint32_t s_or;
  const int R = blockDim.x, t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5, nwarps = R >> 5;
  const unsigned below = (1u << lane) - 1u;
  const size_t base = (size_t)blockIdx.x * R;
  uint32_t k = (uint32_t)key[base + t];
  int src = t;

  if (t == 0) s_or = 0;
  __syncthreads();
  const uint32_t wor = __reduce_or_sync(0xffffffffu, k);
  if (lane == 0) atomicOr(&s_or, wor);
  __syncthreads();
  const uint32_t all = s_or;
  int passes = (32 - __clz(all) + RADIX_BITS - 1) / RADIX_BITS;
  if (all >> 31) {                 // a negative key: order as signed
    k ^= 0x80000000u;
    passes = 32 / RADIX_BITS;
  }

  // thread t scans SCAN_PER_THREAD consecutive counts (DIGITS x nwarps
  // = 8 R of them)
  int4* mine = reinterpret_cast<int4*>(count + t * SCAN_PER_THREAD);
  for (int p = 0; p < passes; ++p) {
    const uint32_t d = (k >> (p * RADIX_BITS)) & (DIGITS - 1);
    // (the previous pass read every count before its last barrier)
    mine[0] = mine[1] = make_int4(0, 0, 0, 0);
    __syncthreads();
    const unsigned peers = __match_any_sync(0xffffffffu, d);
    const int in_warp = __popc(peers & below);
    if (in_warp == 0) count[d * nwarps + warp] = __popc(peers);
    __syncthreads();
    const int4 a = mine[0], b = mine[1];
    int run = block_exclusive_scan(
        a.x + a.y + a.z + a.w + b.x + b.y + b.z + b.w, wsum);
    int4 ea, eb;
    ea.x = run; run += a.x;
    ea.y = run; run += a.y;
    ea.z = run; run += a.z;
    ea.w = run; run += a.w;
    eb.x = run; run += b.x;
    eb.y = run; run += b.y;
    eb.z = run; run += b.z;
    eb.w = run;
    mine[0] = ea;
    mine[1] = eb;
    __syncthreads();
    const int pos = count[d * nwarps + warp] + in_warp;
    s_key[pos] = k;
    s_src[pos] = (short)src;
    __syncthreads();
    k = s_key[t];
    src = s_src[t];
  }

  rank[base + src] = t;
  for (int ch = 0; ch < c; ++ch)
    out[(size_t)ch * n + base + t] = x[(size_t)ch * n + base + src];
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
    vkrt::lane_sort_kernel<<<n / block, block, 0,
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
