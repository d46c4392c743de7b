// Kernel H: one cut round of the device SAH build, in one launch.
//
// H replaces no Pallas kernel: the JAX package computes these passes in
// XLA (vkrt_tpu/accel/device_sah.py, `cut_round` :387 inside
// `_device_sah_order`, its scans `_seg_scan_box` :58), and the port's plain
// PyTorch version (vkrt_tpu_torch/accel/device_sah.py::_cut_round, the
// CPU path) runs them as two segmented scans of cummin / cummax over
// int64 keys plus about 170 small elementwise kernels a round. On the
// card PyTorch scans dim 0 of an [Nc, 3] tensor with one thread a column,
// so each scan walks Nc dependent elements on 3 threads; a per-frame
// rebuild runs 14 rounds.
//
// What bounds it on the H100: latency. At the per-frame rebuild's shape
// (Nc = 2,049 chunks) a round reads ~59 KB (a bit, two boxes and a count
// a chunk) and writes 2 KB, a fraction of a microsecond at 3.35 TB/s, and
// its arithmetic is a few dozen float operations a chunk. What costs is
// the chain of dependent steps of a scan and each launch's overhead.
//
// Design: one block of 1024 threads, one chunk a thread, tiles of 1024
// chunks in a loop inside the block (any Nc, no second launch). Pass 1
// scans the tiles from the last chunk back: a segmented inclusive scan
// of box min, box max (as order-preserving uint32 keys of the floats,
// the plain version's own comparison) and triangle count, by warp
// shuffles, then across the 32 warps in shared memory, then after the
// previous tile's carry. It stores each chunk's right cost
// area(suffix box) * suffix count, the suffix count and its segment's
// last chunk in `scratch`. Pass 2 scans forward the same way; the scan
// value one position back (the prefix before the cut) gives the left
// cost, and a valid cut's cost is left + right. A second segmented scan
// takes the minimum of (ordered cost bits << 32 | chunk index), so a tie
// goes to the lowest chunk, and the thread of each segment's last chunk
// sets the bit of that minimum if its cost is below `inf_cost`.
//
// Every product and sum is rounded as the plain version rounds it
// (__fmul_rn / __fadd_rn; with `fused` a product sum is computed in
// double and rounded to float once, as its torch.addcmul in float64), so
// the output equals the plain version's bit for bit. Counts are whole
// numbers below 2^24: an int32 sum is exact, as the plain float64 one is.
#include <cuda_runtime.h>
#include <stdint.h>

namespace vkrt {

constexpr int CUT_THREADS = 1024;
constexpr unsigned FULL_MASK = 0xffffffffu;

__device__ __forceinline__ unsigned ordered(float x) {
  const unsigned b = __float_as_uint(x);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float from_ordered(unsigned u) {
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

// A segmented scan value: the union box (ordered keys) and triangle count
// of a run of chunks since its last segment head, the index of that head
// (`start`) and whether the run holds one (`head`).
struct Box {
  unsigned mn0, mn1, mn2, mx0, mx1, mx2;
  int cnt, start, head;
};

// A segmented minimum of (ordered cost bits << 32 | chunk index).
struct Best {
  unsigned long long key;
  int head;
};

// The scans' identities: an empty run.
__device__ __forceinline__ Box empty_box() {
  return Box{FULL_MASK, FULL_MASK, FULL_MASK, 0u, 0u, 0u, 0, 0, 0};
}

__device__ __forceinline__ Best empty_best() { return Best{~0ull, 0}; }

// The scan of a run `a` followed by a run `b`.
__device__ __forceinline__ Box combine(const Box& a, const Box& b) {
  if (b.head) return b;
  return Box{min(a.mn0, b.mn0), min(a.mn1, b.mn1), min(a.mn2, b.mn2),
             max(a.mx0, b.mx0), max(a.mx1, b.mx1), max(a.mx2, b.mx2),
             a.cnt + b.cnt, a.start, a.head};
}

__device__ __forceinline__ Best combine(const Best& a, const Best& b) {
  if (b.head) return b;
  return Best{a.key < b.key ? a.key : b.key, a.head};
}

__device__ __forceinline__ Box shfl_up(const Box& v, int d) {
  return Box{__shfl_up_sync(FULL_MASK, v.mn0, d),
             __shfl_up_sync(FULL_MASK, v.mn1, d),
             __shfl_up_sync(FULL_MASK, v.mn2, d),
             __shfl_up_sync(FULL_MASK, v.mx0, d),
             __shfl_up_sync(FULL_MASK, v.mx1, d),
             __shfl_up_sync(FULL_MASK, v.mx2, d),
             __shfl_up_sync(FULL_MASK, v.cnt, d),
             __shfl_up_sync(FULL_MASK, v.start, d),
             __shfl_up_sync(FULL_MASK, v.head, d)};
}

__device__ __forceinline__ Best shfl_up(const Best& v, int d) {
  return Best{__shfl_up_sync(FULL_MASK, v.key, d),
              __shfl_up_sync(FULL_MASK, v.head, d)};
}

template <typename T>
__device__ __forceinline__ T warp_scan(T x, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const T y = shfl_up(x, d);
    if (lane >= d) x = combine(y, x);
  }
  return x;
}

// Inclusive segmented scan of one value a thread over the block's tile,
// after `*carry` (the scan at the end of the tiles before), which then
// becomes the scan at this tile's last position. `prev` gets the scan at
// the position before (the carry for thread 0). Every thread calls it.
template <typename T>
__device__ T block_scan(T x, T* warp_tot, T* carry, T& prev) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  x = warp_scan(x, lane);
  const T below = shfl_up(x, 1);
  if (lane == 31) warp_tot[warp] = x;
  __syncthreads();
  if (warp == 0) warp_tot[lane] = warp_scan(warp_tot[lane], lane);
  __syncthreads();
  T pre = *carry;
  if (warp > 0) pre = combine(pre, warp_tot[warp - 1]);
  prev = lane > 0 ? combine(pre, below) : pre;
  x = combine(pre, x);
  __syncthreads();                 // every thread has read carry, warp_tot
  if (threadIdx.x == CUT_THREADS - 1) *carry = x;
  return x;
}

__device__ __forceinline__ float fused_fma(float a, float b, float c) {
  return __double2float_rn(
      __dadd_rn(__dmul_rn((double)a, (double)b), (double)c));
}

__device__ __forceinline__ float extent(unsigned mx, unsigned mn) {
  const float e = __fsub_rn(from_ordered(mx), from_ordered(mn));
  return e < 0.0f ? 0.0f : e;      // clamp(max - min, 0): -inf of padding
}

// area(ext) * cnt as device_sah._area and _cut_round round it.
__device__ __forceinline__ float cost_of(const Box& b, bool fused) {
  const float e0 = extent(b.mx0, b.mn0), e1 = extent(b.mx1, b.mn1),
              e2 = extent(b.mx2, b.mn2);
  const float e12 = __fmul_rn(e1, e2);
  const float area =
      fused ? fused_fma(e2, e0, fused_fma(e0, e1, e12))
            : __fadd_rn(__fmul_rn(e2, e0), __fadd_rn(__fmul_rn(e0, e1), e12));
  return __fmul_rn(area, (float)b.cnt);
}

__device__ __forceinline__ Box load_box(const float* __restrict__ nmin,
                                        const float* __restrict__ nmax,
                                        const float* __restrict__ ncnt,
                                        int i, bool head) {
  return Box{ordered(nmin[3 * i]), ordered(nmin[3 * i + 1]),
             ordered(nmin[3 * i + 2]), ordered(nmax[3 * i]),
             ordered(nmax[3 * i + 1]), ordered(nmax[3 * i + 2]),
             __float2int_rz(ncnt[i]), i, head};
}

__global__ void __launch_bounds__(CUT_THREADS)
sah_cut_kernel(const uint8_t* __restrict__ cb,      // [nc] segment heads
               const float* __restrict__ nmin,      // [nc, 3]
               const float* __restrict__ nmax,      // [nc, 3]
               const float* __restrict__ ncnt,      // [nc] whole numbers
               int nc, int k2, float inf_cost, int fused,
               int* scratch,                        // [3, nc], this launch's
               uint8_t* out) {                      // [nc]
  __shared__ Box box_tot[32];
  __shared__ Best best_tot[32];
  __shared__ Box back_carry, fwd_carry;
  __shared__ Best best_carry;
  float* right_cost = reinterpret_cast<float*>(scratch);
  int* right_cnt = scratch + nc;
  int* seg_end = scratch + 2 * nc;
  if (threadIdx.x == 0) {
    back_carry = fwd_carry = empty_box();
    best_carry = empty_best();
  }
  __syncthreads();
  Box prev;

  // pass 1: suffix boxes and counts, from the last chunk back
  for (int base = 0; base < nc; base += CUT_THREADS) {
    const int i = nc - 1 - (base + (int)threadIdx.x);
    Box x = empty_box();
    if (i >= 0) x = load_box(nmin, nmax, ncnt, i, i == nc - 1 || cb[i + 1]);
    x = block_scan(x, box_tot, &back_carry, prev);
    if (i >= 0) {
      right_cost[i] = cost_of(x, fused);
      right_cnt[i] = x.cnt;
      seg_end[i] = x.start;
      out[i] = cb[i];
    }
  }
  __syncthreads();                 // scratch and out written for pass 2

  // pass 2: prefix boxes, each valid cut's cost, each segment's first
  // minimum
  for (int base = 0; base < nc; base += CUT_THREADS) {
    const int i = base + (int)threadIdx.x;
    const bool head = i == 0 || (i < nc && cb[i]);
    Box x = empty_box();
    if (i < nc) x = load_box(nmin, nmax, ncnt, i, head);
    x = block_scan(x, box_tot, &fwd_carry, prev);
    Best b = empty_best();
    int end = -1;
    if (i < nc) {
      end = seg_end[i];
      const int off = i - x.start, len = end - x.start + 1;
      const int align = len > k2 ? k2 : 1;
      float cut = inf_cost;
      if (off > 0 && off % align == 0 && prev.cnt > 0 && right_cnt[i] > 0)
        cut = __fadd_rn(cost_of(prev, fused), right_cost[i]);
      b = Best{((unsigned long long)ordered(cut) << 32) | (unsigned)i,
               (int)head};
    }
    Best unused;
    b = block_scan(b, best_tot, &best_carry, unused);
    if (i == end && from_ordered((unsigned)(b.key >> 32)) < inf_cost)
      out[(unsigned)(b.key & FULL_MASK)] = 1;
  }
}

}  // namespace vkrt

// Plain C entry point (bound with ctypes): returns cudaGetLastError()
// after the launch; the launch does not synchronise.
extern "C" int vkrt_sah_cut(const uint8_t* cb, const float* nmin,
                            const float* nmax, const float* ncnt, int nc,
                            int k2, float inf_cost, int fused, int* scratch,
                            uint8_t* out, void* stream) {
  if (nc > 0) {
    vkrt::sah_cut_kernel<<<1, vkrt::CUT_THREADS, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        cb, nmin, nmax, ncnt, nc, k2, inf_cost, fused, scratch, out);
  }
  return static_cast<int>(cudaGetLastError());
}
