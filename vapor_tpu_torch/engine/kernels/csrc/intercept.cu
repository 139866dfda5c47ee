// intercept: each row's most-abundant intercept, in exact integers.
//
// Replaces: intercept_z_device (vapor_tpu/engine/fused.py:509), which XLA
// fuses inside the JAX engine's jitted _fused_one (the redefine-diagonal
// mode); in the port, the torch-op sequence of kernels.intercept_z_plain,
// whose (B, 11, W) int64 intermediates this kernel never makes.  Input: a
// (B, W) int32 d-histogram whose bin x holds the value v = x - H.
// Output, per row b: found[b] and z[b] (int64, 0 where not found):
//
// * lo and hi are the least and greatest bin with a count (h > 0); a
//   bin's first-level bin is the number of t in 1..10 with
//   10 (x - lo) >= t (hi - lo) (all of them when hi == lo), and the
//   first level's counts sum h over each;
// * a first-level bin is binned again, between its own least and
//   greatest bin, into 11 sub-bins;
// * found iff the row's sum of h is positive and exactly one (winning
//   bin, winning sub-bin) pair exists: a winning bin has the largest
//   count of the first level, a winning sub-bin the largest of its bin;
// * z is v1 + v2, the values at ranks (n - 1) / 2 + 1 and n / 2 + 1 of
//   that sub-bin's n counted values, in increasing order.
//
// Bound on the H100: bytes (W x 4 bytes read; each pass does a few
// integer operations a bin).
//
// Design: one block per row.  Pass one reads the row (lo, hi, the sum);
// pass two bins [lo, hi] into the 11 first-level counts and each bin's
// least and greatest member, a thread's run of equal bins added with one
// shared-memory atomic; only a row with one winning bin goes on, and
// pass three bins that bin's range into its 11 sub-bins.  Only a row
// with one winning sub-bin takes pass four, a block sum-scan over the
// sub-bin's members that stops once both ranks are passed.  Every
// accumulation is integer; every row's outputs are written, so they need
// no zeroing.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int ITEMS = 8;
constexpr int CHUNK = THREADS * ITEMS;
constexpr int BINS = 11;
constexpr unsigned FULL = 0xFFFFFFFFu;

// exclusive block sum-scan of one value a thread; `total` gets the sum of
// every thread's value.  Every thread calls it.
__device__ long long block_sum_scan(long long v, long long* warp_buf,
                                    long long& total) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  long long x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const long long y = __shfl_up_sync(FULL, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_buf[wid] = x;
  __syncthreads();
  if (wid == 0) {
    long long s = lane < WARPS ? warp_buf[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const long long y = __shfl_up_sync(FULL, s, o);
      if (lane >= o) s += y;
    }
    if (lane < WARPS) warp_buf[lane] = s;
  }
  __syncthreads();
  const long long out = (wid ? warp_buf[wid - 1] : 0) + x - v;
  total = warp_buf[WARPS - 1];
  __syncthreads();
  return out;
}

// the bin 0..10 of offset d = x - lo in a range of span = hi - lo
__device__ __forceinline__ int bin_of(long long d, long long span) {
  int n = 0;
  for (int t = 1; t <= 10; ++t) n += 10 * d >= t * span;
  return n;
}

// the index (0..10) of the largest of 11 counts, or -1 when it is tied
__device__ int sole_winner(const long long* c) {
  long long mx = c[0];
  for (int t = 1; t < BINS; ++t) mx = c[t] > mx ? c[t] : mx;
  int at = -1, n = 0;
  for (int t = 0; t < BINS; ++t)
    if (c[t] == mx) {
      at = t;
      ++n;
    }
  return n == 1 ? at : -1;
}

__global__ void __launch_bounds__(THREADS) intercept_z_kernel(
    const int* hist, int W, int H, int B, long long* z_out,
    uint8_t* found_out) {
  __shared__ long long warp_buf[WARPS];
  __shared__ long long c1[BINS], c2[BINS];
  __shared__ int s_lo[BINS], s_hi[BINS];
  __shared__ int lo, hi, win1, win2, at1, at2;
  __shared__ long long row_sum;
  const int b = blockIdx.x;
  const int* h = hist + (size_t)b * W;
  if (threadIdx.x < BINS) {
    c1[threadIdx.x] = c2[threadIdx.x] = 0;
    s_lo[threadIdx.x] = INT32_MAX;
    s_hi[threadIdx.x] = -1;
  }
  if (threadIdx.x == 0) {
    lo = INT32_MAX;
    hi = -1;
    row_sum = 0;
    at1 = at2 = -1;
  }
  __syncthreads();

  // pass one: lo, hi and the row's sum
  {
    int my_lo = INT32_MAX, my_hi = -1;
    long long sum = 0;
    for (int x = threadIdx.x; x < W; x += THREADS) {
      const int v = h[x];
      sum += v;
      if (v > 0) {
        my_lo = min(my_lo, x);
        my_hi = max(my_hi, x);
      }
    }
    if (my_hi >= 0) {
      atomicMin(&lo, my_lo);
      atomicMax(&hi, my_hi);
    }
    if (sum) atomicAdd((unsigned long long*)&row_sum, (unsigned long long)sum);
  }
  __syncthreads();
  const bool any = row_sum > 0;
  const int xlo = lo, xhi = hi;
  const long long span = (long long)xhi - xlo;

  // pass two: the first level over [lo, hi]
  if (any) {
    for (int c0 = xlo - xlo % CHUNK; c0 <= xhi; c0 += CHUNK) {
      const int x0 = c0 + threadIdx.x * ITEMS;
      int cur = -1, first = 0, last = 0;
      long long run = 0;
      for (int i = 0; i < ITEMS; ++i) {
        const int x = x0 + i;
        if (x < xlo || x > xhi) continue;
        const int v = h[x];
        if (v <= 0) continue;
        const int t = bin_of(x - xlo, span);
        if (t != cur) {
          if (cur >= 0) {
            atomicAdd((unsigned long long*)&c1[cur], run);
            atomicMin(&s_lo[cur], first);
            atomicMax(&s_hi[cur], last);
          }
          cur = t;
          first = x;
          run = 0;
        }
        run += v;
        last = x;
      }
      if (cur >= 0) {
        atomicAdd((unsigned long long*)&c1[cur], run);
        atomicMin(&s_lo[cur], first);
        atomicMax(&s_hi[cur], last);
      }
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) win1 = any ? sole_winner(c1) : -1;
  __syncthreads();
  const int t1 = win1;

  // pass three: the winning bin's sub-bins
  if (t1 >= 0) {
    const int blo = s_lo[t1], bhi = s_hi[t1];
    const long long bspan = (long long)bhi - blo;
    for (int x = blo + threadIdx.x; x <= bhi; x += THREADS) {
      const int v = h[x];
      if (v <= 0 || bin_of(x - xlo, span) != t1) continue;
      atomicAdd((unsigned long long*)&c2[bin_of(x - blo, bspan)],
                (unsigned long long)v);
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) win2 = t1 >= 0 ? sole_winner(c2) : -1;
  __syncthreads();
  const int t2 = win2;

  // pass four: the two median ranks in the winning sub-bin
  if (t2 >= 0) {
    const int blo = s_lo[t1], bhi = s_hi[t1];
    const long long bspan = (long long)bhi - blo;
    const long long n = c2[t2];
    const long long r1 = (n - 1) / 2 + 1, r2 = n / 2 + 1;
    long long carry = 0;
    for (int c0 = blo - blo % CHUNK; c0 <= bhi && carry < r2;
         c0 += CHUNK) {
      const int x0 = c0 + threadIdx.x * ITEMS;
      int v[ITEMS];
      long long mine = 0;
      for (int i = 0; i < ITEMS; ++i) {
        const int x = x0 + i;
        v[i] = 0;
        if (x < blo || x > bhi) continue;
        const int c = h[x];
        if (c > 0 && bin_of(x - xlo, span) == t1 &&
            bin_of(x - blo, bspan) == t2)
          v[i] = c;
        mine += v[i];
      }
      long long chunk;
      long long before = carry + block_sum_scan(mine, warp_buf, chunk);
      for (int i = 0; i < ITEMS; ++i) {
        if (!v[i]) continue;
        const long long after = before + v[i];
        if (before < r1 && r1 <= after) at1 = x0 + i;
        if (before < r2 && r2 <= after) at2 = x0 + i;
        before = after;
      }
      carry += chunk;
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    found_out[b] = t2 >= 0;
    z_out[b] = t2 >= 0 ? (long long)(at1 - H) + (at2 - H) : 0;
  }
}

}  // namespace

extern "C" int vt_intercept_z(const void* h, int B, int W, int H, void* z,
                              void* found, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B == 0) return 0;
  intercept_z_kernel<<<B, THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)h, W, H, B, (long long*)z, (uint8_t*)found);
  return (int)cudaGetLastError();
}
