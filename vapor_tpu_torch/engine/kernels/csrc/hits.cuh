// Tile walk shared by the four dot-plot kernels (hist, left_hist, moment,
// moment2).
//
// A (read, haplotype) row is an H x R grid of cells (i, j): hap k-mer i
// against read k-mer j.  Cell (i, j) holds a forward hit when the packed
// hap codes of i equal the packed forward read codes of j, and a reverse
// hit when they equal the reverse-complement codes that rc_dot_codes
// (engine/fused.py) has already put into dot-space column j.  Each k-mer
// is `LANES` 32-bit words of eight 4-bit symbols, so a compare is LANES
// integer equalities.  A cell is eligible when i >= m (the read's missing
// prefix) and j <= rlen - k (past that, the read window reaches the
// READ_PAD tail, which no hap code holds, so neither strand can hit).
//
// One block covers TH hap rows x TC read columns of one row b: thread x
// owns column j0 + x, keeps that column's codes of both strands in
// registers, and walks the TH rows, whose hap codes sit in shared memory
// and are read as warp-wide broadcasts.  Lane 0 of the codes settles
// almost every cell, so the per-cell work is one shared load and two
// compares; the other lanes are read only after a lane-0 match.  All
// accumulation is integer, so every output is independent of the order
// in which the atomics land.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace vt {

constexpr int TC = 256;            // read columns per block, one per thread
constexpr int TH = 128;            // hap rows per block
constexpr int SPAN = TH + TC - 1;  // distinct j - i (and j + i) in a tile

template <int LANES>
struct Tile {
  int b, i0, j0, j, m;
  int i_begin, i_end;  // rows scanned: [max(i0, m), min(i0 + TH, H))
  bool col_ok;         // column j holds eligible cells
  unsigned f[LANES];   // forward read codes of column j
  unsigned r[LANES];   // reverse-strand codes of column j, dot space
};

// Loads the block's hap codes into shared memory and the thread's column
// codes into registers.  Returns false, for the whole block alike, when
// the tile holds no eligible cell; such blocks exit without a barrier.
template <int LANES>
__device__ __forceinline__ bool load_tile(
    Tile<LANES>& t, unsigned (&sh)[LANES][TH], const unsigned* ch,
    const unsigned* cf, const unsigned* cd, const int* ms,
    const int* rlens, int H, int R, int k) {
  t.b = blockIdx.z;
  t.i0 = blockIdx.y * TH;
  t.j0 = blockIdx.x * TC;
  t.j = t.j0 + threadIdx.x;
  t.m = ms[t.b];
  const int j_last = min(rlens[t.b] - k, R - 1);
  t.i_begin = max(t.i0, t.m);
  t.i_end = min(t.i0 + TH, H);
  if (t.j0 > j_last || t.i_begin >= t.i_end) return false;
  t.col_ok = t.j <= j_last;
  for (int x = threadIdx.x; x < LANES * TH; x += TC) {
    const int lane = x / TH, row = x % TH, i = t.i0 + row;
    sh[lane][row] =
        i < H ? ch[((size_t)t.b * LANES + lane) * H + i] : 0u;
  }
#pragma unroll
  for (int lane = 0; lane < LANES; ++lane) {
    const size_t at = ((size_t)t.b * LANES + lane) * R + t.j;
    t.f[lane] = t.col_ok ? cf[at] : 0u;
    t.r[lane] = t.col_ok ? cd[at] : 0u;
  }
  __syncthreads();
  return true;
}

// Calls visit(i, hf, hr) for each cell (i, j) of the thread's column with
// a hit on either strand; hf and hr are 0 or 1.
template <int LANES, class Visit>
__device__ __forceinline__ void for_each_hit(
    const Tile<LANES>& t, unsigned (&sh)[LANES][TH], Visit&& visit) {
  if (!t.col_ok) return;
#pragma unroll 4
  for (int i = t.i_begin; i < t.i_end; ++i) {
    const int row = i - t.i0;
    const unsigned h0 = sh[0][row];
    bool hf = h0 == t.f[0];
    bool hr = h0 == t.r[0];
    if (hf || hr) {
#pragma unroll
      for (int lane = 1; lane < LANES; ++lane) {
        const unsigned h = sh[lane][row];
        hf = hf && h == t.f[lane];
        hr = hr && h == t.r[lane];
      }
      if (hf || hr) visit(i, (int)hf, (int)hr);
    }
  }
}

// Adds v over the warp to *out with one atomic from lane 0.  Every lane
// of the warp must call it.
__device__ __forceinline__ void warp_add(unsigned long long* out,
                                         unsigned long long v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  if ((threadIdx.x & 31) == 0 && v) atomicAdd(out, v);
}

// Adds a tile-local histogram to the row's global one.  Local bin x holds
// the global bin base + x; only bins that some cell reached are nonzero,
// and those lie inside the row's [0, W).
__device__ __forceinline__ void flush_hist(int* row, int base,
                                           const int* local) {
  for (int x = threadIdx.x; x < SPAN; x += TC)
    if (local[x]) atomicAdd(row + (base + x), local[x]);
}

}  // namespace vt

// Instantiates KERNEL for the lane count of k (2..5 words for k = 10..40)
// and launches it on the tile grid of B rows.
#define VT_LAUNCH_BY_LANES(lanes, KERNEL, B, H, R, stream, ...)          \
  do {                                                                   \
    const dim3 grid_((R + vt::TC - 1) / vt::TC, (H + vt::TH - 1) / vt::TH, \
                     B);                                                 \
    switch (lanes) {                                                     \
      case 2: KERNEL<2><<<grid_, vt::TC, 0, stream>>>(__VA_ARGS__); break; \
      case 3: KERNEL<3><<<grid_, vt::TC, 0, stream>>>(__VA_ARGS__); break; \
      case 4: KERNEL<4><<<grid_, vt::TC, 0, stream>>>(__VA_ARGS__); break; \
      case 5: KERNEL<5><<<grid_, vt::TC, 0, stream>>>(__VA_ARGS__); break; \
      default: return (int)cudaErrorInvalidValue;                        \
    }                                                                    \
  } while (0)
