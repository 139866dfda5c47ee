// hist: diagonal and anti-diagonal hit histograms plus the gate scalars.
//
// Replaces: _hist_kernel / hist_pass (experiments/pallas_fused.py:199-303)
// together with its rc-shift glue _combine_hists (:311-324).  Outputs,
// per row b: h_d[b, j - i + H] and h_a[b, j + i], each summing the hit
// multiplicity (forward + reverse, 0..2) of cell (i, j), and
// scal[b] = [forward hits, reverse hits, first hit row, last hit row].
// The wrapper zeroes h_d and h_a and sets scal to [0, 0, H + 1, -1].
//
// Bound on the H100: integer ALU.  Every eligible cell costs 2 strands x
// lanes equality compares (in the worst case); the codes moved are
// (H + 2R) x lanes x 4 bytes per row, which is nothing next to H x R.
//
// Design: see hits.cuh for the tile walk.  Reverse hits arrive already in
// dot space, so both strands share one pair of histograms and no rc
// shift is applied afterwards.  Each block bins into two tile-local
// shared histograms of TH + TC - 1 bins (3 KB), so bins never need the
// whole row width W in shared memory at any bucket, and flushes only the
// nonzero bins with one global atomic each.
#include <limits.h>

#include "hits.cuh"

using namespace vt;

template <int LANES>
__global__ void __launch_bounds__(TC) hist_kernel(
    const unsigned* ch, const unsigned* cf, const unsigned* cd,
    const int* ms, const int* rlens, int H, int R, int k, int W,
    int* h_d, int* h_a, int* scal) {
  __shared__ unsigned sh[LANES][TH];
  __shared__ int hd[SPAN];
  __shared__ int ha[SPAN];
  Tile<LANES> t;
  if (!load_tile(t, sh, ch, cf, cd, ms, rlens, H, R, k)) return;
  for (int x = threadIdx.x; x < SPAN; x += TC) hd[x] = ha[x] = 0;
  __syncthreads();

  const int dj = t.j - t.j0;
  int nf = 0, nr = 0, imin = INT_MAX, imax = -1;
  for_each_hit(t, sh, [&](int i, int hf, int hr) {
    const int di = i - t.i0, mult = hf + hr;
    nf += hf;
    nr += hr;
    imin = min(imin, i);
    imax = max(imax, i);
    atomicAdd(&hd[dj - di + TH - 1], mult);
    atomicAdd(&ha[dj + di], mult);
  });
  nf = __reduce_add_sync(0xffffffffu, nf);
  nr = __reduce_add_sync(0xffffffffu, nr);
  imin = __reduce_min_sync(0xffffffffu, imin);
  imax = __reduce_max_sync(0xffffffffu, imax);
  if ((threadIdx.x & 31) == 0 && imax >= 0) {
    int* s = scal + 4 * t.b;
    atomicAdd(s + 0, nf);
    atomicAdd(s + 1, nr);
    atomicMin(s + 2, imin);
    atomicMax(s + 3, imax);
  }
  __syncthreads();
  // local d-bin x is j - i = x + j0 - i0 - (TH - 1), stored at + H
  flush_hist(h_d + (size_t)t.b * W, t.j0 - t.i0 - (TH - 1) + H, hd);
  flush_hist(h_a + (size_t)t.b * W, t.j0 + t.i0, ha);
}

extern "C" int vt_hist(const void* ch, const void* cf, const void* cd,
                       const void* ms, const void* rlens, int B, int H,
                       int R, int lanes, int k, int W, void* h_d,
                       void* h_a, void* scal, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  VT_LAUNCH_BY_LANES(lanes, hist_kernel, B, H, R, (cudaStream_t)stream,
                     (const unsigned*)ch, (const unsigned*)cf,
                     (const unsigned*)cd, (const int*)ms,
                     (const int*)rlens, H, R, k, W, (int*)h_d, (int*)h_a,
                     (int*)scal);
  return (int)cudaGetLastError();
}
