// hist: diagonal and anti-diagonal hit histograms plus the gate scalars.
//
// Replaces: _hist_kernel / hist_pass (experiments/pallas_fused.py:199-303)
// together with its rc-shift glue _combine_hists (:311-324).  Outputs,
// per row b: h_d[b, j - i + H] and h_a[b, j + i], each summing the hit
// multiplicity (forward + reverse, 0..2) of cell (i, j), and
// scal[b] = [forward hits, reverse hits, first hit row, last hit row].
// The wrapper zeroes h_d and h_a and sets scal to [0, 0, H + 1, -1].
//
// Bound on the H100: integer ALU.  Every eligible cell costs two lane-0
// equality compares (one a strand); the codes moved are
// (H + 2R) x lanes x 4 bytes per row, which is nothing next to H x R.
//
// Design: walk.cuh's register-blocked strip walk.  Reverse hits arrive
// already in dot space, so both strands share one pair of histograms
// and no rc shift is applied afterwards.  Each block bins its hits,
// which the rare path alone sees, into two strip-local shared
// histograms of strip + TCOLS - 1 bins (16 KB for both at most), so
// bins never need the whole row width W in shared memory at any bucket,
// and flushes only the nonzero bins with one global atomic each.
#include <limits.h>

#include "walk.cuh"

using namespace vtw;

template <int LANES>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS) hist_kernel(
    const unsigned* ch, const unsigned* cf, const unsigned* cd,
    const int* ms, const int* rlens, int H, int R, int k, int W,
    int* h_d, int* h_a, int* scal, int strip) {
  __shared__ __align__(16) unsigned sh[LANES][MAX_STRIP];
  __shared__ int hd[SPAN];
  __shared__ int ha[SPAN];
  Strip s;
  if (!strip_bounds(s, ms, rlens, H, R, k, strip)) return;
  const int span = strip + TCOLS - 1;
  for (int x = threadIdx.x; x < span; x += THREADS) hd[x] = ha[x] = 0;
  stage(s, sh, ch, cf, cd, H, R);

  int nf = 0, nr = 0, imin = INT_MAX, imax = -1;
  walk(s, sh, cf, cd, H, R, [&](int i, int j, int hf, int hr) {
    const int di = i - s.s0, dj = j - s.j0, mult = hf + hr;
    nf += hf;
    nr += hr;
    imin = min(imin, i);
    imax = max(imax, i);
    atomicAdd(&hd[dj - di + strip - 1], mult);
    atomicAdd(&ha[dj + di], mult);
  });
  nf = __reduce_add_sync(0xffffffffu, nf);
  nr = __reduce_add_sync(0xffffffffu, nr);
  imin = __reduce_min_sync(0xffffffffu, imin);
  imax = __reduce_max_sync(0xffffffffu, imax);
  if ((threadIdx.x & 31) == 0 && imax >= 0) {
    int* out = scal + 4 * s.b;
    atomicAdd(out + 0, nf);
    atomicAdd(out + 1, nr);
    atomicMin(out + 2, imin);
    atomicMax(out + 3, imax);
  }
  __syncthreads();
  // local d-bin x is j - i = x + j0 - s0 - (strip - 1), stored at + H;
  // local a-bin x is j + i = x + j0 + s0
  int* row_d = h_d + (size_t)s.b * W + (s.j0 - s.s0 - (strip - 1) + H);
  int* row_a = h_a + (size_t)s.b * W + (s.j0 + s.s0);
  for (int x = threadIdx.x; x < span; x += THREADS) {
    if (hd[x]) atomicAdd(row_d + x, hd[x]);
    if (ha[x]) atomicAdd(row_a + x, ha[x]);
  }
}

extern "C" int vt_hist(const void* ch, const void* cf, const void* cd,
                       const void* ms, const void* rlens, int B, int H,
                       int R, int lanes, int k, int W, void* h_d,
                       void* h_a, void* scal, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  VTW_LAUNCH_BY_LANES(lanes, hist_kernel, B, H, R, device,
                      (cudaStream_t)stream,
                      (const unsigned*)ch, (const unsigned*)cf,
                      (const unsigned*)cd, (const int*)ms,
                      (const int*)rlens, H, R, k, W, (int*)h_d,
                      (int*)h_a, (int*)scal);
  return (int)cudaGetLastError();
}

extern "C" int vt_hist_grid(int B, int H, int R, int lanes,
                            int device, int* out) {
  if (lanes < 2 || lanes > 5) return (int)cudaErrorInvalidValue;
  const void* by_lanes[] = {
      (const void*)hist_kernel<2>, (const void*)hist_kernel<3>,
      (const void*)hist_kernel<4>, (const void*)hist_kernel<5>};
  return grid_info(by_lanes[lanes - 2], B, H, R, device, out);
}
