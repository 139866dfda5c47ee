// hist: diagonal and anti-diagonal hit histograms plus the gate scalars,
// and the window refiner's self-stats route.
//
// Replaces: _hist_kernel / hist_pass (experiments/pallas_fused.py:199-303)
// together with its rc-shift glue _combine_hists (:311-324).  Outputs,
// per row b: h_d[b, j - i + H] and h_a[b, j + i], each summing the hit
// multiplicity (forward + reverse, 0..2) of cell (i, j), and
// scal[b] = [forward hits, reverse hits, first hit row - (H + 1), last
// hit row + 1], all 0 where the row has no hit: an encoding whose
// identity is zero, which kernels.hist_scal turns into [.., first hit
// row (H + 1 if none), last hit row (-1 if none)] with one add.  vt_hist
// takes them as one int32 buffer, [h_d (B x W) | h_a (B x W) | scal
// (B x 4)], and zeroes it with one cudaMemsetAsync on the launch's
// stream.
//
// The self-stats route (vt_hist_self: the window refiner's rows, each
// hap as its own read) reduces each row straight to [total, diag, below]:
// the hit multiplicity summed over every cell, over j == i (bin H of h_d)
// and over j < i (the bins below H), which is all the refiner reads of
// h_d (_self_stats_one, vapor_tpu/engine/window_device.py:45-66).  out
// (B x 3) int64, zeroed by the entry point.
//
// Bound on the H100: integer ALU.  Every eligible cell costs two lane-0
// equality compares (one a strand); the codes moved are
// (H + 2R) x lanes x 4 bytes per row, which is nothing next to H x R.
//
// Design: walk.cuh's on-chip walk.  Reverse hits arrive already in dot
// space, so both strands share one pair of histograms and no rc shift is
// applied afterwards.  Each block bins its hits, which the rare path
// alone sees, into two strip-local shared histograms of
// strip + TCOLS - 1 bins and flushes only the nonzero bins with one
// global atomic each; scal's rows combine by atomic min and max, so no
// output depends on block order.  The self-stats route keeps three sums,
// added a warp at a time in 64 bits.
#include <limits.h>

#include "walk.cuh"

using namespace vtw;

template <int LANES>
__global__ void __launch_bounds__(THREADS, TILE_BLOCKS) hist_kernel(
    const unsigned* ch, const unsigned* cf, const unsigned* cd,
    const int* ms, const int* rlens, int H, int R, int k, int W, int* out,
    int strip) {
  extern __shared__ __align__(16) unsigned smem[];
  const Tile<LANES> t = tile<LANES>(smem, strip);
  Strip s;
  if (!strip_bounds_tile(s, ms, rlens, H, R, k, strip)) return;
  const int span = strip + TCOLS - 1;
  int* hd = (int*)t.own;
  int* ha = hd + span;
  for (int x = threadIdx.x; x < span; x += THREADS) hd[x] = ha[x] = 0;
  stage_tile(s, t, ch, cf, cd, H, R);

  int nf = 0, nr = 0, imin = INT_MAX, imax = -1;
  walk_tile(s, t, H, [&](int i, int j, int hf, int hr) {
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
  const size_t rows = gridDim.z;
  if ((threadIdx.x & 31) == 0 && imax >= 0) {
    int* scal = out + 2 * rows * W + 4 * s.b;
    atomicAdd(scal + 0, nf);
    atomicAdd(scal + 1, nr);
    atomicMin(scal + 2, imin - (H + 1));
    atomicMax(scal + 3, imax + 1);
  }
  __syncthreads();
  // local d-bin x is j - i = x + j0 - s0 - (strip - 1), stored at + H;
  // local a-bin x is j + i = x + j0 + s0
  int* row_d = out + (size_t)s.b * W + (s.j0 - s.s0 - (strip - 1) + H);
  int* row_a = out + (rows + s.b) * W + (s.j0 + s.s0);
  for (int x = threadIdx.x; x < span; x += THREADS) {
    if (hd[x]) atomicAdd(row_d + x, hd[x]);
    if (ha[x]) atomicAdd(row_a + x, ha[x]);
  }
}

template <int LANES>
__global__ void __launch_bounds__(THREADS, TILE_BLOCKS) hist_self_kernel(
    const unsigned* ch, const unsigned* cf, const unsigned* cd,
    const int* ms, const int* rlens, int H, int R, int k,
    unsigned long long* out, int strip) {
  extern __shared__ __align__(16) unsigned smem[];
  const Tile<LANES> t = tile<LANES>(smem, strip);
  Strip s;
  if (!strip_bounds_tile(s, ms, rlens, H, R, k, strip)) return;
  stage_tile(s, t, ch, cf, cd, H, R);

  int total = 0, diag = 0, below = 0;
  walk_tile(s, t, H, [&](int i, int j, int hf, int hr) {
    const int mult = hf + hr;
    total += mult;
    diag += j == i ? mult : 0;
    below += j < i ? mult : 0;
  });
  unsigned long long* row = out + 3 * (size_t)s.b;
  warp_add(row + 0, total);
  warp_add(row + 1, diag);
  warp_add(row + 2, below);
}

// strip-local tables: the score route's two int histograms; none for the
// self-stats route
constexpr int HIST_UNIT = 2 * sizeof(int);
constexpr int SELF_UNIT = 0;

extern "C" int vt_hist(const void* ch, const void* cf, const void* cd,
                       const void* ms, const void* rlens, int B, int H,
                       int R, int lanes, int k, int W, void* out,
                       int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(out, 0, (2 * (size_t)W + 4) * B * sizeof(int),
                          (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  VTW_LAUNCH_TILE(lanes, HIST_UNIT, hist_kernel, B, H, R, device,
                  (cudaStream_t)stream, (const unsigned*)ch,
                  (const unsigned*)cf, (const unsigned*)cd,
                  (const int*)ms, (const int*)rlens, H, R, k, W,
                  (int*)out);
  return (int)cudaGetLastError();
}

extern "C" int vt_hist_self(const void* ch, const void* cf, const void* cd,
                            const void* ms, const void* rlens, int B,
                            int H, int R, int lanes, int k, void* out,
                            int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(out, 0, 3 * (size_t)B * sizeof(long long),
                          (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  VTW_LAUNCH_TILE(lanes, SELF_UNIT, hist_self_kernel, B, H, R, device,
                  (cudaStream_t)stream, (const unsigned*)ch,
                  (const unsigned*)cf, (const unsigned*)cd,
                  (const int*)ms, (const int*)rlens, H, R, k,
                  (unsigned long long*)out);
  return (int)cudaGetLastError();
}

extern "C" int vt_hist_grid(int B, int H, int R, int lanes, int device,
                            int* out) {
  if (lanes < 2 || lanes > 5) return (int)cudaErrorInvalidValue;
  const void* by_lanes[] = {
      (const void*)hist_kernel<2>, (const void*)hist_kernel<3>,
      (const void*)hist_kernel<4>, (const void*)hist_kernel<5>};
  return grid_info_tile(by_lanes[lanes - 2], B, H, R, lanes, HIST_UNIT,
                        device, out);
}

extern "C" int vt_hist_self_grid(int B, int H, int R, int lanes,
                                 int device, int* out) {
  if (lanes < 2 || lanes > 5) return (int)cudaErrorInvalidValue;
  const void* by_lanes[] = {
      (const void*)hist_self_kernel<2>, (const void*)hist_self_kernel<3>,
      (const void*)hist_self_kernel<4>, (const void*)hist_self_kernel<5>};
  return grid_info_tile(by_lanes[lanes - 2], B, H, R, lanes, SELF_UNIT,
                        device, out);
}
