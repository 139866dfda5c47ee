// kept_hist: diagonal histogram of the hits the m1b keep tables keep.
//
// Replaces: _kept_hist_kernel / kept_hist_pass
// (experiments/pallas_fused.py:461-548), the first stage of the
// redefine-diagonal (rdd) mode.  Output, per row b: h_d[b, j - i + H] sums
// the hit multiplicity (forward + reverse, 0..2) of every cell (i, j)
// kept by keep_d[b, j - i + H] | keep_a[b, j + i].  The intercept fit
// (intercept_z in engine/fused.py) reads absolute bins: bin - H is j - i
// exactly.  The entry point zeroes h_d with one cudaMemsetAsync on the
// launch's stream.
//
// Bound on the H100: integer ALU, as for hist: two lane-0 compares per
// eligible cell; the keep tables are read only on a hit.
//
// Design: walk.cuh's on-chip walk, with hist's strip-local diagonal
// histogram (strip + TCOLS - 1 int bins in shared memory) and the
// strip's bins of both keep tables beside it (stage_keep), so the rare
// path reads no global memory: a kept hit adds its multiplicity to its
// shared bin.  The nonzero bins are flushed with one integer atomic
// each, so the output is bitwise deterministic.
#include "walk.cuh"

using namespace vtw;

template <int LANES>
__global__ void __launch_bounds__(THREADS, TILE_BLOCKS) kept_hist_kernel(
    const unsigned* ch, const unsigned* cf, const unsigned* cd,
    const int* ms, const int* rlens, int H, int R, int k, int W,
    const uint8_t* keep_d, const uint8_t* keep_a, int* h_d, int strip) {
  extern __shared__ __align__(16) unsigned smem[];
  const Tile<LANES> t = tile<LANES>(smem, strip);
  Strip s;
  if (!strip_bounds_tile(s, ms, rlens, H, R, k, strip)) return;
  const int span = strip + TCOLS - 1;
  int* hd = (int*)t.own;
  uint8_t* keep = (uint8_t*)(hd + span);
  for (int x = threadIdx.x; x < span; x += THREADS) hd[x] = 0;
  stage_keep(s, strip, H, W, keep_d, keep_a, keep);
  stage_tile(s, t, ch, cf, cd, H, R);

  walk_tile(s, t, H, [&](int i, int j, int hf, int hr) {
    if (kept(s, strip, keep, i, j))
      atomicAdd(&hd[d_bin(s, strip, i, j)], hf + hr);
  });
  __syncthreads();
  // local d-bin x is j - i = x + j0 - s0 - (strip - 1), stored at + H
  int* row_d = h_d + (size_t)s.b * W + (s.j0 - s.s0 - (strip - 1) + H);
  for (int x = threadIdx.x; x < span; x += THREADS)
    if (hd[x]) atomicAdd(row_d + x, hd[x]);
}

// strip-local tables: the int histogram, then the keep-table bins
constexpr int KEPT_UNIT = sizeof(int) + KEEP_UNIT;

extern "C" int vt_kept_hist(const void* ch, const void* cf, const void* cd,
                            const void* ms, const void* rlens, int B,
                            int H, int R, int lanes, int k, int W,
                            const void* keep_d, const void* keep_a,
                            void* h_d, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(h_d, 0, (size_t)B * W * sizeof(int),
                          (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  VTW_LAUNCH_TILE(lanes, KEPT_UNIT, kept_hist_kernel, B, H, R, device,
                  (cudaStream_t)stream, (const unsigned*)ch,
                  (const unsigned*)cf, (const unsigned*)cd,
                  (const int*)ms, (const int*)rlens, H, R, k, W,
                  (const uint8_t*)keep_d, (const uint8_t*)keep_a,
                  (int*)h_d);
  return (int)cudaGetLastError();
}

extern "C" int vt_kept_hist_grid(int B, int H, int R, int lanes,
                                 int device, int* out) {
  if (lanes < 2 || lanes > 5) return (int)cudaErrorInvalidValue;
  const void* by_lanes[] = {
      (const void*)kept_hist_kernel<2>, (const void*)kept_hist_kernel<3>,
      (const void*)kept_hist_kernel<4>, (const void*)kept_hist_kernel<5>};
  return grid_info_tile(by_lanes[lanes - 2], B, H, R, lanes, KEPT_UNIT,
                        device, out);
}
