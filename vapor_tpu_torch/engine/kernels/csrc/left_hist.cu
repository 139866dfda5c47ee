// left_hist: anti-diagonal histogram of the hits the d-table drops.
//
// Replaces: _left_hist_kernel / left_hist_pass
// (experiments/pallas_fused.py:371-454), the second stage of the
// within-10% cleaning.  Output, per row b: h_a[b, j + i] sums the hit
// multiplicity of every cell (i, j) whose diagonal bin j - i + H is NOT
// set in keep_d[b] (the 50-threshold diagonal keep table).  The entry
// point zeroes h_a with one cudaMemsetAsync on the launch's stream.
//
// Bound on the H100: integer ALU, as for hist: two lane-0 compares per
// eligible cell; the keep table is read only on a hit.
//
// Design: walk.cuh's on-chip walk, with hist's strip-local anti-diagonal
// histogram (strip + TCOLS - 1 int bins in shared memory) and the
// strip's d-bins of keep_d beside it (stage_keep with no a-table), so
// the rare path reads no global memory and the (H, R) keep mask is never
// formed: a hit whose d-bin is dropped adds its multiplicity to its
// shared a-bin.  The nonzero bins are flushed with one integer atomic
// each, so the output is bitwise deterministic.
#include "walk.cuh"

using namespace vtw;

template <int LANES>
__global__ void __launch_bounds__(THREADS, TILE_BLOCKS) left_hist_kernel(
    const unsigned* ch, const unsigned* cf, const unsigned* cd,
    const int* ms, const int* rlens, int H, int R, int k, int W,
    const uint8_t* keep_d, int* h_a, int strip) {
  extern __shared__ __align__(16) unsigned smem[];
  const Tile<LANES> t = tile<LANES>(smem, strip);
  Strip s;
  if (!strip_bounds_tile(s, ms, rlens, H, R, k, strip)) return;
  const int span = strip + TCOLS - 1;
  int* ha = (int*)t.own;
  uint8_t* keep = (uint8_t*)(ha + span);
  for (int x = threadIdx.x; x < span; x += THREADS) ha[x] = 0;
  stage_keep(s, strip, H, W, keep_d, nullptr, keep);
  stage_tile(s, t, ch, cf, cd, H, R);

  walk_tile(s, t, H, [&](int i, int j, int hf, int hr) {
    if (!keep[d_bin(s, strip, i, j)])
      atomicAdd(&ha[(j - s.j0) + (i - s.s0)], hf + hr);
  });
  __syncthreads();
  // local a-bin x is j + i = x + j0 + s0
  int* row_a = h_a + (size_t)s.b * W + (s.j0 + s.s0);
  for (int x = threadIdx.x; x < span; x += THREADS)
    if (ha[x]) atomicAdd(row_a + x, ha[x]);
}

// strip-local tables: the int histogram, then the d-table's bins
constexpr int LEFT_UNIT = sizeof(int) + 1;

extern "C" int vt_left_hist(const void* ch, const void* cf, const void* cd,
                            const void* ms, const void* rlens, int B,
                            int H, int R, int lanes, int k, int W,
                            const void* keep_d, void* h_a, int device,
                            void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(h_a, 0, (size_t)B * W * sizeof(int),
                          (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  VTW_LAUNCH_TILE(lanes, LEFT_UNIT, left_hist_kernel, B, H, R, device,
                  (cudaStream_t)stream, (const unsigned*)ch,
                  (const unsigned*)cf, (const unsigned*)cd,
                  (const int*)ms, (const int*)rlens, H, R, k, W,
                  (const uint8_t*)keep_d, (int*)h_a);
  return (int)cudaGetLastError();
}

extern "C" int vt_left_hist_grid(int B, int H, int R, int lanes,
                                 int device, int* out) {
  if (lanes < 2 || lanes > 5) return (int)cudaErrorInvalidValue;
  const void* by_lanes[] = {
      (const void*)left_hist_kernel<2>, (const void*)left_hist_kernel<3>,
      (const void*)left_hist_kernel<4>, (const void*)left_hist_kernel<5>};
  return grid_info_tile(by_lanes[lanes - 2], B, H, R, lanes, LEFT_UNIT,
                        device, out);
}
