// moment: masked moments over the kept hits of one keep-table pair.
//
// Replaces: _moment_kernel / moment_pass
// (experiments/pallas_fused.py:663-759), the moment stage of modes m1b
// and w10.  A cell (i, j) is kept when keep_d[b, j - i + H] or
// keep_a[b, j + i] is set.  With i' = i - m and d = j - i', output row
// mom[b] = [sum of mult, sum of mult * |d|, sum of mult over cells with
// i' > 0 and 25|d| < 4i' (only when want_w10)] over kept cells, mult
// being the cell's hit multiplicity (0..2).  The entry point zeroes mom
// with one cudaMemsetAsync on the launch's stream.
//
// Bound on the H100: integer ALU: two lane-0 compares per eligible
// cell; the keep-table reads and the moment work run on hits only.
//
// Design: walk.cuh's on-chip walk, as rdd_moment without the selection
// block: each block stages its strip's bins of both keep tables
// (stage_keep) beside the tile, so the rare path reads no global memory
// and the (H, R) keep mask is never formed; want_w10 is read there too.
// The keep bins are indexed by i, the moments by i' = i - m.  Sums are
// 64-bit (sum |d| reaches ~H R (H + R), past 2^31 at large buckets),
// reduced over each warp and added with one atomic per warp and output,
// so the result is bitwise deterministic.
#include "walk.cuh"

using namespace vtw;

template <int LANES>
__global__ void __launch_bounds__(THREADS, TILE_BLOCKS) moment_kernel(
    const unsigned* ch, const unsigned* cf, const unsigned* cd,
    const int* ms, const int* rlens, int H, int R, int k, int W,
    const uint8_t* keep_d, const uint8_t* keep_a, int want_w10,
    unsigned long long* mom, int strip) {
  extern __shared__ __align__(16) unsigned smem[];
  const Tile<LANES> t = tile<LANES>(smem, strip);
  Strip s;
  if (!strip_bounds_tile(s, ms, rlens, H, R, k, strip)) return;
  uint8_t* keep = (uint8_t*)t.own;
  stage_keep(s, strip, H, W, keep_d, keep_a, keep);
  stage_tile(s, t, ch, cf, cd, H, R);

  const int m = ms[s.b];
  unsigned long long cnt = 0, sum_absd = 0, w10 = 0;
  walk_tile(s, t, H, [&](int i, int j, int hf, int hr) {
    if (kept(s, strip, keep, i, j)) {
      const int mult = hf + hr, ip = i - m, ad = abs(j - ip);
      cnt += mult;
      sum_absd += (unsigned long long)(mult * ad);
      if (want_w10 && ip > 0 && 25 * ad < 4 * ip) w10 += mult;
    }
  });
  unsigned long long* out = mom + 3 * (size_t)s.b;
  warp_add(out + 0, cnt);
  warp_add(out + 1, sum_absd);
  warp_add(out + 2, w10);
}

extern "C" int vt_moment(const void* ch, const void* cf, const void* cd,
                         const void* ms, const void* rlens, int B, int H,
                         int R, int lanes, int k, int W, const void* keep_d,
                         const void* keep_a, int want_w10, void* mom,
                         int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(mom, 0, 3 * (size_t)B * sizeof(long long),
                          (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  VTW_LAUNCH_TILE(lanes, KEEP_UNIT, moment_kernel, B, H, R, device,
                  (cudaStream_t)stream, (const unsigned*)ch,
                  (const unsigned*)cf, (const unsigned*)cd,
                  (const int*)ms, (const int*)rlens, H, R, k, W,
                  (const uint8_t*)keep_d, (const uint8_t*)keep_a,
                  want_w10, (unsigned long long*)mom);
  return (int)cudaGetLastError();
}

extern "C" int vt_moment_grid(int B, int H, int R, int lanes, int device,
                              int* out) {
  if (lanes < 2 || lanes > 5) return (int)cudaErrorInvalidValue;
  const void* by_lanes[] = {
      (const void*)moment_kernel<2>, (const void*)moment_kernel<3>,
      (const void*)moment_kernel<4>, (const void*)moment_kernel<5>};
  return grid_info_tile(by_lanes[lanes - 2], B, H, R, lanes, KEEP_UNIT,
                        device, out);
}
