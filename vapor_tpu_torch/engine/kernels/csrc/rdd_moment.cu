// rdd_moment: masked moments plus the redefine-diagonal selection block.
//
// Replaces: _rdd_moment_kernel / rdd_moment_pass
// (experiments/pallas_fused.py:555-656), the moment stage of the rdd
// mode.  A cell (i, j) is kept when keep_d[b, j - i + H] or
// keep_a[b, j + i] is set.  With i' = i - m, d = j - i', the row's
// intercept z = zs[b], val = z - 2d and den = |2i' + z| (|2i' + z + 2|
// when 2i' + z is 0), a kept cell is selected when 10|val| > den.
// Output row mom[b] = [sum of mult, sum of mult * |d|, 0, sum of mult
// over selected cells, sum of mult * max(val, 0) and of
// mult * max(-val, 0) over selected cells], mult being the cell's hit
// multiplicity (0..2).  The entry point zeroes mom with one
// cudaMemsetAsync on the launch's stream.
//
// Bound on the H100: integer ALU: two lane-0 compares per eligible
// cell; the keep-table reads, the moment and the selection work run on
// hits only.
//
// Design: walk.cuh's on-chip walk.  Each block also stages its strip's
// bins of both keep tables (stage_keep: strip + TCOLS - 1 bytes each) in
// shared memory, so the rare path, which computes the 64-bit moment and
// selection block, reads no global memory.  Sums are 64-bit (the
// selection sums pass 2^31 at the largest buckets), reduced over each
// warp and added with one atomic per warp and output, so the result is
// bitwise deterministic.
#include "walk.cuh"

using namespace vtw;

template <int LANES>
__global__ void __launch_bounds__(THREADS, TILE_BLOCKS) rdd_moment_kernel(
    const unsigned* ch, const unsigned* cf, const unsigned* cd,
    const int* ms, const int* rlens, int H, int R, int k, int W,
    const uint8_t* keep_d, const uint8_t* keep_a, const int* zs,
    unsigned long long* mom, int strip) {
  extern __shared__ __align__(16) unsigned smem[];
  const Tile<LANES> t = tile<LANES>(smem, strip);
  Strip s;
  if (!strip_bounds_tile(s, ms, rlens, H, R, k, strip)) return;
  uint8_t* keep = (uint8_t*)t.own;
  stage_keep(s, strip, H, W, keep_d, keep_a, keep);
  stage_tile(s, t, ch, cf, cd, H, R);

  const int m = ms[s.b], z = zs[s.b];
  unsigned long long cnt = 0, sum_absd = 0, sel = 0, pos = 0, neg = 0;
  walk_tile(s, t, H, [&](int i, int j, int hf, int hr) {
    if (kept(s, strip, keep, i, j)) {
      const int mult = hf + hr, ip = i - m, d = j - ip;
      cnt += mult;
      sum_absd += (unsigned long long)(mult * abs(d));
      const int val = z - 2 * d, den0 = 2 * ip + z;
      const int den = den0 == 0 ? abs(den0 + 2) : abs(den0);
      if (10 * abs(val) > den) {
        sel += mult;
        if (val > 0) pos += (unsigned long long)(mult * val);
        else neg += (unsigned long long)(mult * -val);
      }
    }
  });
  unsigned long long* out = mom + 6 * (size_t)s.b;
  warp_add(out + 0, cnt);
  warp_add(out + 1, sum_absd);
  warp_add(out + 3, sel);
  warp_add(out + 4, pos);
  warp_add(out + 5, neg);
}

extern "C" int vt_rdd_moment(const void* ch, const void* cf, const void* cd,
                             const void* ms, const void* rlens, int B,
                             int H, int R, int lanes, int k, int W,
                             const void* keep_d, const void* keep_a,
                             const void* zs, void* mom, int device,
                             void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(mom, 0, 6 * (size_t)B * sizeof(long long),
                          (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  VTW_LAUNCH_TILE(lanes, KEEP_UNIT, rdd_moment_kernel, B, H, R, device,
                  (cudaStream_t)stream, (const unsigned*)ch,
                  (const unsigned*)cf, (const unsigned*)cd,
                  (const int*)ms, (const int*)rlens, H, R, k, W,
                  (const uint8_t*)keep_d, (const uint8_t*)keep_a,
                  (const int*)zs, (unsigned long long*)mom);
  return (int)cudaGetLastError();
}

extern "C" int vt_rdd_moment_grid(int B, int H, int R, int lanes,
                                  int device, int* out) {
  if (lanes < 2 || lanes > 5) return (int)cudaErrorInvalidValue;
  const void* by_lanes[] = {
      (const void*)rdd_moment_kernel<2>, (const void*)rdd_moment_kernel<3>,
      (const void*)rdd_moment_kernel<4>, (const void*)rdd_moment_kernel<5>};
  return grid_info_tile(by_lanes[lanes - 2], B, H, R, lanes, KEEP_UNIT,
                        device, out);
}
