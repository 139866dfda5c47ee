// moment2: two moment sets in one walk (the combined DEL mode).
//
// Replaces: _moment2_kernel / moment2_pass
// (experiments/pallas_fused.py:766-873).  Set 1 keeps cells by the m1b
// tables (keep_d1 | keep_a1), set 2 by the within-10% tables
// (keep_d2 | keep_a2).  With i' = i - m and d = j - i', output row
// mom[b] = [cnt1, sum1 |d|, 0, cnt2, sum2 |d|, w10_2], the same two
// blocks moment.cu writes for m1b and for w10 (w10_2 counts kept
// multiplicity over cells with i' > 0 and 25|d| < 4i').  The entry point
// zeroes mom (slot 2 included, which no thread writes) with one
// cudaMemsetAsync on the launch's stream.
//
// Bound on the H100: integer ALU: two lane-0 compares per eligible cell,
// shared by both sets; the keep-table reads and the moment work run on
// hits only.
//
// Design: walk.cuh's on-chip walk, as moment with a second keep set; one
// walk serves both sets.  Each block stages its strip's bins of both
// pairs (stage_keep twice: pair 1, then pair 2 at 2 (strip + TCOLS - 1)
// bytes on) beside the tile, so the rare path reads no global memory,
// and i' and |d| are computed once per hit that either pair keeps.  Sums
// are 64-bit, reduced over each warp and added with one atomic per warp
// and output, so the result is bitwise deterministic.
#include "walk.cuh"

using namespace vtw;

template <int LANES>
__global__ void __launch_bounds__(THREADS, TILE_BLOCKS) moment2_kernel(
    const unsigned* ch, const unsigned* cf, const unsigned* cd,
    const int* ms, const int* rlens, int H, int R, int k, int W,
    const uint8_t* keep_d1, const uint8_t* keep_a1,
    const uint8_t* keep_d2, const uint8_t* keep_a2,
    unsigned long long* mom, int strip) {
  extern __shared__ __align__(16) unsigned smem[];
  const Tile<LANES> t = tile<LANES>(smem, strip);
  Strip s;
  if (!strip_bounds_tile(s, ms, rlens, H, R, k, strip)) return;
  uint8_t* keep1 = (uint8_t*)t.own;
  uint8_t* keep2 = keep1 + 2 * (strip + TCOLS - 1);
  stage_keep(s, strip, H, W, keep_d1, keep_a1, keep1);
  stage_keep(s, strip, H, W, keep_d2, keep_a2, keep2);
  stage_tile(s, t, ch, cf, cd, H, R);

  const int m = ms[s.b];
  unsigned long long c1 = 0, s1 = 0, c2 = 0, s2 = 0, w2 = 0;
  walk_tile(s, t, H, [&](int i, int j, int hf, int hr) {
    const bool k1 = kept(s, strip, keep1, i, j);
    const bool k2 = kept(s, strip, keep2, i, j);
    if (k1 || k2) {
      const int mult = hf + hr, ip = i - m, ad = abs(j - ip);
      const unsigned long long wd = (unsigned long long)(mult * ad);
      if (k1) {
        c1 += mult;
        s1 += wd;
      }
      if (k2) {
        c2 += mult;
        s2 += wd;
        if (ip > 0 && 25 * ad < 4 * ip) w2 += mult;
      }
    }
  });
  unsigned long long* out = mom + 6 * (size_t)s.b;
  warp_add(out + 0, c1);
  warp_add(out + 1, s1);
  warp_add(out + 3, c2);
  warp_add(out + 4, s2);
  warp_add(out + 5, w2);
}

// strip-local tables: the bins of both keep-table pairs
constexpr int MOMENT2_UNIT = 2 * KEEP_UNIT;

extern "C" int vt_moment2(const void* ch, const void* cf, const void* cd,
                          const void* ms, const void* rlens, int B, int H,
                          int R, int lanes, int k, int W,
                          const void* keep_d1, const void* keep_a1,
                          const void* keep_d2, const void* keep_a2,
                          void* mom, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(mom, 0, 6 * (size_t)B * sizeof(long long),
                          (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  VTW_LAUNCH_TILE(lanes, MOMENT2_UNIT, moment2_kernel, B, H, R, device,
                  (cudaStream_t)stream, (const unsigned*)ch,
                  (const unsigned*)cf, (const unsigned*)cd,
                  (const int*)ms, (const int*)rlens, H, R, k, W,
                  (const uint8_t*)keep_d1, (const uint8_t*)keep_a1,
                  (const uint8_t*)keep_d2, (const uint8_t*)keep_a2,
                  (unsigned long long*)mom);
  return (int)cudaGetLastError();
}

extern "C" int vt_moment2_grid(int B, int H, int R, int lanes, int device,
                               int* out) {
  if (lanes < 2 || lanes > 5) return (int)cudaErrorInvalidValue;
  const void* by_lanes[] = {
      (const void*)moment2_kernel<2>, (const void*)moment2_kernel<3>,
      (const void*)moment2_kernel<4>, (const void*)moment2_kernel<5>};
  return grid_info_tile(by_lanes[lanes - 2], B, H, R, lanes, MOMENT2_UNIT,
                        device, out);
}
