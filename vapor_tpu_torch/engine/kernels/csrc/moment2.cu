// moment2: two moment sets in one walk (the combined DEL mode).
//
// Replaces: _moment2_kernel / moment2_pass
// (experiments/pallas_fused.py:766-873).  Set 1 keeps cells by the m1b
// tables (keep_d1 | keep_a1), set 2 by the within-10% tables
// (keep_d2 | keep_a2).  With i' = i - m and d = j - i', output row
// mom[b] = [cnt1, sum1 |d|, 0, cnt2, sum2 |d|, w10_2], the same two
// blocks moment.cu writes for m1b and for w10 (w10_2 counts kept
// multiplicity over cells with i' > 0 and 25|d| < 4i').  The wrapper
// zeroes mom.
//
// Bound on the H100: integer ALU: two lane-0 compares per eligible cell,
// shared by both sets; the keep-table reads and the moment work run on
// hits only.
//
// Design: walk.cuh's register-blocked strip walk, as moment with a
// second keep set; one walk serves both sets.  The four keep tables are
// read from global memory on the rare path only (both d-tables at
// j - i + H, both a-tables at j + i), and i' and |d| are computed once
// per kept hit.  Sums are 64-bit, reduced over each warp and added with
// one atomic per warp and output, so the result is bitwise
// deterministic.
#include "walk.cuh"

using namespace vtw;

template <int LANES>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS) moment2_kernel(
    const unsigned* ch, const unsigned* cf, const unsigned* cd,
    const int* ms, const int* rlens, int H, int R, int k, int W,
    const uint8_t* keep_d1, const uint8_t* keep_a1,
    const uint8_t* keep_d2, const uint8_t* keep_a2,
    unsigned long long* mom, int strip) {
  __shared__ __align__(16) unsigned sh[LANES][MAX_STRIP];
  Strip s;
  if (!strip_bounds(s, ms, rlens, H, R, k, strip)) return;
  stage(s, sh, ch, cf, cd, H, R);

  const size_t row = (size_t)s.b * W;
  const int m = ms[s.b];
  unsigned long long c1 = 0, s1 = 0, c2 = 0, s2 = 0, w2 = 0;
  walk(s, sh, cf, cd, H, R, [&](int i, int j, int hf, int hr) {
    const size_t bd = row + (j - i + H), ba = row + (j + i);
    const bool k1 = keep_d1[bd] | keep_a1[ba];
    const bool k2 = keep_d2[bd] | keep_a2[ba];
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

extern "C" int vt_moment2(const void* ch, const void* cf, const void* cd,
                          const void* ms, const void* rlens, int B, int H,
                          int R, int lanes, int k, int W,
                          const void* keep_d1, const void* keep_a1,
                          const void* keep_d2, const void* keep_a2,
                          void* mom, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  VTW_LAUNCH_BY_LANES(lanes, moment2_kernel, B, H, R, device,
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
  return grid_info(by_lanes[lanes - 2], B, H, R, device, out);
}
