// moment: masked moments over the kept hits of one keep-table pair.
//
// Replaces: _moment_kernel / moment_pass
// (experiments/pallas_fused.py:663-759), the moment stage of modes m1b
// and w10.  A cell (i, j) is kept when keep_d[b, j - i + H] or
// keep_a[b, j + i] is set.  With i' = i - m and d = j - i', output row
// mom[b] = [sum of mult, sum of mult * |d|, sum of mult over cells with
// i' > 0 and 25|d| < 4i' (only when want_w10)] over kept cells, mult
// being the cell's hit multiplicity (0..2).  The wrapper zeroes mom.
//
// Bound on the H100: integer ALU: 2 strands x lanes compares per
// eligible cell; the moment work runs on hits only.
//
// Design: the tile walk of hits.cuh; keep tables are read from global
// memory per hit, so the (H, R) keep mask is never formed.  Sums are
// 64-bit (sum |d| reaches ~H R (H + R), past 2^31 at large buckets),
// reduced over each warp and added with one atomic per warp.
#include "hits.cuh"

using namespace vt;

template <int LANES>
__global__ void __launch_bounds__(TC) moment_kernel(
    const unsigned* ch, const unsigned* cf, const unsigned* cd,
    const int* ms, const int* rlens, int H, int R, int k, int W,
    const uint8_t* keep_d, const uint8_t* keep_a, int want_w10,
    unsigned long long* mom) {
  __shared__ unsigned sh[LANES][TH];
  Tile<LANES> t;
  if (!load_tile(t, sh, ch, cf, cd, ms, rlens, H, R, k)) return;

  const uint8_t* kd = keep_d + (size_t)t.b * W;
  const uint8_t* ka = keep_a + (size_t)t.b * W;
  unsigned long long cnt = 0, sum_absd = 0, w10 = 0;
  for_each_hit(t, sh, [&](int i, int hf, int hr) {
    if (kd[t.j - i + H] | ka[t.j + i]) {
      const int mult = hf + hr, ip = i - t.m, ad = abs(t.j - ip);
      cnt += mult;
      sum_absd += (unsigned long long)(mult * ad);
      if (want_w10 && ip > 0 && 25 * ad < 4 * ip) w10 += mult;
    }
  });
  unsigned long long* out = mom + 3 * (size_t)t.b;
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
  if (err != cudaSuccess) return (int)err;
  VT_LAUNCH_BY_LANES(lanes, moment_kernel, B, H, R, (cudaStream_t)stream,
                     (const unsigned*)ch, (const unsigned*)cf,
                     (const unsigned*)cd, (const int*)ms,
                     (const int*)rlens, H, R, k, W, (const uint8_t*)keep_d,
                     (const uint8_t*)keep_a, want_w10,
                     (unsigned long long*)mom);
  return (int)cudaGetLastError();
}
