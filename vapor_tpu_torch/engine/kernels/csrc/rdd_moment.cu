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
// multiplicity (0..2).  The wrapper zeroes mom.
//
// Bound on the H100: integer ALU: 2 strands x lanes compares per
// eligible cell; the moment and selection work runs on hits only.
//
// Design: moment.cu's tile walk (hits.cuh) with z read once per block.
// Sums are 64-bit (the selection sums pass 2^31 at the largest
// buckets), reduced over each warp and added with one atomic per warp
// and output, so the result is bitwise deterministic.
#include "hits.cuh"

using namespace vt;

template <int LANES>
__global__ void __launch_bounds__(TC) rdd_moment_kernel(
    const unsigned* ch, const unsigned* cf, const unsigned* cd,
    const int* ms, const int* rlens, int H, int R, int k, int W,
    const uint8_t* keep_d, const uint8_t* keep_a, const int* zs,
    unsigned long long* mom) {
  __shared__ unsigned sh[LANES][TH];
  Tile<LANES> t;
  if (!load_tile(t, sh, ch, cf, cd, ms, rlens, H, R, k)) return;

  const uint8_t* kd = keep_d + (size_t)t.b * W;
  const uint8_t* ka = keep_a + (size_t)t.b * W;
  const int z = zs[t.b];
  unsigned long long cnt = 0, sum_absd = 0, sel = 0, pos = 0, neg = 0;
  for_each_hit(t, sh, [&](int i, int hf, int hr) {
    if (kd[t.j - i + H] | ka[t.j + i]) {
      const int mult = hf + hr, ip = i - t.m, d = t.j - ip;
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
  unsigned long long* out = mom + 6 * (size_t)t.b;
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
  if (err != cudaSuccess) return (int)err;
  VT_LAUNCH_BY_LANES(lanes, rdd_moment_kernel, B, H, R,
                     (cudaStream_t)stream, (const unsigned*)ch,
                     (const unsigned*)cf, (const unsigned*)cd,
                     (const int*)ms, (const int*)rlens, H, R, k, W,
                     (const uint8_t*)keep_d, (const uint8_t*)keep_a,
                     (const int*)zs, (unsigned long long*)mom);
  return (int)cudaGetLastError();
}
