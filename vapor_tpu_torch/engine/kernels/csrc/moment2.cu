// moment2: two moment sets in one hits pass (the combined DEL mode).
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
// Bound on the H100: integer ALU: 2 strands x lanes compares per
// eligible cell, shared by both sets; the moment work runs on hits only.
//
// Design: the tile walk of hits.cuh; one pass over the cells serves both
// keep sets, which are read from global memory per hit.  64-bit sums,
// one atomic per warp and output.
#include "hits.cuh"

using namespace vt;

template <int LANES>
__global__ void __launch_bounds__(TC) moment2_kernel(
    const unsigned* ch, const unsigned* cf, const unsigned* cd,
    const int* ms, const int* rlens, int H, int R, int k, int W,
    const uint8_t* keep_d1, const uint8_t* keep_a1,
    const uint8_t* keep_d2, const uint8_t* keep_a2,
    unsigned long long* mom) {
  __shared__ unsigned sh[LANES][TH];
  Tile<LANES> t;
  if (!load_tile(t, sh, ch, cf, cd, ms, rlens, H, R, k)) return;

  const size_t row = (size_t)t.b * W;
  unsigned long long c1 = 0, s1 = 0, c2 = 0, s2 = 0, w2 = 0;
  for_each_hit(t, sh, [&](int i, int hf, int hr) {
    const int bd = t.j - i + H, ba = t.j + i;
    const bool k1 = keep_d1[row + bd] | keep_a1[row + ba];
    const bool k2 = keep_d2[row + bd] | keep_a2[row + ba];
    if (k1 || k2) {
      const int mult = hf + hr, ip = i - t.m, ad = abs(t.j - ip);
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
  unsigned long long* out = mom + 6 * (size_t)t.b;
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
  VT_LAUNCH_BY_LANES(lanes, moment2_kernel, B, H, R, (cudaStream_t)stream,
                     (const unsigned*)ch, (const unsigned*)cf,
                     (const unsigned*)cd, (const int*)ms,
                     (const int*)rlens, H, R, k, W,
                     (const uint8_t*)keep_d1, (const uint8_t*)keep_a1,
                     (const uint8_t*)keep_d2, (const uint8_t*)keep_a2,
                     (unsigned long long*)mom);
  return (int)cudaGetLastError();
}
