// kept_hist: diagonal histogram of the hits the m1b keep tables keep.
//
// Replaces: _kept_hist_kernel / kept_hist_pass
// (experiments/pallas_fused.py:461-548), the first stage of the
// redefine-diagonal (rdd) mode.  Output, per row b: h_d[b, j - i + H] sums
// the hit multiplicity (forward + reverse, 0..2) of every cell (i, j)
// kept by keep_d[b, j - i + H] | keep_a[b, j + i].  The intercept fit
// (intercept_z in engine/fused.py) reads absolute bins: bin - H is j - i
// exactly.  The wrapper zeroes h_d.
//
// Bound on the H100: integer ALU, as for hist: 2 strands x lanes
// compares per eligible cell; the keep tables are read only on a hit.
//
// Design: hist's tile-local diagonal histogram (TH + TC - 1 bins in
// shared memory, see hits.cuh for the tile walk), fed only by kept hits,
// with the keep tables looked up in global memory per hit.  Flushed by
// its nonzero bins with one integer atomic each, so the output is
// bitwise deterministic.
#include "hits.cuh"

using namespace vt;

template <int LANES>
__global__ void __launch_bounds__(TC) kept_hist_kernel(
    const unsigned* ch, const unsigned* cf, const unsigned* cd,
    const int* ms, const int* rlens, int H, int R, int k, int W,
    const uint8_t* keep_d, const uint8_t* keep_a, int* h_d) {
  __shared__ unsigned sh[LANES][TH];
  __shared__ int hd[SPAN];
  Tile<LANES> t;
  if (!load_tile(t, sh, ch, cf, cd, ms, rlens, H, R, k)) return;
  for (int x = threadIdx.x; x < SPAN; x += TC) hd[x] = 0;
  __syncthreads();

  const uint8_t* kd = keep_d + (size_t)t.b * W;
  const uint8_t* ka = keep_a + (size_t)t.b * W;
  const int dj = t.j - t.j0;
  for_each_hit(t, sh, [&](int i, int hf, int hr) {
    if (kd[t.j - i + H] | ka[t.j + i])
      atomicAdd(&hd[dj - (i - t.i0) + TH - 1], hf + hr);
  });
  __syncthreads();
  // local d-bin x is j - i = x + j0 - i0 - (TH - 1), stored at + H
  flush_hist(h_d + (size_t)t.b * W, t.j0 - t.i0 - (TH - 1) + H, hd);
}

extern "C" int vt_kept_hist(const void* ch, const void* cf, const void* cd,
                            const void* ms, const void* rlens, int B,
                            int H, int R, int lanes, int k, int W,
                            const void* keep_d, const void* keep_a,
                            void* h_d, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  VT_LAUNCH_BY_LANES(lanes, kept_hist_kernel, B, H, R,
                     (cudaStream_t)stream, (const unsigned*)ch,
                     (const unsigned*)cf, (const unsigned*)cd,
                     (const int*)ms, (const int*)rlens, H, R, k, W,
                     (const uint8_t*)keep_d, (const uint8_t*)keep_a,
                     (int*)h_d);
  return (int)cudaGetLastError();
}
