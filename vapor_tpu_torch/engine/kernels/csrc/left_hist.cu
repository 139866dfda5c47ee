// left_hist: anti-diagonal histogram of the hits the d-table drops.
//
// Replaces: _left_hist_kernel / left_hist_pass
// (experiments/pallas_fused.py:371-454), the second stage of the
// within-10% cleaning.  Output, per row b: h_a[b, j + i] sums the hit
// multiplicity of every cell (i, j) whose diagonal bin j - i + H is NOT
// set in keep_d[b] (the 50-threshold diagonal keep table).  The wrapper
// zeroes h_a.
//
// Bound on the H100: integer ALU, as for hist: 2 strands x lanes
// compares per eligible cell; the keep table is read only on a hit.
//
// Design: the tile walk of hits.cuh; the keep table is looked up in
// global memory (L1/L2) per hit, which is rare next to the cells, so the
// (H, R) keep mask is never formed.  One tile-local shared histogram,
// flushed by its nonzero bins.
#include "hits.cuh"

using namespace vt;

template <int LANES>
__global__ void __launch_bounds__(TC) left_hist_kernel(
    const unsigned* ch, const unsigned* cf, const unsigned* cd,
    const int* ms, const int* rlens, int H, int R, int k, int W,
    const uint8_t* keep_d, int* h_a) {
  __shared__ unsigned sh[LANES][TH];
  __shared__ int ha[SPAN];
  Tile<LANES> t;
  if (!load_tile(t, sh, ch, cf, cd, ms, rlens, H, R, k)) return;
  for (int x = threadIdx.x; x < SPAN; x += TC) ha[x] = 0;
  __syncthreads();

  const uint8_t* kd = keep_d + (size_t)t.b * W;
  const int dj = t.j - t.j0;
  for_each_hit(t, sh, [&](int i, int hf, int hr) {
    if (!kd[t.j - i + H]) atomicAdd(&ha[dj + i - t.i0], hf + hr);
  });
  __syncthreads();
  flush_hist(h_a + (size_t)t.b * W, t.j0 + t.i0, ha);
}

extern "C" int vt_left_hist(const void* ch, const void* cf, const void* cd,
                            const void* ms, const void* rlens, int B,
                            int H, int R, int lanes, int k, int W,
                            const void* keep_d, void* h_a, int device,
                            void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  VT_LAUNCH_BY_LANES(lanes, left_hist_kernel, B, H, R,
                     (cudaStream_t)stream, (const unsigned*)ch,
                     (const unsigned*)cf, (const unsigned*)cd,
                     (const int*)ms, (const int*)rlens, H, R, k, W,
                     (const uint8_t*)keep_d, (int*)h_a);
  return (int)cudaGetLastError();
}
