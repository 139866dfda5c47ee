// kept_table: 1-D gap clustering of histograms into keep tables.
//
// Replaces: kept_table_device (vapor_tpu/engine/fused.py:471), which XLA
// fuses inside the JAX engine's jitted _fused_one; in the port, the
// torch-op sequence of kernels.kept_table_plain (cummax scans, a cumsum,
// gathers).  Output, for each table t of one launch and row b of its
// (B, W) int32 histogram h: a cluster starts at a nonzero bin whose
// previous nonzero bin lies gap or more before it, or that has none, and
// runs to the bin before the next start (or to the last bin); its total
// is the sum of its bins, in int64.  keep[t, b, x] is h[x] > 0 and the
// total of x's cluster > thr_t; with fallback_t, when no cluster of the
// row passes thr_t, it is h[x] > 0 and that total == the row's largest.
// Histograms hold no negative bin (the kernels' counts).
//
// Bound on the H100: bytes (W x 4 bytes read twice and W bytes written a
// table and row; the scans are a few integer operations a bin).
//
// Design: one block per (row, table), THREADS threads each holding ITEMS
// consecutive bins of a CHUNK-bin chunk, the chunks walked in order with
// the scans' carries in registers.  Pass one: a block max-scan gives
// each bin the previous nonzero bin, so each thread finds its starts; a
// block sum-scan of the starts numbers the clusters; each thread adds
// its runs of bins into its clusters' totals, held in dynamic shared
// memory (starts lie gap or more apart, so a row has at most
// (W - 1) / gap + 1 clusters), with integer atomics.  The row's largest
// total and whether any passes thr come from one reduction over them.
// Pass two repeats the scans and writes every bin of the table, so the
// output needs no zeroing.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int ITEMS = 8;
constexpr int CHUNK = THREADS * ITEMS;
constexpr int MAX_TABLES = 4;
constexpr unsigned FULL = 0xFFFFFFFFu;

struct Tables {
  const int* h[MAX_TABLES];
  long long thr[MAX_TABLES];
  int fallback;        // bit t: table t falls back to the largest total
};

struct Max {
  __device__ int operator()(int a, int b) const { return a > b ? a : b; }
};
struct Sum {
  __device__ int operator()(int a, int b) const { return a + b; }
};

// exclusive block scan of one value a thread (identity for thread 0);
// `total` gets the scan of every thread's value.  Every thread calls it.
template <typename Op>
__device__ int block_scan(int v, int identity, Op op, int* warp_buf,
                          int& total) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  int x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL, x, o);
    if (lane >= o) x = op(x, y);
  }
  if (lane == 31) warp_buf[wid] = x;
  __syncthreads();
  if (wid == 0) {
    int s = lane < WARPS ? warp_buf[lane] : identity;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(FULL, s, o);
      if (lane >= o) s = op(s, y);
    }
    if (lane < WARPS) warp_buf[lane] = s;
  }
  __syncthreads();
  int before = __shfl_up_sync(FULL, x, 1);
  if (lane == 0) before = identity;
  const int out = op(wid ? warp_buf[wid - 1] : identity, before);
  total = warp_buf[WARPS - 1];
  __syncthreads();
  return out;
}

// The thread's ITEMS bins of the chunk at c0, and which of them start a
// cluster (bit i), given the last nonzero bin before the chunk; advances
// that carry.
__device__ unsigned chunk_starts(const int* h, int W, int c0, int gap,
                                 int* v, int& prev_carry, int* warp_buf) {
  const int x0 = c0 + threadIdx.x * ITEMS;
  int last = -1;
  for (int i = 0; i < ITEMS; ++i) {
    const int x = x0 + i;
    v[i] = x < W ? h[x] : 0;
    if (v[i] > 0) last = x;
  }
  int chunk_last;
  int p = block_scan(last, -1, Max(), warp_buf, chunk_last);
  p = p > prev_carry ? p : prev_carry;
  prev_carry = chunk_last > prev_carry ? chunk_last : prev_carry;
  unsigned starts = 0;
  for (int i = 0; i < ITEMS; ++i) {
    if (v[i] <= 0) continue;
    if (p < 0 || x0 + i - p >= gap) starts |= 1u << i;
    p = x0 + i;
  }
  return starts;
}

__global__ void __launch_bounds__(THREADS) kept_tables_kernel(
    Tables tb, int B, int W, int gap, uint8_t* out) {
  extern __shared__ long long total[];
  __shared__ int warp_buf[WARPS];
  __shared__ unsigned long long row_max;
  __shared__ int any_over;
  const int b = blockIdx.x, t = blockIdx.y;
  const int* h = tb.h[t] + (size_t)b * W;
  uint8_t* keep = out + ((size_t)t * B + b) * W;
  const long long thr = tb.thr[t];
  const int n_max = (W - 1) / gap + 1;
  for (int c = threadIdx.x; c < n_max; c += THREADS) total[c] = 0;
  if (threadIdx.x == 0) {
    row_max = 0;
    any_over = 0;
  }
  __syncthreads();

  int v[ITEMS];
  int prev = -1, clusters = 0;
  for (int c0 = 0; c0 < W; c0 += CHUNK) {
    const unsigned starts = chunk_starts(h, W, c0, gap, v, prev, warp_buf);
    int n_chunk;
    int cur = clusters + block_scan(__popc(starts), 0, Sum(), warp_buf,
                                    n_chunk) - 1;
    long long run = 0;
    for (int i = 0; i < ITEMS; ++i) {
      if (starts >> i & 1) {
        if (run) atomicAdd((unsigned long long*)&total[cur], run);
        ++cur;
        run = 0;
      }
      if (v[i] > 0) run += v[i];
    }
    if (run) atomicAdd((unsigned long long*)&total[cur], run);
    clusters += n_chunk;
  }
  __syncthreads();
  unsigned long long mx = 0;
  int over = 0;
  for (int c = threadIdx.x; c < clusters; c += THREADS) {
    const long long x = total[c];
    mx = (unsigned long long)x > mx ? (unsigned long long)x : mx;
    over |= x > thr;
  }
  if (mx) atomicMax(&row_max, mx);
  if (over) any_over = 1;
  __syncthreads();
  const bool by_max = (tb.fallback >> t & 1) && !any_over;
  const long long largest = (long long)row_max;

  prev = -1;
  clusters = 0;
  for (int c0 = 0; c0 < W; c0 += CHUNK) {
    const unsigned starts = chunk_starts(h, W, c0, gap, v, prev, warp_buf);
    int n_chunk;
    int cur = clusters + block_scan(__popc(starts), 0, Sum(), warp_buf,
                                    n_chunk) - 1;
    const int x0 = c0 + threadIdx.x * ITEMS;
    for (int i = 0; i < ITEMS && x0 + i < W; ++i) {
      cur += starts >> i & 1;
      bool k = false;
      if (v[i] > 0) k = by_max ? total[cur] == largest : total[cur] > thr;
      keep[x0 + i] = k;
    }
    clusters += n_chunk;
  }
}

}  // namespace

extern "C" int vt_kept_tables(void* out, const void* h0, const void* h1,
                              const void* h2, const void* h3,
                              long long thr0, long long thr1,
                              long long thr2, long long thr3, int fallback,
                              int n, int B, int W, int gap, int device,
                              void* stream) {
  if (n < 1 || n > MAX_TABLES || gap < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B == 0 || W == 0) return 0;
  const Tables tb = {{(const int*)h0, (const int*)h1, (const int*)h2,
                      (const int*)h3},
                     {thr0, thr1, thr2, thr3}, fallback};
  // one int64 total per cluster
  const int smem = (int)(((W - 1) / gap + 1) * sizeof(long long));
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kept_tables_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return (int)err;
  }
  kept_tables_kernel<<<dim3(B, n), THREADS, smem, (cudaStream_t)stream>>>(
      tb, B, W, gap, (uint8_t*)out);
  return (int)cudaGetLastError();
}
