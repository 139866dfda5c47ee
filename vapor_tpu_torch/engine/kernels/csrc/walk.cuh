// The on-chip tile walk of the six dot-plot kernels (hist, left_hist,
// kept_hist, rdd_moment, moment, moment2), laid out for the H100.
//
// A (read, haplotype) row is an H x R grid of cells: cell (i, j) of row b
// pairs hap k-mer i with read k-mer j, is eligible when i >= m (the
// read's missing prefix) and j <= rlen - k (past that, the read window
// reaches the READ_PAD tail), and holds a forward (reverse) hit when all
// LANES code words of hap row i equal those of forward (dot-space
// reverse, as rc_dot_codes in engine/fused.py lays them out) read column
// j.  Each k-mer is LANES 32-bit words of eight 4-bit symbols.
//
// Bound: the two lane-0 compares of every eligible cell, on the INT32
// pipe (64 lanes an SM).  A random lane-0 word matches about 2 cells in
// 65,536 at k = 10, so the design spends the fast path on those compares
// alone and everything else on a rare path:
//
// * A block walks a strip of `strip` hap rows x TCOLS read columns of
//   one row b.  Thread t keeps the lane-0 words of both strands of its
//   COLS columns in 2 COLS registers; a lane's columns are 32 apart
//   (strip_bounds_tile), so the read's diagonal, which crosses a group's
//   4 rows on 4 neighbouring columns, falls on 4 lanes, one each.
// * Staging (stage_tile): the strip's hap codes of every lane and lanes
//   1..LANES-1 of the block's read columns, both strands, go to dynamic
//   shared memory, and the keep-table kernels stage the strip's bins of
//   their keep tables beside them (stage_keep), so the rare path reads
//   shared memory only.
// * Fast path (group_fires): lane 0 of GROUP = 4 hap rows is read as one
//   16-byte warp-wide broadcast, its 8 COLS lane-0 equalities are ORed
//   into one predicate and the warp takes one vote.  When any thread of
//   the warp saw a lane-0 match, the warp re-tests its cells of the
//   group with every lane and calls the visitor (the rare path,
//   rare_tile).
// * Masks cost nothing per cell: in shared memory the strip's rows
//   outside [max(strip start, m), H) hold ROW_SENTINEL as lane 0, and the
//   registers of columns past rlen - k hold COL_SENTINEL on both strands.
//   No eligible column of a read built from the engine's alphabet can
//   hold ROW_SENTINEL and no hap code can hold COL_SENTINEL
//   (tests/test_torch_build.py), so a masked cell never wakes the fast
//   path; the rare path re-tests both bounds all the same, so counts
//   stay exact for any input.
// * The grid (plan_tile): the shortest strip, in steps of MIN_STRIP rows,
//   whose grid fits in one wave at TILE_BLOCKS blocks an SM.  A block's
//   time grows with its strip (the warp that holds the read's diagonal
//   takes the rare path on every group of it), so a grid that fits in
//   one wave gains nothing from taller strips and loses a whole block's
//   time to a second wave.
// * Outputs: each C entry point zeroes them with one cudaMemsetAsync on
//   the launch's stream, so the wrappers run no fill op of their own.
//
// All accumulation is integer; outputs do not depend on the order in
// which the atomics land.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <algorithm>

namespace vtw {

constexpr int THREADS = 256;             // threads per block
constexpr int COLS = 4;                  // read columns per thread
constexpr int TCOLS = THREADS * COLS;    // read columns per block
constexpr int MAX_STRIP = 1024;          // hap rows per block, at most
constexpr int MIN_STRIP = 32;            // ... and at least, in steps of
constexpr int GROUP = 4;                 // hap rows per 16-byte shared load
// blocks per SM the launch bounds ask for: 48 registers a thread, none
// spilled (chip_smoke.py phase 1)
constexpr int TILE_BLOCKS = 5;
// eight symbols of HAP_PAD (nibble 13) and of READ_PAD (nibble 14), in
// the packing of kernels.pack_codes
constexpr unsigned ROW_SENTINEL = 0xDDDDDDDDu;
constexpr unsigned COL_SENTINEL = 0xEEEEEEEEu;

struct Strip {
  int b, s0, j0;      // row, first hap row, first read column
  int ilo, iend;      // eligible rows: [max(s0, m), min(s0 + strip, H))
  int g_begin, g_end; // groups of GROUP rows walked, from s0
  int jt, j_last;     // the thread's first column; last eligible column
  bool warp_walks;    // the warp owns an eligible column
  unsigned f[COLS];   // lane-0 forward codes of the thread's columns
  unsigned r[COLS];   // lane-0 reverse (dot-space) codes
};

// The block's strip bounds.  Returns false, for the whole block alike,
// when the strip holds no eligible cell; such blocks exit before any
// barrier.
__device__ __forceinline__ bool strip_bounds(Strip& s, const int* ms,
                                             const int* rlens, int H,
                                             int R, int k, int strip) {
  s.b = blockIdx.z;
  s.s0 = blockIdx.y * strip;
  s.j0 = blockIdx.x * TCOLS;
  s.j_last = min(rlens[s.b] - k, R - 1);
  s.ilo = max(s.s0, ms[s.b]);
  s.iend = min(s.s0 + strip, H);
  s.g_begin = (s.ilo - s.s0) / GROUP;
  s.g_end = (s.iend - s.s0 + GROUP - 1) / GROUP;
  s.jt = s.j0 + COLS * (int)threadIdx.x;
  s.warp_walks = s.j0 + COLS * (int)(threadIdx.x & ~31u) <= s.j_last;
  return s.j0 <= s.j_last && s.ilo < s.iend;
}

// One group of the fast path: loads the group's four lane-0 hap words
// with one 16-byte shared broadcast from shared address `at`, chains the
// 8 COLS lane-0 equalities into one predicate through setp's OR-combine
// (one instruction a compare), and votes it over the warp.  Returns the
// vote, the same in every lane.  Written in PTX so that the compiler
// neither regroups the chain nor recomputes the address every group; as
// volatile asm it stays behind the barrier that ends the staging, and it
// writes no memory.
__device__ __forceinline__ unsigned group_fires(unsigned at,
                                                const unsigned (&f)[COLS],
                                                const unsigned (&r)[COLS]) {
  static_assert(COLS == 4 && GROUP == 4, "the chain is written for 4 x 4");
  unsigned fire;
  asm volatile(
      "{\n\t"
      ".reg .u32 h0, h1, h2, h3;\n\t"
      ".reg .pred p;\n\t"
      "ld.shared.v4.u32 {h0, h1, h2, h3}, [%1];\n\t"
      "setp.eq.u32 p, h0, %2;\n\t"
      "setp.eq.or.u32 p, h0, %6, p;\n\t"
      "setp.eq.or.u32 p, h0, %3, p;\n\t"
      "setp.eq.or.u32 p, h0, %7, p;\n\t"
      "setp.eq.or.u32 p, h0, %4, p;\n\t"
      "setp.eq.or.u32 p, h0, %8, p;\n\t"
      "setp.eq.or.u32 p, h0, %5, p;\n\t"
      "setp.eq.or.u32 p, h0, %9, p;\n\t"
      "setp.eq.or.u32 p, h1, %2, p;\n\t"
      "setp.eq.or.u32 p, h1, %6, p;\n\t"
      "setp.eq.or.u32 p, h1, %3, p;\n\t"
      "setp.eq.or.u32 p, h1, %7, p;\n\t"
      "setp.eq.or.u32 p, h1, %4, p;\n\t"
      "setp.eq.or.u32 p, h1, %8, p;\n\t"
      "setp.eq.or.u32 p, h1, %5, p;\n\t"
      "setp.eq.or.u32 p, h1, %9, p;\n\t"
      "setp.eq.or.u32 p, h2, %2, p;\n\t"
      "setp.eq.or.u32 p, h2, %6, p;\n\t"
      "setp.eq.or.u32 p, h2, %3, p;\n\t"
      "setp.eq.or.u32 p, h2, %7, p;\n\t"
      "setp.eq.or.u32 p, h2, %4, p;\n\t"
      "setp.eq.or.u32 p, h2, %8, p;\n\t"
      "setp.eq.or.u32 p, h2, %5, p;\n\t"
      "setp.eq.or.u32 p, h2, %9, p;\n\t"
      "setp.eq.or.u32 p, h3, %2, p;\n\t"
      "setp.eq.or.u32 p, h3, %6, p;\n\t"
      "setp.eq.or.u32 p, h3, %3, p;\n\t"
      "setp.eq.or.u32 p, h3, %7, p;\n\t"
      "setp.eq.or.u32 p, h3, %4, p;\n\t"
      "setp.eq.or.u32 p, h3, %8, p;\n\t"
      "setp.eq.or.u32 p, h3, %5, p;\n\t"
      "setp.eq.or.u32 p, h3, %9, p;\n\t"
      "vote.sync.any.pred p, p, 0xffffffff;\n\t"
      "selp.u32 %0, 1, 0, p;\n\t"
      "}"
      : "=r"(fire)
      : "r"(at), "r"(f[0]), "r"(f[1]), "r"(f[2]), "r"(f[3]), "r"(r[0]),
        "r"(r[1]), "r"(r[2]), "r"(r[3]));
  return fire;
}

// Adds v over the warp to *out with one atomic from lane 0.  Every lane
// of the warp must call it.
__device__ __forceinline__ void warp_add(unsigned long long* out,
                                         unsigned long long v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  if ((threadIdx.x & 31) == 0 && v) atomicAdd(out, v);
}

// Shared-memory words of a tile before the kernel's own tables: hap
// codes [LANES][strip], then read columns [LANES - 1][2][TCOLS] (lanes 1
// and up; forward, then reverse).
__host__ __device__ inline size_t tile_words(int lanes, int strip) {
  return (size_t)lanes * strip + (size_t)(lanes - 1) * 2 * TCOLS;
}

// Dynamic shared memory of a block: the tile, then `unit` bytes for each
// of the strip's strip + TCOLS - 1 diagonal bins (the kernel's own
// strip-local tables), rounded up to 16 bytes.
inline size_t tile_bytes(int lanes, int strip, int unit) {
  const size_t own = (size_t)unit * (strip + TCOLS - 1);
  return 4 * tile_words(lanes, strip) + ((own + 15) & ~(size_t)15);
}

// The launch on B rows of H x R cells on card `device`: strip, grid and
// dynamic shared memory.  The strip is the shortest, in steps of
// MIN_STRIP rows, whose grid runs in one wave (its blocks no more than
// the SMs hold at once: the `per_sm_regs` a kernel's registers allow, or
// fewer where shared memory runs out); MAX_STRIP where none does.
inline cudaError_t plan_tile(int B, int H, int R, int lanes, int unit,
                             int per_sm_regs, int device, int& strip,
                             dim3& grid, size_t& smem) {
  int sms = 0, per_sm = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, device);
  if (err != cudaSuccess) return err;
  const long cols = (R + TCOLS - 1) / TCOLS;
  for (strip = MIN_STRIP;; strip += MIN_STRIP) {
    smem = tile_bytes(lanes, strip, unit);
    // the card keeps 1 KB of each block's shared memory for itself
    const long resident =
        std::min<long>(per_sm_regs, per_sm / (long)(smem + 1024));
    const long blocks = cols * ((H + strip - 1) / strip) * B;
    if (strip == MAX_STRIP || blocks <= resident * sms) break;
  }
  grid = dim3((unsigned)cols, (H + strip - 1) / strip, B);
  return cudaSuccess;
}

// The blocks of `kernel` an SM holds at once as far as its registers
// and threads go (no dynamic shared memory).
inline cudaError_t regs_resident(const void* kernel, int& resident) {
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, kernel,
                                                       THREADS, 0);
}

// Lets `kernel` take `smem` bytes of dynamic shared memory (above 48 KB
// only after this call, on the current device).
inline cudaError_t allow_smem(const void* kernel, size_t smem) {
  return smem <= 48 * 1024
             ? cudaSuccess
             : cudaFuncSetAttribute(kernel,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)smem);
}

// A block's tile in dynamic shared memory; `own` is where the kernel's
// strip-local tables start.
template <int LANES>
struct Tile {
  unsigned* hap;  // [LANES][strip]
  unsigned* col;  // [LANES - 1][2][TCOLS]
  void* own;
  int strip;
};

template <int LANES>
__device__ __forceinline__ Tile<LANES> tile(unsigned* smem, int strip) {
  Tile<LANES> t;
  t.hap = smem;
  t.col = smem + LANES * strip;
  t.own = smem + tile_words(LANES, strip);
  t.strip = strip;
  return t;
}

// strip_bounds with the walk's columns: column c of lane l of warp w is
// j0 + 128 w + 32 c + l, so that the read's diagonal, which crosses a
// group's 4 rows on 4 neighbouring columns, lands on 4 lanes, whose rare
// paths run side by side, not on the 1-2 that would hold 4 neighbouring
// columns each.
__device__ __forceinline__ bool strip_bounds_tile(Strip& s, const int* ms,
                                                  const int* rlens, int H,
                                                  int R, int k, int strip) {
  const bool any = strip_bounds(s, ms, rlens, H, R, k, strip);
  s.jt = s.j0 + COLS * (int)(threadIdx.x & ~31u) + (int)(threadIdx.x & 31);
  return any;
}

// Stages the strip's hap codes (sentinel-masked lane 0) and lanes
// 1..LANES-1 of the block's read columns of both strands (those up to
// j_last: no other is read) into the tile, and the thread's lane-0
// column codes (as strip_bounds_tile lays columns out) in registers;
// syncs the block.
template <int LANES>
__device__ __forceinline__ void stage_tile(Strip& s, const Tile<LANES>& t,
                                           const unsigned* ch,
                                           const unsigned* cf,
                                           const unsigned* cd, int H,
                                           int R) {
  const int row0 = GROUP * s.g_begin, row1 = GROUP * s.g_end;
#pragma unroll
  for (int lane = 0; lane < LANES; ++lane) {
    const unsigned* src = ch + ((size_t)s.b * LANES + lane) * H + s.s0;
    for (int row = row0 + (int)threadIdx.x; row < row1; row += THREADS) {
      const int i = s.s0 + row;
      const bool ok = i >= s.ilo && i < H;
      t.hap[lane * t.strip + row] =
          ok ? src[row] : (lane == 0 ? ROW_SENTINEL : 0u);
    }
  }
  const size_t at = (size_t)s.b * LANES * R;
  const int ncols = min(TCOLS, s.j_last - s.j0 + 1);
#pragma unroll
  for (int lane = 1; lane < LANES; ++lane) {
    const size_t from = at + (size_t)lane * R + s.j0;
    unsigned* fw = t.col + (2 * (lane - 1)) * TCOLS;
    for (int x = threadIdx.x; x < ncols; x += THREADS) {
      fw[x] = cf[from + x];
      fw[TCOLS + x] = cd[from + x];
    }
  }
#pragma unroll
  for (int c = 0; c < COLS; ++c) {
    const int j = s.jt + 32 * c;
    const bool ok = j <= s.j_last;
    s.f[c] = ok ? cf[at + j] : COL_SENTINEL;
    s.r[c] = ok ? cd[at + j] : COL_SENTINEL;
  }
  __syncthreads();
}

// Strip-local bytes a bin of a keep-table pair: one each of keep_d and
// keep_a.
constexpr int KEEP_UNIT = 2;

// Stages the strip's bins of row s.b's keep tables (keep_d over
// j - i + H, keep_a over j + i; W bytes a row) into `bins`: the
// strip + TCOLS - 1 d-bins, then as many a-bins, or the d-bins alone
// where keep_a is null.  Local d-bin x is j - i + H = x + d0 and local
// a-bin x is j + i = x + a0; a bin outside [0, W) holds no cell of the
// strip and stages as 0.  Call it before stage_tile, whose barrier ends
// it.
__device__ __forceinline__ void stage_keep(const Strip& s, int strip, int H,
                                           int W, const uint8_t* keep_d,
                                           const uint8_t* keep_a,
                                           uint8_t* bins) {
  const int span = strip + TCOLS - 1;
  const int d0 = s.j0 - s.s0 - (strip - 1) + H, a0 = s.j0 + s.s0;
  const size_t row = (size_t)s.b * W;
  for (int x = threadIdx.x; x < span; x += THREADS) {
    bins[x] = d0 + x >= 0 && d0 + x < W ? keep_d[row + (d0 + x)] : 0;
    if (keep_a) bins[span + x] = a0 + x < W ? keep_a[row + (a0 + x)] : 0;
  }
}

// Local d-bin of cell (i, j) of the strip: the index of its bin in a
// strip-local diagonal table, as stage_keep lays d-bins out.
__device__ __forceinline__ int d_bin(const Strip& s, int strip, int i,
                                     int j) {
  return (j - s.j0) - (i - s.s0) + strip - 1;
}

// Whether the keep tables keep cell (i, j) of the strip: its d-bin or
// its a-bin set in stage_keep's bins.
__device__ __forceinline__ bool kept(const Strip& s, int strip,
                                     const uint8_t* bins, int i, int j) {
  return bins[d_bin(s, strip, i, j)] |
         bins[strip + TCOLS - 1 + (j - s.j0) + (i - s.s0)];
}

// The rare path of group g: calls visit(i, j, hf, hr) for each cell of
// the thread's columns in the group's rows with a hit on either strand
// (hf and hr 0 or 1); every lane of a candidate is read from shared
// memory.
template <int LANES, class Visit>
__device__ __forceinline__ void rare_tile(const Strip& s,
                                          const Tile<LANES>& t, int H,
                                          int g, Visit& visit) {
  unsigned fm = 0, rm = 0;  // bit GROUP c + q: row q, column c matched
#pragma unroll
  for (int q = 0; q < GROUP; ++q) {
    const unsigned h = t.hap[GROUP * g + q];
#pragma unroll
    for (int c = 0; c < COLS; ++c) {
      fm |= (unsigned)(h == s.f[c]) << (GROUP * c + q);
      rm |= (unsigned)(h == s.r[c]) << (GROUP * c + q);
    }
  }
  for (unsigned cand = fm | rm; cand; cand &= cand - 1) {
    const int bit = __ffs(cand) - 1;
    const int row = GROUP * g + bit % GROUP, i = s.s0 + row;
    const int j = s.jt + 32 * (bit / GROUP), x = j - s.j0;
    if (i < s.ilo || i >= H || j > s.j_last) continue;
    bool hf = (fm >> bit) & 1u, hr = (rm >> bit) & 1u;
#pragma unroll
    for (int lane = 1; lane < LANES; ++lane) {
      const unsigned h = t.hap[lane * t.strip + row];
      const unsigned* fw = t.col + (2 * (lane - 1)) * TCOLS;
      hf &= h == fw[x];
      hr &= h == fw[TCOLS + x];
    }
    if (hf || hr) visit(i, j, (int)hf, (int)hr);
  }
}

// Walks the strip: calls visit(i, j, hf, hr) for each cell of the
// thread's columns with a hit on either strand.  Every thread of the
// block calls it; a warp with no eligible column returns at once.
template <int LANES, class Visit>
__device__ __forceinline__ void walk_tile(const Strip& s,
                                          const Tile<LANES>& t, int H,
                                          Visit&& visit) {
  if (!s.warp_walks) return;
  unsigned at =
      (unsigned)__cvta_generic_to_shared(&t.hap[GROUP * s.g_begin]);
#pragma unroll 2
  for (int g = s.g_begin; g < s.g_end; ++g, at += GROUP * sizeof(unsigned)) {
    if (group_fires(at, s.f, s.r)) rare_tile<LANES>(s, t, H, g, visit);
  }
}

// Writes [blocks, blocks resident per SM, SMs, strip rows, dynamic shared
// bytes] of a kernel's launch (its strip-local tables `unit` bytes a
// bin) on B rows of H x R cells to out (int[5]): the grid runs in
// blocks / (resident x SMs) waves.  Returns the CUDA error.
inline int grid_info_tile(const void* kernel, int B, int H, int R,
                          int lanes, int unit, int device, int* out) {
  int per_sm = 0, resident = 0, strip = 0;
  dim3 grid;
  size_t smem = 0;
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = regs_resident(kernel, resident);
  if (err == cudaSuccess)
    err = plan_tile(B, H, R, lanes, unit, resident, device, strip, grid,
                    smem);
  if (err == cudaSuccess) err = allow_smem(kernel, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        THREADS, smem);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&out[2], cudaDevAttrMultiProcessorCount,
                                 device);
  out[0] = (int)(grid.x * grid.y * grid.z);
  out[1] = per_sm;
  out[3] = strip;
  out[4] = (int)smem;
  return (int)err;
}

}  // namespace vtw

// Instantiates KERNEL for the lane count of k (2..5 words for k = 10..40)
// whose strip-local tables take `unit` bytes a bin, plans its grid (each
// instance's register residency asked once) and launches it with its
// dynamic shared memory; the strip's height goes to the kernel as its
// last argument.
#define VTW_LAUNCH_TILE(lanes, unit, KERNEL, B, H, R, device, stream, ...)  \
  do {                                                                     \
    switch (lanes) {                                                       \
      VTW_TILE_CASE(2, unit, KERNEL, B, H, R, device, stream, __VA_ARGS__) \
      VTW_TILE_CASE(3, unit, KERNEL, B, H, R, device, stream, __VA_ARGS__) \
      VTW_TILE_CASE(4, unit, KERNEL, B, H, R, device, stream, __VA_ARGS__) \
      VTW_TILE_CASE(5, unit, KERNEL, B, H, R, device, stream, __VA_ARGS__) \
      default: return (int)cudaErrorInvalidValue;                          \
    }                                                                      \
  } while (0)
#define VTW_TILE_CASE(n, unit, KERNEL, B, H, R, device, stream, ...)       \
  case n: {                                                                \
    static int resident_ = 0;                                              \
    int strip_ = 0;                                                        \
    dim3 grid_;                                                            \
    size_t smem_ = 0;                                                      \
    cudaError_t e_ = resident_ ? cudaSuccess                               \
        : vtw::regs_resident((const void*)KERNEL<n>, resident_);           \
    if (e_ == cudaSuccess)                                                 \
      e_ = vtw::plan_tile(B, H, R, n, unit, resident_, device, strip_,     \
                          grid_, smem_);                                   \
    if (e_ == cudaSuccess)                                                 \
      e_ = vtw::allow_smem((const void*)KERNEL<n>, smem_);                 \
    if (e_ != cudaSuccess) return (int)e_;                                 \
    KERNEL<n><<<grid_, vtw::THREADS, smem_, stream>>>(__VA_ARGS__, strip_);\
    break;                                                                 \
  }
