// codes: the packed k-mer codes every dot-plot kernel compares.
//
// Replaces: the XLA fusion of _pack_codes, _rc_dot_codes and
// _derive_rc_row (vapor_tpu/engine/fused.py:166, :219, :347) inside the
// JAX engine's jitted _fused_one; in the port, the torch-op sequence of
// kernels.pack_codes, derive_rc_rows and rc_dot_codes (row_codes_plain).
// Output, in one launch:
//
// * ch (Bh, lanes, H): ch[r, l, i] packs hap symbols i + 8l .. i + 8l +
//   n_l - 1 (n_l = min(8, k - 8l)), 4 bits each, the t-th at bit 4t, of
//   hap row r (haps[hap_index[r]] when hap_index is given, Bh = B; else
//   haps[r], Bh = U); positions past H pack HAP_PAD's symbol;
// * cf (B, lanes, R): the same for the forward reads, READ_PAD past R;
// * cd (B, lanes, R): the reverse strand in dot-space columns, computed
//   from the forward read: the reverse-complement row is rc[q] =
//   COMP[read[rlen - 1 - q]] for q < rlen and READ_PAD after, its packed
//   codes crc[l, q] (READ_PAD past R), and cd[l, j] = crc[l, R - 1 - p]
//   with p = (off + j) mod R, off = clamp(R - 1 + k - rlen, 0, R): the
//   doubled reversed row read from off, so every column, the ones past
//   rlen - k that no kernel reads included, equals the plain version bit
//   for bit.  The rc row never exists in device memory.
//
// Symbols come from NIB (constants.NIB_LUT) and, for the reverse strand,
// NIBC (NIB of oracle._COMP_LUT), both in constant memory; a CPU test
// (tests/test_torch_glue.py) holds both tables and the pads to the
// Python ones.  Each word is written as the 32 bits the plain version's
// int32 holds.
//
// Bound on the H100: bytes.  A word is 4 bytes written from at most 8
// bytes read, which neighbouring threads share through L1; a shift and
// an or per symbol is far below the integer rate.
//
// Design: one thread per output word, the word index running fastest
// along a row's positions, so a warp writes 128 contiguous bytes.  All
// three arrays are one 1-D grid; every word is written, so the outputs
// need no zeroing.
//
// Preconditions, as the plain version's index_select and gather hold
// them: hap_index in [0, U) and rlens in [0, R].  A device assert checks
// both, so a bad row stops the launch with a device-side assert, as the
// plain version's torch ops do on the card, and never reads outside its
// row.
#include <assert.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int HAP_PAD = 255;
constexpr int READ_PAD = 253;

__constant__ uint8_t NIB[256] = {
    15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15,
    15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15,
    15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15,
    15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 12, 15, 15,
    15, 0, 15, 1, 15, 15, 15, 2, 15, 15, 15, 15, 15, 15, 4, 15,
    15, 15, 15, 15, 3, 15, 15, 15, 10, 15, 15, 15, 15, 15, 15, 15,
    15, 5, 15, 6, 15, 15, 15, 7, 15, 15, 15, 15, 15, 15, 9, 15,
    15, 15, 15, 15, 8, 15, 15, 15, 11, 15, 15, 15, 15, 15, 15, 15,
    15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15,
    15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15,
    15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15,
    15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15,
    15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15,
    15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15,
    15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15,
    15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 14, 15, 13,
};

__constant__ uint8_t NIBC[256] = {
    15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15,
    15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15,
    15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15,
    15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15,
    15, 3, 15, 2, 15, 15, 15, 1, 15, 15, 15, 15, 15, 15, 4, 15,
    15, 15, 15, 15, 0, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15,
    15, 8, 15, 7, 15, 15, 15, 6, 15, 15, 15, 15, 15, 15, 9, 15,
    15, 15, 15, 15, 5, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15,
    15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15,
    15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15,
    15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15,
    15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15,
    15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15,
    15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15,
    15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15,
    15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15,
};

// symbols seq[p .. p + n) of a row of length L, past L the pad's
__device__ __forceinline__ unsigned pack_row(const uint8_t* seq, int L,
                                             int p, int n, unsigned pad) {
  unsigned acc = 0;
  for (int t = 0; t < n; ++t) {
    const int x = p + t;
    acc |= (x < L ? (unsigned)NIB[seq[x]] : pad) << (4 * t);
  }
  return acc;
}

__global__ void __launch_bounds__(THREADS) row_codes_kernel(
    const uint8_t* haps, const uint8_t* reads, const int* rlens,
    const long long* hap_index, int U, int Bh, int B, int H, int R,
    int lanes, int k, unsigned* ch, unsigned* cf, unsigned* cd) {
  const long long n_ch = (long long)Bh * lanes * H;
  const long long n_cf = (long long)B * lanes * R;
  long long w = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (w < n_ch) {
    const int i = (int)(w % H);
    const long long rl = w / H;
    const int lane = (int)(rl % lanes), r = (int)(rl / lanes);
    const long long src = hap_index ? hap_index[r] : r;
    assert(src >= 0 && src < U);
    ch[w] = pack_row(haps + src * H, H, i + 8 * lane,
                     min(8, k - 8 * lane), NIB[HAP_PAD]);
    return;
  }
  w -= n_ch;
  const bool fw = w < n_cf;
  if (!fw) w -= n_cf;
  if (w >= n_cf) return;
  const int j = (int)(w % R);
  const long long rl = w / R;
  const int lane = (int)(rl % lanes), b = (int)(rl / lanes);
  const uint8_t* read = reads + (long long)b * R;
  const int n = min(8, k - 8 * lane);
  if (fw) {
    cf[w] = pack_row(read, R, j + 8 * lane, n, NIB[READ_PAD]);
    return;
  }
  // the reverse strand: crc's column q, read through the rc row's
  // definition
  const int rlen = rlens[b];
  assert(rlen >= 0 && rlen <= R);
  const int off = min(max(R - 1 + k - rlen, 0), R);
  const int q = R - 1 - (off + j) % R;
  unsigned acc = 0;
  for (int t = 0; t < n; ++t) {
    const int x = q + 8 * lane + t;
    acc |= (x < rlen ? (unsigned)NIBC[read[rlen - 1 - x]]
                    : (unsigned)NIB[READ_PAD]) << (4 * t);
  }
  cd[w] = acc;
}

}  // namespace

extern "C" int vt_row_codes(const void* haps, const void* reads,
                            const void* rlens, const void* hap_index,
                            int U, int B, int H, int R, int lanes, int k,
                            void* ch, void* cf, void* cd, int device,
                            void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int Bh = hap_index ? B : U;
  const long long words =
      (long long)Bh * lanes * H + 2LL * B * lanes * R;
  if (words == 0) return 0;
  const long long blocks = (words + THREADS - 1) / THREADS;
  row_codes_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)haps, (const uint8_t*)reads, (const int*)rlens,
      (const long long*)hap_index, U, Bh, B, H, R, lanes, k, (unsigned*)ch,
      (unsigned*)cf, (unsigned*)cd);
  return (int)cudaGetLastError();
}
