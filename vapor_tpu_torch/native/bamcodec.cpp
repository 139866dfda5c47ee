// Native BAM/BGZF decoder: the host-side native component of
// vapor_tpu_torch (BGZF inflate via zlib, record parse and region
// filter), exposed over a plain C ABI and bound with ctypes
// (vapor_tpu_torch/native/__init__.py builds it with g++ at first use).
//
// Semantics mirror the pure-Python decoder of vapor_tpu_torch/io/bam.py
// exactly (htslib-style overlap: pos0 < end0 && endpos0 > beg0, file
// order); differential-tested in tests/test_torch_native_bam.py.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

#include <zlib.h>

namespace {

struct Buf {
  std::vector<uint8_t> data;
};

bool inflate_block(const uint8_t* src, size_t src_len, size_t* bsize,
                   std::vector<uint8_t>* out) {
  if (src_len < 18 || src[0] != 0x1f || src[1] != 0x8b) return false;
  uint16_t xlen;
  std::memcpy(&xlen, src + 10, 2);
  const uint8_t* extra = src + 12;
  size_t bs = 0;
  for (size_t e = 0; e + 4 <= xlen;) {
    uint8_t si1 = extra[e], si2 = extra[e + 1];
    uint16_t slen;
    std::memcpy(&slen, extra + e + 2, 2);
    if (si1 == 0x42 && si2 == 0x43 && slen == 2) {
      uint16_t v;
      std::memcpy(&v, extra + e + 4, 2);
      bs = static_cast<size_t>(v) + 1;
    }
    e += 4 + slen;
  }
  if (bs == 0 || bs > src_len) return false;
  uint32_t isize;
  std::memcpy(&isize, src + bs - 4, 4);
  size_t off = out->size();
  out->resize(off + isize);
  if (isize > 0) {
    z_stream zs;
    std::memset(&zs, 0, sizeof(zs));
    if (inflateInit2(&zs, -15) != Z_OK) return false;
    zs.next_in = const_cast<uint8_t*>(src + 12 + xlen);
    zs.avail_in = static_cast<uInt>(bs - 12 - xlen - 8);
    zs.next_out = out->data() + off;
    zs.avail_out = isize;
    int rc = inflate(&zs, Z_FINISH);
    inflateEnd(&zs);
    if (rc != Z_STREAM_END && rc != Z_OK) return false;
  }
  *bsize = bs;
  return true;
}

const char CIGAR_OPS[] = "MIDNSHP=X";
const char SEQ_NIBBLE[] = "=ACMGRSVTWYHKDBN";

}  // namespace

extern "C" {

// Decompress an entire BGZF file image.  Returns a malloc'd buffer the
// caller releases with vapor_free(); *out_len receives its size.
// Returns nullptr on malformed input.
uint8_t* vapor_bgzf_decompress(const uint8_t* data, size_t len,
                               size_t* out_len) {
  std::vector<uint8_t> out;
  out.reserve(len * 3);
  size_t pos = 0;
  while (pos < len) {
    size_t bsize = 0;
    if (!inflate_block(data + pos, len - pos, &bsize, &out)) return nullptr;
    pos += bsize;
  }
  uint8_t* buf = static_cast<uint8_t*>(std::malloc(out.size()));
  if (!buf) return nullptr;
  std::memcpy(buf, out.data(), out.size());
  *out_len = out.size();
  return buf;
}

// Scan decompressed BAM bytes for records on ref_id overlapping
// [beg0, end0) and serialize matches as
// "name\tflag\tpos0\tmapq\tcigar\tseq\n" lines (file order).
// records_start: byte offset of the first alignment record.
// Returns a malloc'd NUL-terminated string (vapor_free to release).
char* vapor_bam_query(const uint8_t* bam, size_t len, size_t records_start,
                      int32_t ref_id, int64_t beg0, int64_t end0) {
  std::string out;
  size_t off = records_start;
  while (off + 4 <= len) {
    int32_t block_size;
    std::memcpy(&block_size, bam + off, 4);
    if (block_size < 32 || off + 4 + block_size > len) break;
    const uint8_t* r = bam + off + 4;
    int32_t rid, pos;
    std::memcpy(&rid, r, 4);
    std::memcpy(&pos, r + 4, 4);
    off += 4 + static_cast<size_t>(block_size);
    if (rid != ref_id) continue;
    if (pos >= end0) continue;
    uint8_t l_read_name = r[8];
    uint8_t mapq = r[9];
    uint16_t n_cigar, flag;
    std::memcpy(&n_cigar, r + 12, 2);
    std::memcpy(&flag, r + 14, 2);
    int32_t l_seq;
    std::memcpy(&l_seq, r + 16, 4);
    const uint8_t* p = r + 32;
    const char* name = reinterpret_cast<const char*>(p);
    p += l_read_name;
    // reference span from CIGAR
    int64_t ref_len = 0;
    std::string cigar;
    cigar.reserve(n_cigar * 4);
    for (int i = 0; i < n_cigar; i++) {
      uint32_t v;
      std::memcpy(&v, p + 4 * i, 4);
      uint32_t n = v >> 4;
      char op = CIGAR_OPS[v & 0xF];
      if (op == 'M' || op == 'D' || op == 'N' || op == '=' || op == 'X')
        ref_len += n;
      char tmp[16];
      int w = std::snprintf(tmp, sizeof(tmp), "%u%c", n, op);
      cigar.append(tmp, w);
    }
    if (n_cigar == 0) cigar = "*";
    p += 4 * static_cast<size_t>(n_cigar);
    int64_t endpos = pos + ref_len;
    if (!(endpos > beg0 && pos < end0)) continue;
    // decode 4-bit packed sequence
    std::string seq;
    seq.resize(l_seq);
    for (int i = 0; i < l_seq; i++) {
      uint8_t b = p[i >> 1];
      seq[i] = SEQ_NIBBLE[(i % 2 == 0) ? (b >> 4) : (b & 0xF)];
    }
    char head[64];
    int w = std::snprintf(head, sizeof(head), "\t%u\t%d\t%u\t", flag, pos,
                          mapq);
    out.append(name);
    out.append(head, w);
    out.append(cigar);
    out.push_back('\t');
    out.append(seq);
    out.push_back('\n');
  }
  char* buf = static_cast<char*>(std::malloc(out.size() + 1));
  if (!buf) return nullptr;
  std::memcpy(buf, out.c_str(), out.size() + 1);
  return buf;
}

void vapor_free(void* p) { std::free(p); }

}  // extern "C"
