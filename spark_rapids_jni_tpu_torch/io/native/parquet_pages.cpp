// Parquet page decoding loops that numpy cannot vectorize, for the port's
// host decoder (io/pages.py).  Built with g++ at first use
// (ops/_build.py build_host) and bound with ctypes.
//
//   * SNAPPY raw-block decompression (literals; copies with 1-, 2- and
//     4-byte offsets, overlapping copies included);
//   * the RLE / bit-packed hybrid (definition levels, dictionary indices,
//     RLE booleans), with an optional bound on every decoded value;
//   * the PLAIN BYTE_ARRAY splitter: 4-byte little-endian lengths, each
//     followed by its bytes, into offsets and one flat byte buffer;
//   * PLAIN BOOLEAN bit unpacking (LSB first);
//   * DELTA_BINARY_PACKED (blocks of miniblocks, widths 0..64, values
//     added with wrap-around), the DELTA_BYTE_ARRAY prefix/suffix join and
//     BYTE_STREAM_SPLIT's byte streams;
//   * LZ4 raw blocks and the Hadoop framing around them (LZ4 and LZ4_RAW
//     pages), with no library;
//   * the Dremel assembly of one leaf's repetition and definition levels
//     into every list level's offsets and every level's validity;
//   * big-endian two's-complement BYTE_ARRAY decimals into 128-bit limbs.
//
// Every function writes into buffers the caller allocated, checks every
// read against the input's length and every write against the output's
// capacity, and returns a negative code instead of reading or writing past
// a buffer.  Plain C++17, exported as a C ABI.

#include <cstdint>
#include <cstring>

namespace {

constexpr long ERR_TRUNCATED = -1;   // input ended inside an element
constexpr long ERR_OVERFLOW = -2;    // output capacity exceeded
constexpr long ERR_BAD_OFFSET = -3;  // snappy copy before the output start
constexpr long ERR_BAD_VALUE = -4;   // a value at or above its bound
constexpr long ERR_BAD_ARG = -5;     // bit width or count out of range
constexpr long ERR_BAD_LEVELS = -6;  // levels that do not nest

constexpr int MAX_NODES = 64;      // levels along one leaf's path

// unsigned LEB128 varint; returns false when it runs past the end
bool varint(const uint8_t* p, long n, long* pos, uint64_t* out) {
  uint64_t v = 0;
  for (int shift = 0; shift < 64; shift += 7) {
    if (*pos >= n) return false;
    uint8_t b = p[(*pos)++];
    v |= uint64_t(b & 0x7F) << shift;
    if (!(b & 0x80)) {
      *out = v;
      return true;
    }
  }
  return false;
}

// bits [bit, bit + w) of p[0, nbytes), LSB first; w in 1..64
inline uint64_t bits_at(const uint8_t* p, long bit, int w, long nbytes) {
  long at = bit >> 3;
  int sh = int(bit & 7);
  uint64_t lo = 0;
  if (at + 8 <= nbytes) {
    std::memcpy(&lo, p + at, 8);
  } else {
    for (long b = 0; b < 8 && at + b < nbytes; b++)
      lo |= uint64_t(p[at + b]) << (8 * b);
  }
  uint64_t v = lo >> sh;
  if (sh && sh + w > 64 && at + 8 < nbytes)
    v |= uint64_t(p[at + 8]) << (64 - sh);
  return w == 64 ? v : v & ((uint64_t(1) << w) - 1);
}

bool zigzag_varint(const uint8_t* p, long n, long* pos, uint64_t* out) {
  uint64_t v;
  if (!varint(p, n, pos, &v)) return false;
  *out = (v >> 1) ^ (~(v & 1) + 1);
  return true;
}

// one LZ4 block into dst[0, cap): the bytes written, or a negative code
long lz4_block(const uint8_t* src, long n, uint8_t* dst, long cap) {
  long pos = 0, out = 0;
  while (pos < n) {
    uint8_t token = src[pos++];
    long lit = token >> 4;
    if (lit == 15) {
      uint8_t b;
      do {
        if (pos >= n) return ERR_TRUNCATED;
        b = src[pos++];
        lit += b;
      } while (b == 255 && lit < (long(1) << 40));
    }
    if (lit > n - pos) return ERR_TRUNCATED;
    if (lit > cap - out) return ERR_OVERFLOW;
    std::memcpy(dst + out, src + pos, size_t(lit));
    pos += lit;
    out += lit;
    if (pos == n) break;  // the last sequence holds literals only
    if (2 > n - pos) return ERR_TRUNCATED;
    long off = long(src[pos]) | (long(src[pos + 1]) << 8);
    pos += 2;
    if (off == 0 || off > out) return ERR_BAD_OFFSET;
    long len = token & 15;
    if (len == 15) {
      uint8_t b;
      do {
        if (pos >= n) return ERR_TRUNCATED;
        b = src[pos++];
        len += b;
      } while (b == 255 && len < (long(1) << 40));
    }
    len += 4;
    if (len > cap - out) return ERR_OVERFLOW;
    uint8_t* d = dst + out;
    const uint8_t* s = d - off;
    if (off >= len) {
      std::memcpy(d, s, size_t(len));
    } else {
      for (long k = 0; k < len; k++) d[k] = s[k];
    }
    out += len;
  }
  return out;
}

uint32_t be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

}  // namespace

extern "C" {

// The uncompressed length a snappy block announces, or a negative code.
long pqp_snappy_length(const uint8_t* src, long n) {
  long pos = 0;
  uint64_t len = 0;
  if (!varint(src, n, &pos, &len) || len > (uint64_t(1) << 40))
    return ERR_TRUNCATED;
  return long(len);
}

// Decompress one snappy raw block into dst[0, cap); returns the bytes
// written (which must equal the announced length) or a negative code.
long pqp_snappy_decompress(const uint8_t* src, long n, uint8_t* dst,
                           long cap) {
  long pos = 0;
  uint64_t want = 0;
  if (!varint(src, n, &pos, &want)) return ERR_TRUNCATED;
  if (long(want) > cap) return ERR_OVERFLOW;
  long out = 0;
  while (pos < n) {
    uint8_t tag = src[pos++];
    long len, off;
    switch (tag & 3) {
      case 0: {  // literal
        len = tag >> 2;
        if (len >= 60) {
          int extra = int(len - 59);
          if (pos + extra > n) return ERR_TRUNCATED;
          len = 0;
          for (int k = 0; k < extra; k++) len |= long(src[pos + k]) << (8 * k);
          pos += extra;
        }
        len += 1;
        if (len > n - pos) return ERR_TRUNCATED;
        if (len > long(want) - out) return ERR_OVERFLOW;
        std::memcpy(dst + out, src + pos, size_t(len));
        pos += len;
        out += len;
        continue;
      }
      case 1:  // copy, 1-byte offset
        if (pos + 1 > n) return ERR_TRUNCATED;
        len = 4 + ((tag >> 2) & 7);
        off = (long(tag >> 5) << 8) | src[pos];
        pos += 1;
        break;
      case 2:  // copy, 2-byte offset
        if (pos + 2 > n) return ERR_TRUNCATED;
        len = 1 + (tag >> 2);
        off = long(src[pos]) | (long(src[pos + 1]) << 8);
        pos += 2;
        break;
      default:  // copy, 4-byte offset
        if (pos + 4 > n) return ERR_TRUNCATED;
        len = 1 + (tag >> 2);
        off = long(src[pos]) | (long(src[pos + 1]) << 8) |
              (long(src[pos + 2]) << 16) | (long(src[pos + 3]) << 24);
        pos += 4;
        break;
    }
    if (off <= 0 || off > out) return ERR_BAD_OFFSET;
    if (len > long(want) - out) return ERR_OVERFLOW;
    uint8_t* d = dst + out;
    const uint8_t* s = d - off;
    if (off >= len) {
      std::memcpy(d, s, size_t(len));
    } else {
      // overlapping copy: a run repeating the last `off` bytes
      for (long k = 0; k < len; k++) d[k] = s[k];
    }
    out += len;
  }
  return out == long(want) ? out : ERR_TRUNCATED;
}

// Decode `count` values of the RLE / bit-packed hybrid at `bit_width`
// (0..32) into out[0, count).  With `bound` > 0 every value must be below
// it (dictionary indices).  Returns the input bytes consumed, or a negative
// code.  A last bit-packed group may stop at the bytes its used values
// need (some writers do not pad it).
long pqp_rle_decode(const uint8_t* src, long n, int bit_width, int32_t* out,
                    long count, long bound) {
  if (bit_width < 0 || bit_width > 32 || count < 0) return ERR_BAD_ARG;
  const uint64_t mask =
      bit_width == 32 ? 0xFFFFFFFFull : ((uint64_t(1) << bit_width) - 1);
  const uint64_t limit = bound > 0 ? uint64_t(bound) : (uint64_t(1) << 33);
  const long value_bytes = (bit_width + 7) / 8;
  long pos = 0, got = 0;
  while (got < count) {
    uint64_t header = 0;
    if (!varint(src, n, &pos, &header)) return ERR_TRUNCATED;
    if (header & 1) {  // bit-packed: (header >> 1) groups of 8 values
      uint64_t groups = header >> 1;
      if (groups > uint64_t(n) + 1) return ERR_TRUNCATED;
      long values = long(groups) * 8;
      long take = values < count - got ? values : count - got;
      long full = long(groups) * bit_width;
      long need = (take * bit_width + 7) / 8;
      if (need > n - pos) return ERR_TRUNCATED;
      const uint8_t* p = src + pos;
      if (bit_width == 0) {  // every value is 0, below any bound
        for (long k = 0; k < take; k++) out[got + k] = 0;
      } else {
        // value k sits at bit k * bit_width: one unaligned 8-byte load
        // covers it (width <= 32, shift <= 7) while 8 bytes remain
        long fast = need >= 8 ? ((need - 8) * 8) / bit_width : 0;
        if (fast > take) fast = take;
        for (long k = 0; k < fast; k++) {
          long bit = k * bit_width;
          uint64_t word;
          std::memcpy(&word, p + (bit >> 3), 8);
          uint64_t v = (word >> (bit & 7)) & mask;
          if (v >= limit) return ERR_BAD_VALUE;
          out[got + k] = int32_t(uint32_t(v));
        }
        for (long k = fast; k < take; k++) {  // the tail, byte by byte
          long bit = k * bit_width;
          long at = bit >> 3;
          uint64_t word = 0;
          for (long b = 0; b < 8 && at + b < need; b++)
            word |= uint64_t(p[at + b]) << (8 * b);
          uint64_t v = (word >> (bit & 7)) & mask;
          if (v >= limit) return ERR_BAD_VALUE;
          out[got + k] = int32_t(uint32_t(v));
        }
      }
      got += take;
      pos += full < n - pos ? full : n - pos;
    } else {  // RLE: (header >> 1) repeats of one value
      uint64_t run = header >> 1;
      if (value_bytes > n - pos) return ERR_TRUNCATED;
      uint64_t v = 0;
      for (long k = 0; k < value_bytes; k++)
        v |= uint64_t(src[pos + k]) << (8 * k);
      pos += value_bytes;
      v &= mask;
      long take = run < uint64_t(count - got) ? long(run) : count - got;
      if (take > 0 && v >= limit) return ERR_BAD_VALUE;
      int32_t w = int32_t(uint32_t(v));
      for (long k = 0; k < take; k++) out[got + k] = w;
      got += take;
    }
    // every pass consumed at least its header byte: the loop ends
  }
  return pos;
}

// Split `count` PLAIN BYTE_ARRAY values: offsets[0, count] into data,
// data[0, data_cap) the values' bytes back to back.  Returns the input
// bytes consumed, or a negative code.
long pqp_byte_array_split(const uint8_t* src, long n, long count,
                          int64_t* offsets, uint8_t* data, long data_cap) {
  if (count < 0) return ERR_BAD_ARG;
  long pos = 0, at = 0;
  for (long i = 0; i < count; i++) {
    if (4 > n - pos) return ERR_TRUNCATED;
    uint32_t len = uint32_t(src[pos]) | (uint32_t(src[pos + 1]) << 8) |
                   (uint32_t(src[pos + 2]) << 16) |
                   (uint32_t(src[pos + 3]) << 24);
    pos += 4;
    if (long(len) > n - pos) return ERR_TRUNCATED;
    if (long(len) > data_cap - at) return ERR_OVERFLOW;
    offsets[i] = at;
    std::memcpy(data + at, src + pos, len);
    pos += len;
    at += len;
  }
  offsets[count] = at;
  return pos;
}

// Unpack `count` PLAIN BOOLEAN values (bit i of byte i / 8, LSB first)
// into out[0, count) as 0/1 bytes.  Returns the input bytes consumed.
long pqp_unpack_bools(const uint8_t* src, long n, uint8_t* out, long count) {
  if (count < 0) return ERR_BAD_ARG;
  long need = (count + 7) / 8;
  if (need > n) return ERR_TRUNCATED;
  for (long i = 0; i < count; i++) out[i] = (src[i >> 3] >> (i & 7)) & 1;
  return need;
}

// The value count a DELTA_BINARY_PACKED header announces, or a negative
// code.
long pqp_delta_count(const uint8_t* src, long n) {
  long pos = 0;
  uint64_t block, minis, total;
  if (!varint(src, n, &pos, &block) || !varint(src, n, &pos, &minis) ||
      !varint(src, n, &pos, &total))
    return ERR_TRUNCATED;
  if (total > (uint64_t(1) << 40)) return ERR_BAD_ARG;
  return long(total);
}

// Decode `count` DELTA_BINARY_PACKED values (the header's count must be at
// least that) into out[0, count) as 64-bit values added with wrap-around
// (an INT32 column keeps their low 32 bits).  Returns the input bytes the
// header's values take: a last block stops after its last needed
// miniblock, and a last miniblock may stop at the bytes its values need.
long pqp_delta_binary_packed(const uint8_t* src, long n, int64_t* out,
                             long count) {
  if (count < 0) return ERR_BAD_ARG;
  long pos = 0;
  uint64_t block, minis, total, first;
  if (!varint(src, n, &pos, &block) || !varint(src, n, &pos, &minis) ||
      !varint(src, n, &pos, &total) || !zigzag_varint(src, n, &pos, &first))
    return ERR_TRUNCATED;
  if (block == 0 || block % 128 || minis == 0 || block % minis ||
      (block / minis) % 32 || block > (uint64_t(1) << 30))
    return ERR_BAD_ARG;
  if (total < uint64_t(count) || total > (uint64_t(1) << 40))
    return ERR_BAD_ARG;
  const long per_mini = long(block / minis);
  const long want = long(total);
  uint64_t last = first;
  if (count > 0) out[0] = int64_t(first);
  long got = want > 0 ? 1 : 0;
  while (got < want) {
    uint64_t min_delta;
    if (!zigzag_varint(src, n, &pos, &min_delta)) return ERR_TRUNCATED;
    if (long(minis) > n - pos) return ERR_TRUNCATED;
    const uint8_t* widths = src + pos;
    pos += long(minis);
    for (long m = 0; m < long(minis) && got < want; m++) {
      int w = widths[m];
      if (w > 64) return ERR_BAD_ARG;
      long take = per_mini < want - got ? per_mini : want - got;
      long full = per_mini / 8 * w;  // a miniblock's bytes
      long need = (take * w + 7) / 8;
      if (need > n - pos) return ERR_TRUNCATED;
      const uint8_t* p = src + pos;
      for (long k = 0; k < take; k++) {
        uint64_t v = w ? bits_at(p, k * w, w, need) : 0;
        last += min_delta + v;  // wraps, as the writer's arithmetic
        if (got + k < count) out[got + k] = int64_t(last);
      }
      got += take;
      pos += full < n - pos ? full : n - pos;
    }
  }
  return pos;
}

// DELTA_BYTE_ARRAY: value i is the first prefix[i] bytes of value i - 1
// followed by suffix i (suffix_len[i] bytes of `suffixes`, back to back).
// Writes offsets[0, count] into data[0, data_cap).  Returns the bytes
// written, or a negative code.
long pqp_delta_byte_array(const int64_t* prefix, const int64_t* suffix_len,
                          long count, const uint8_t* suffixes, long suffix_n,
                          int64_t* offsets, uint8_t* data, long data_cap) {
  if (count < 0) return ERR_BAD_ARG;
  long at = 0, from = 0, prev = 0, prev_len = 0;
  for (long i = 0; i < count; i++) {
    long p = long(prefix[i]), s = long(suffix_len[i]);
    if (p < 0 || s < 0 || p > prev_len) return ERR_BAD_VALUE;
    if (s > suffix_n - from) return ERR_TRUNCATED;
    if (p + s > data_cap - at) return ERR_OVERFLOW;
    offsets[i] = at;
    std::memmove(data + at, data + prev, size_t(p));
    std::memcpy(data + at + p, suffixes + from, size_t(s));
    prev = at;
    prev_len = p + s;
    at += p + s;
    from += s;
  }
  offsets[count] = at;
  return at;
}

// BYTE_STREAM_SPLIT: `width` streams of n / width bytes each, stream k
// holding byte k of every value; the first `count` values go to
// out[0, count * width).  Returns the input bytes, or a negative code.
long pqp_byte_stream_split(const uint8_t* src, long n, int width, long count,
                           uint8_t* out) {
  if (width <= 0 || count < 0 || n % width) return ERR_BAD_ARG;
  long stride = n / width;
  if (count > stride) return ERR_TRUNCATED;
  for (int k = 0; k < width; k++) {
    const uint8_t* s = src + long(k) * stride;
    for (long i = 0; i < count; i++) out[i * width + k] = s[i];
  }
  return n;
}

// An LZ4_RAW page: one LZ4 block.  Returns the bytes written, or a
// negative code.
long pqp_lz4_raw(const uint8_t* src, long n, uint8_t* dst, long cap) {
  return lz4_block(src, n, dst, cap);
}

// An LZ4 (Hadoop) page: frames of a big-endian decompressed size, a
// big-endian compressed size and one LZ4 block, as parquet-cpp tries them
// first.  Returns the bytes written, or a negative code (the caller then
// reads the page as one raw block, as parquet-cpp does).
long pqp_lz4_hadoop(const uint8_t* src, long n, uint8_t* dst, long cap) {
  long pos = 0, out = 0;
  while (n - pos >= 8) {
    long usize = long(be32(src + pos)), csize = long(be32(src + pos + 4));
    pos += 8;
    if (csize > n - pos || usize > cap - out) return ERR_TRUNCATED;
    long got = lz4_block(src + pos, csize, dst + out, usize);
    if (got != usize) return got < 0 ? got : ERR_TRUNCATED;
    pos += csize;
    out += usize;
  }
  return pos == n ? out : ERR_TRUNCATED;
}

// Dremel assembly of one leaf's levels rep[0, n), def[0, n) (either null:
// all zero) along the nodes of its path, top first: kind[j] (0 leaf,
// 1 struct, 2 list), space[j] (the lists above it), def_level[j] (the
// definition level at which it is present), and for a list elem_def[j]
// (the level at which it has an element).  Each entry starts a slot at a
// node of space s when s == 0 and rep == 0, or when rep <= s and the
// element of the list of space s exists.  A slot is present when def >=
// def_level; a list slot records where its elements start.  Writes
// present[j][0, counts[j]) and for a list offsets[j][0, counts[j]];
// capacities n and n + 1.  Returns 0 or a negative code.
long pqp_assemble_levels(const int32_t* rep, const int32_t* def, long n,
                         int nodes, const int32_t* kind,
                         const int32_t* space, const int32_t* def_level,
                         const int32_t* elem_def, uint8_t* const* present,
                         int32_t* const* offsets,
                         long* counts) {
  if (n < 0 || nodes <= 0 || nodes > MAX_NODES) return ERR_BAD_ARG;
  int32_t sed[MAX_NODES + 1];  // elem_def of the list of each space
  int spaces = 0;
  for (int j = 0; j < nodes; j++) {
    if (space[j] != spaces || kind[j] < 0 || kind[j] > 2) return ERR_BAD_ARG;
    if ((kind[j] == 0) != (j == nodes - 1)) return ERR_BAD_ARG;
    if (kind[j] == 2) {
      if (!offsets[j]) return ERR_BAD_ARG;
      sed[++spaces] = elem_def[j];
    }
    counts[j] = 0;
  }
  int64_t elems[MAX_NODES + 2] = {0};
  for (long i = 0; i < n; i++) {
    int32_t r = rep ? rep[i] : 0, d = def ? def[i] : 0;
    if (r < 0 || r > spaces || (i == 0 && r != 0)) return ERR_BAD_LEVELS;
    if (r > 0 && d < sed[r]) return ERR_BAD_LEVELS;
    for (int j = 0; j < nodes; j++) {
      int s = space[j];
      bool created = s == 0 ? r == 0 : (r <= s && d >= sed[s]);
      if (!created) continue;
      long c = counts[j]++;
      present[j][c] = uint8_t(d >= def_level[j]);
      if (kind[j] == 2) {
        if (elems[s + 1] > INT32_MAX) return ERR_OVERFLOW;
        offsets[j][c] = int32_t(elems[s + 1]);
      }
    }
    for (int s = 1; s <= spaces; s++)
      if (r <= s && d >= sed[s]) elems[s]++;
  }
  for (int j = 0; j < nodes; j++) {
    if (kind[j] != 2) continue;
    if (elems[space[j] + 1] > INT32_MAX) return ERR_OVERFLOW;
    offsets[j][counts[j]] = int32_t(elems[space[j] + 1]);
  }
  return 0;
}

// Big-endian two's-complement decimals (value i is data[offsets[i],
// offsets[i + 1]), 1 to 16 bytes) into little-endian 128-bit limbs
// out[2 i], out[2 i + 1].  Returns 0 or a negative code.
long pqp_be_decimal_limbs(const int64_t* offsets, const uint8_t* data,
                          long data_n, long count, uint64_t* out) {
  if (count < 0) return ERR_BAD_ARG;
  for (long i = 0; i < count; i++) {
    long a = long(offsets[i]), b = long(offsets[i + 1]);
    if (a < 0 || b < a || b > data_n) return ERR_TRUNCATED;
    long len = b - a;
    if (len < 1 || len > 16) return ERR_BAD_ARG;
    uint8_t le[16];
    uint8_t fill = (data[a] & 0x80) ? 0xFF : 0x00;
    for (long k = 0; k < 16; k++)
      le[k] = k < len ? data[b - 1 - k] : fill;
    std::memcpy(out + 2 * i, le, 16);
  }
  return 0;
}

}  // extern "C"
