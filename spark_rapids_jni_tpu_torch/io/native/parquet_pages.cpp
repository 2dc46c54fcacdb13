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
//   * PLAIN BOOLEAN bit unpacking (LSB first).
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

}  // extern "C"
