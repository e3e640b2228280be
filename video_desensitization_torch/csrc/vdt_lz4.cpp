// Clean-room LZ4 *block* codec (the variant Apollo Cyber RT uses for
// COMPRESS_LZ4 record chunk bodies; the reference reads such records through
// the cyber_record package inside foreign/recordDeal.so, combine_detect.py:839).
// Implemented from the public LZ4 block format specification:
//   sequence := token | [lit-length ext bytes] | literals
//               | 2-byte LE offset | [match-length ext bytes]
//   token    := (literal_length:4 | (match_length - 4):4), 15 = extended
//   the final sequence is literals only; the last 5 bytes are literals and
//   the last match starts >= 12 bytes before the end of the block.
//
// API contract (ctypes-friendly):
//   decompress: returns decompressed size, -1 malformed, -2 dst too small.
//   compress:   returns compressed size, -1 if dst too small.

#include <cstdint>
#include <cstring>

namespace {

inline uint32_t read32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}

inline uint32_t hash32(uint32_t v) { return (v * 2654435761u) >> 20; }

}  // namespace

extern "C" {

long vdt_lz4_decompress(const uint8_t* src, long src_len, uint8_t* dst,
                        long dst_cap) {
  const uint8_t* ip = src;
  const uint8_t* iend = src + src_len;
  uint8_t* op = dst;
  uint8_t* oend = dst + dst_cap;
  while (ip < iend) {
    unsigned token = *ip++;
    long lit = token >> 4;
    if (lit == 15) {
      unsigned b;
      do {
        if (ip >= iend) return -1;
        b = *ip++;
        lit += b;
      } while (b == 255);
    }
    if (ip + lit > iend) return -1;
    if (op + lit > oend) return -2;
    std::memcpy(op, ip, lit);
    ip += lit;
    op += lit;
    if (ip >= iend) break;  // final literals-only sequence
    if (ip + 2 > iend) return -1;
    long offset = ip[0] | (ip[1] << 8);
    ip += 2;
    if (offset == 0 || op - dst < offset) return -1;
    long mlen = token & 15;
    if (mlen == 15) {
      unsigned b;
      do {
        if (ip >= iend) return -1;
        b = *ip++;
        mlen += b;
      } while (b == 255);
    }
    mlen += 4;
    if (op + mlen > oend) return -2;
    const uint8_t* match = op - offset;
    if (offset >= 8 && op + mlen + 8 <= oend) {
      // Chunked overlap-safe copy: each 8-byte block reads bytes at least
      // 8 behind the write cursor, so earlier blocks are already written.
      // May write up to 7 bytes past op+mlen (guarded above); the cursor
      // still advances exactly mlen, so the tail is overwritten next round.
      uint8_t* o = op;
      const uint8_t* m = match;
      for (long rem = mlen; rem > 0; rem -= 8, o += 8, m += 8)
        std::memcpy(o, m, 8);
    } else if (op + mlen + 8 <= oend) {
      // offset < 8 (period-`offset` pattern): byte-copy one pattern-aligned
      // head of k = offset*ceil(8/offset) >= 8 bytes, then chunk from a
      // read cursor k behind the write cursor (same pattern phase).
      const long k = offset * ((8 + offset - 1) / offset);
      const long head = (k < mlen) ? k : mlen;
      for (long i = 0; i < head; ++i) op[i] = match[i];
      uint8_t* o = op + head;
      const uint8_t* m = o - k;
      for (long rem = mlen - head; rem > 0; rem -= 8, o += 8, m += 8)
        std::memcpy(o, m, 8);
    } else {
      for (long i = 0; i < mlen; ++i) op[i] = match[i];  // overlap-safe
    }
    op += mlen;
  }
  return (long)(op - dst);
}

long vdt_lz4_compress_bound(long src_len) {
  return src_len + src_len / 255 + 16;
}

long vdt_lz4_compress(const uint8_t* src, long src_len, uint8_t* dst,
                      long dst_cap) {
  uint8_t* op = dst;
  uint8_t* oend = dst + dst_cap;
  long anchor = 0;
  if (src_len > 12) {
    static_assert(sizeof(int32_t) == 4, "table entry");
    int32_t table[1 << 12];
    for (auto& t : table) t = -1;
    const long mflimit = src_len - 12;  // last match starts >=12 from end
    long i = 0;
    // Skip acceleration (standard LZ4 heuristic): after repeated misses the
    // scan stride grows, so incompressible regions are crossed in O(n/step)
    // probes instead of one per byte. Output stays spec-valid — skipped
    // positions simply become literals.
    unsigned probe_count = 1u << 6;
    while (i < mflimit) {
      uint32_t h = hash32(read32(src + i));
      long cand = table[h];
      table[h] = (int32_t)i;
      if (cand >= 0 && i - cand <= 65535 &&
          read32(src + cand) == read32(src + i)) {
        probe_count = 1u << 6;
        long mlen = 4;
        const long maxm = src_len - 5 - i;  // keep last 5 bytes literal
        while (mlen < maxm && src[cand + mlen] == src[i + mlen]) ++mlen;
        const long lit = i - anchor;
        const long need = 1 + lit + lit / 255 + 2 + (mlen - 4) / 255 + 2;
        if (op + need > oend) return -1;
        uint8_t* token = op++;
        long l = lit;
        if (l >= 15) {
          *token = 15u << 4;
          l -= 15;
          while (l >= 255) {
            *op++ = 255;
            l -= 255;
          }
          *op++ = (uint8_t)l;
        } else {
          *token = (uint8_t)(l << 4);
        }
        std::memcpy(op, src + anchor, lit);
        op += lit;
        const long off = i - cand;
        *op++ = (uint8_t)(off & 255);
        *op++ = (uint8_t)((off >> 8) & 255);
        long m = mlen - 4;
        if (m >= 15) {
          *token |= 15;
          m -= 15;
          while (m >= 255) {
            *op++ = 255;
            m -= 255;
          }
          *op++ = (uint8_t)m;
        } else {
          *token |= (uint8_t)m;
        }
        i += mlen;
        anchor = i;
      } else {
        i += (long)(probe_count++ >> 6);
      }
    }
  }
  const long lit = src_len - anchor;
  const long need = 1 + lit + lit / 255 + 1;
  if (op + need > oend) return -1;
  if (lit >= 15) {
    *op++ = 15u << 4;
    long l = lit - 15;
    while (l >= 255) {
      *op++ = 255;
      l -= 255;
    }
    *op++ = (uint8_t)l;
  } else {
    *op++ = (uint8_t)(lit << 4);
  }
  std::memcpy(op, src + anchor, lit);
  op += lit;
  return (long)(op - dst);
}

}  // extern "C"
