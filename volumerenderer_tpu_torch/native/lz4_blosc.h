// Minimal LZ4-block + Blosc1-frame decoders for VDB ingestion.
//
// OpenVDB files compress leaf buffers with zlib or Blosc(+LZ4shuffle);
// this header provides the decompression half from scratch (the image has
// no blosc library).  Original implementation written from the public
// format descriptions:
//   LZ4 block: sequences of [token][literals][offset][match] with 4-bit
//   literal/match length nibbles and 0xFF extension bytes; matches may
//   overlap the output (copy byte-wise).
//   Blosc1 frame: 16-byte header {version, versionlz, flags, typesize,
//   nbytes(i32), blocksize(i32), cbytes(i32)} followed by a block index of
//   int32 offsets (one per block) and per-block [i32 compressed-size]
//   chunks; flags per the c-blosc header spec: bit0 = byte-shuffle
//   (BLOSC_DOSHUFFLE), bit1 = memcpy'ed frame (BLOSC_MEMCPYED), bit2 =
//   bit-shuffle (BLOSC_DOBITSHUFFLE, unsupported here), bits 5-7 = codec
//   id (0 == blosclz, 1 == lz4/lz4hc, 2 == snappy, 3 == zlib, 4 == zstd).
//
// Reference parity: the upstream renderer links the real OpenVDB/Blosc
// stack (src/main.cpp:1157-1215); this is the TPU build's dependency-free
// equivalent for the host ingestion path.

#pragma once

#include <cstdint>
#include <cstring>
#include <vector>

namespace vdbio {

// Decompress one raw LZ4 block. Returns bytes written, or -1 on error.
inline int64_t lz4_decompress_block(const uint8_t* src, int64_t src_len,
                                    uint8_t* dst, int64_t dst_cap) {
  const uint8_t* sp = src;
  const uint8_t* send = src + src_len;
  uint8_t* dp = dst;
  uint8_t* dend = dst + dst_cap;
  while (sp < send) {
    uint8_t token = *sp++;
    // Literals
    int64_t lit = token >> 4;
    if (lit == 15) {
      uint8_t b;
      do {
        if (sp >= send) return -1;
        b = *sp++;
        lit += b;
      } while (b == 255);
    }
    if (sp + lit > send || dp + lit > dend) return -1;
    std::memcpy(dp, sp, lit);
    sp += lit;
    dp += lit;
    if (sp >= send) break;  // last sequence has no match
    // Match
    if (sp + 2 > send) return -1;
    uint16_t offset = (uint16_t)(sp[0] | (sp[1] << 8));
    sp += 2;
    if (offset == 0) return -1;
    int64_t mlen = (token & 0xF);
    if (mlen == 15) {
      uint8_t b;
      do {
        if (sp >= send) return -1;
        b = *sp++;
        mlen += b;
      } while (b == 255);
    }
    mlen += 4;
    const uint8_t* mp = dp - offset;
    if (mp < dst || dp + mlen > dend) return -1;
    for (int64_t i = 0; i < mlen; ++i) dp[i] = mp[i];  // overlap-safe
    dp += mlen;
  }
  return dp - dst;
}

// Undo blosc byte-shuffle: input laid out as typesize planes.
inline void blosc_unshuffle(const uint8_t* src, uint8_t* dst, int64_t nbytes,
                            int typesize) {
  if (typesize <= 1) {
    std::memcpy(dst, src, nbytes);
    return;
  }
  int64_t n = nbytes / typesize;
  int64_t tail = nbytes - n * typesize;
  for (int t = 0; t < typesize; ++t)
    for (int64_t i = 0; i < n; ++i) dst[i * typesize + t] = src[t * n + i];
  if (tail) std::memcpy(dst + n * typesize, src + n * typesize, tail);
}

inline int32_t rd_i32(const uint8_t* p) {
  int32_t v;
  std::memcpy(&v, p, 4);
  return v;
}

// Decompress a Blosc1 frame. Returns bytes written or -1.
inline int64_t blosc_decompress(const uint8_t* src, int64_t src_len,
                                uint8_t* dst, int64_t dst_cap) {
  if (src_len < 16) return -1;
  uint8_t flags = src[2];
  int typesize = src[3];
  int32_t nbytes = rd_i32(src + 4);
  int32_t blocksize = rd_i32(src + 8);
  int32_t cbytes = rd_i32(src + 12);
  if (nbytes < 0 || nbytes > dst_cap || cbytes > src_len) return -1;
  // c-blosc flag constants: BLOSC_DOSHUFFLE = 0x1, BLOSC_MEMCPYED = 0x2,
  // BLOSC_DOBITSHUFFLE = 0x4; compressor format code in bits 5-7 with
  // BLOSC_LZ4_FORMAT == 1 (shared by lz4 and lz4hc).
  bool shuffled = (flags & 0x1) != 0;
  bool memcpyed = (flags & 0x2) != 0;
  if (flags & 0x4) return -1;  // bit-shuffle unsupported
  int codec = (flags >> 5) & 0x7;

  if (memcpyed) {
    // c-blosc short-circuits memcpy'ed frames: the ORIGINAL (unshuffled)
    // buffer is stored verbatim at offset 16, shuffle flag ignored.
    if (16 + nbytes > src_len) return -1;
    std::memcpy(dst, src + 16, nbytes);
    return nbytes;
  }

  std::vector<uint8_t> tmp;
  uint8_t* out = dst;
  if (shuffled) {
    tmp.resize(nbytes);
    out = tmp.data();
  }

  {
    if (blocksize <= 0) return -1;
    int nblocks = (nbytes + blocksize - 1) / blocksize;
    const uint8_t* idx = src + 16;
    if (16 + 4 * nblocks > src_len) return -1;
    for (int b = 0; b < nblocks; ++b) {
      int32_t boff = rd_i32(idx + 4 * b);
      if (boff < 0 || boff + 4 > src_len) return -1;
      int32_t csize = rd_i32(src + boff);
      int64_t want = (b == nblocks - 1) ? nbytes - (int64_t)b * blocksize
                                        : blocksize;
      const uint8_t* bsrc = src + boff + 4;
      if (boff + 4 + csize > src_len) return -1;
      // Blosc convention: csize == want means the block is stored raw.
      if (csize == want) {
        std::memcpy(out + (int64_t)b * blocksize, bsrc, want);
      } else if (codec == 1) {  // BLOSC_LZ4_FORMAT (lz4 / lz4hc)
        // Shuffled blocs compress each typesize plane as its own LZ4
        // stream?  No — blosc compresses the whole (shuffled) block as one
        // LZ4 block per "split" part; splitting occurs for typesize<=
        // MAX_SPLITS when block fits; handle both: try whole-block first.
        int64_t got = lz4_decompress_block(bsrc, csize,
                                           out + (int64_t)b * blocksize, want);
        if (got != want) {
          // Split mode: typesize sub-streams, each with its own 4-byte
          // compressed size prefix.
          const uint8_t* p = bsrc;
          uint8_t* q = out + (int64_t)b * blocksize;
          int64_t per = want / (typesize ? typesize : 1);
          bool ok = typesize > 0 && want % typesize == 0;
          if (ok) {
            // First sub-stream size is the csize we already read? No: in
            // split mode the block payload is a sequence of
            // [i32 size][data] per part, and the first part's size was the
            // value at boff.  Re-walk from boff.
            p = src + boff;
            for (int t = 0; t < typesize && ok; ++t) {
              if (p + 4 > src + src_len) { ok = false; break; }
              int32_t ps = rd_i32(p);
              p += 4;
              if (p + ps > src + src_len) { ok = false; break; }
              if (ps == per) {
                std::memcpy(q, p, per);
              } else {
                int64_t g = lz4_decompress_block(p, ps, q, per);
                if (g != per) { ok = false; break; }
              }
              p += ps;
              q += per;
            }
          }
          if (!ok) return -1;
        }
      } else {
        return -1;  // blosclz etc. unsupported
      }
    }
  }

  if (shuffled) blosc_unshuffle(out, dst, nbytes, typesize);
  return nbytes;
}

// ---- IEEE 754 binary16 <-> binary32 ----
// OpenVDB's saveFloatAsHalf stores node value buffers as half floats
// (io::RealToHalf in writeCompressedValues); these are the widen/narrow
// halves used by native/vdb_read.cpp and native/vdb_write.cpp.

inline float half_to_float(uint16_t h) {
  uint32_t sign = (uint32_t)(h & 0x8000) << 16;
  uint32_t exp = (h >> 10) & 0x1F;
  uint32_t man = h & 0x3FF;
  uint32_t bits;
  if (exp == 0) {
    if (man == 0) {
      bits = sign;  // signed zero
    } else {  // subnormal (value = man * 2^-24): renormalize
      int shift = 0;
      while (!(man & 0x400)) {
        man <<= 1;
        ++shift;
      }
      man &= 0x3FF;
      bits = sign | ((uint32_t)(127 - 14 - shift) << 23) | (man << 13);
    }
  } else if (exp == 31) {
    bits = sign | 0x7F800000u | (man << 13);  // inf / nan
  } else {
    bits = sign | ((exp - 15 + 127) << 23) | (man << 13);
  }
  float f;
  std::memcpy(&f, &bits, 4);
  return f;
}

inline uint16_t float_to_half(float f) {
  uint32_t bits;
  std::memcpy(&bits, &f, 4);
  uint32_t sign = (bits >> 16) & 0x8000;
  uint32_t e8 = (bits >> 23) & 0xFF;
  uint32_t man = bits & 0x7FFFFF;
  if (e8 == 0xFF)  // inf / nan (keep nan-ness)
    return (uint16_t)(sign | 0x7C00 | (man ? 0x200 : 0));
  int32_t exp = (int32_t)e8 - 127 + 15;
  if (exp >= 31) return (uint16_t)(sign | 0x7C00);  // overflow -> inf
  if (exp <= 0) {                                   // subnormal / underflow
    if (exp < -10) return (uint16_t)sign;
    man |= 0x800000;  // implicit leading 1
    int shift = 14 - exp;
    uint16_t h = (uint16_t)(man >> shift);
    uint32_t rem = man & ((1u << shift) - 1);
    uint32_t halfway = 1u << (shift - 1);
    if (rem > halfway || (rem == halfway && (h & 1))) ++h;  // round-to-even
    return (uint16_t)(sign | h);
  }
  uint16_t h = (uint16_t)(sign | ((uint32_t)exp << 10) | (man >> 13));
  uint32_t rem = man & 0x1FFF;
  // round-to-nearest-even; a mantissa carry correctly bumps the exponent
  if (rem > 0x1000 || (rem == 0x1000 && (h & 1))) ++h;
  return h;
}

}  // namespace vdbio
