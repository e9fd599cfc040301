// vdb_write — OpenVDB ``.vdb`` file writer, independent of every other
// encoder in this repo (tests/vdb_writer.py is a separate, Python
// implementation used by the round-trip suite; this one exists both as the
// framework's VDB *export* path and as the independent second encoder that
// cross-checks native/vdb_read.cpp against files it did not grow up with).
//
// Format notes (OpenVDB file format, version 224):
//   * header: int64 magic "VDB ", u32 file version, u32+u32 library
//     version, u8 grid-offsets flag, u32 compression flags, 36-char uuid
//   * file metadata map, u32 grid count
//   * per grid: [descriptor: unique name, grid type "Tree_float_5_4_3",
//     u8 float-as-half, 3x int64 offsets][body: grid metadata, transform,
//     u32 buffer count, f32 background, root tile/child tables,
//     depth-first internal nodes (child+value bitmasks, x-major child
//     order, per-node compressed value blocks), then all leaf buffers in
//     topology order]
//   * codecs: none / zlib / Blosc1 frame (LZ4 whole-block or memcpy),
//     optional active-mask value compression
//
// Encoder behaviors the Python writer does NOT have (so round-trips
// through this file exercise reader paths the self-written suite cannot):
// multiple grids per file, AffineMap transforms, Blosc compression, and
// uniform 8^3 regions emitted as internal-node value TILES instead of
// leaves.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <map>
#include <string>
#include <vector>

#include "zlib_api.h"

#include "lz4_blosc.h"  // vdbio::float_to_half / half_to_float

namespace {

constexpr uint64_t kMagic = 0x56444220ULL;
constexpr uint32_t kFileVersion = 224;
constexpr uint32_t kZip = 0x1, kActiveMask = 0x2, kBlosc = 0x4, kHalf = 0x8;
constexpr int8_t kMetaMaskNoInactive = 3;
constexpr int8_t kMetaNoMaskAllVals = 6;

struct Buf {
  std::vector<uint8_t> b;
  size_t pos() const { return b.size(); }
  void raw(const void* p, size_t n) {
    const uint8_t* q = (const uint8_t*)p;
    b.insert(b.end(), q, q + n);
  }
  template <typename T>
  void w(T v) {
    raw(&v, sizeof(T));
  }
  void str(const std::string& s) {
    w<uint32_t>((uint32_t)s.size());
    raw(s.data(), s.size());
  }
  void patch64(size_t at, int64_t v) { std::memcpy(b.data() + at, &v, 8); }
};

// ---- minimal LZ4 block compressor (greedy hash-chain-less) ----

int64_t lz4_compress_block(const uint8_t* src, int64_t n, std::vector<uint8_t>& out) {
  out.clear();
  if (n <= 0) return 0;
  auto rd32 = [&](int64_t i) {
    uint32_t v;
    std::memcpy(&v, src + i, 4);
    return v;
  };
  std::vector<int64_t> table(1 << 14, -1);
  auto hash = [&](uint32_t v) { return (v * 2654435761u) >> 18; };
  int64_t ip = 0, anchor = 0;
  const int64_t mflimit = n - 12;  // no matches may start in the last 12 B
  auto emit = [&](int64_t lit_len, const uint8_t* lit, int64_t mlen, uint16_t off) {
    int64_t ml = mlen < 4 ? 0 : mlen - 4;
    uint8_t token = (uint8_t)((std::min<int64_t>(lit_len, 15) << 4) |
                              std::min<int64_t>(ml, 15));
    out.push_back(token);
    if (lit_len >= 15) {
      int64_t rest = lit_len - 15;
      while (rest >= 255) { out.push_back(255); rest -= 255; }
      out.push_back((uint8_t)rest);
    }
    out.insert(out.end(), lit, lit + lit_len);
    if (mlen >= 4) {
      out.push_back((uint8_t)(off & 0xFF));
      out.push_back((uint8_t)(off >> 8));
      if (ml >= 15) {
        int64_t rest = ml - 15;
        while (rest >= 255) { out.push_back(255); rest -= 255; }
        out.push_back((uint8_t)rest);
      }
    }
  };
  while (ip < mflimit) {
    uint32_t seq = rd32(ip);
    int64_t h = hash(seq);
    int64_t ref = table[h];
    table[h] = ip;
    if (ref >= 0 && ip - ref <= 0xFFFF && rd32(ref) == seq) {
      int64_t mlen = 4;
      while (ip + mlen < n - 5 && src[ref + mlen] == src[ip + mlen]) ++mlen;
      emit(ip - anchor, src + anchor, mlen, (uint16_t)(ip - ref));
      ip += mlen;
      anchor = ip;
    } else {
      ++ip;
    }
  }
  // final literals
  emit(n - anchor, src + anchor, 0, 0);
  return (int64_t)out.size();
}

// Blosc1 frame, c-blosc 1.x conventions (so exported frames parse under a
// real c-blosc, matching what OpenVDB+blosc emits): flags bit0 =
// byte-shuffle (BLOSC_DOSHUFFLE), bit1 = memcpy'ed (BLOSC_MEMCPYED), bits
// 5-7 = compressor format (BLOSC_LZ4_FORMAT == 1).  LZ4 blocks are SPLIT
// into `typesize` sub-streams of [i32 size][payload] when typesize <= 16
// and blocksize/typesize >= 128 (c-blosc MIN_BUFFERSIZE / forward-compat
// split mode); a sub-stream whose stored size equals its raw size is
// uncompressed.
void blosc_frame(const uint8_t* src, int64_t n, std::vector<uint8_t>& out,
                 int typesize) {
  out.assign(16, 0);
  out[0] = 2;                       // blosc format version
  out[1] = 1;                       // lz4 codec format version
  out[3] = (uint8_t)typesize;
  auto wr32 = [&](size_t at, int32_t v) { std::memcpy(out.data() + at, &v, 4); };
  bool shuffled = typesize > 1 && n % typesize == 0;
  std::vector<uint8_t> shuf;
  const uint8_t* body = src;
  if (shuffled) {
    shuf.resize(n);
    int64_t per = n / typesize;
    for (int t = 0; t < typesize; ++t)
      for (int64_t i = 0; i < per; ++i) shuf[t * per + i] = src[i * typesize + t];
    body = shuf.data();
  }
  int nsplits =
      (typesize > 1 && typesize <= 16 && n % typesize == 0 &&
       n / typesize >= 128)
          ? typesize
          : 1;
  int64_t per = n / nsplits;
  std::vector<uint8_t> payload, lz;
  for (int t = 0; t < nsplits; ++t) {
    int64_t csz = lz4_compress_block(body + t * per, per, lz);
    int32_t ps;
    const uint8_t* pd;
    if (csz > 0 && csz < per) {
      ps = (int32_t)csz;
      pd = lz.data();
    } else {  // incompressible sub-stream: stored raw, size == raw size
      ps = (int32_t)per;
      pd = body + t * per;
    }
    size_t at = payload.size();
    payload.resize(at + 4);
    std::memcpy(payload.data() + at, &ps, 4);
    payload.insert(payload.end(), pd, pd + ps);
  }
  if ((int64_t)payload.size() >= n) {
    // Incompressible frame: c-blosc memcpy's the ORIGINAL (unshuffled)
    // buffer to offset 16 and sets only BLOSC_MEMCPYED.
    out[2] = 0x2;
    out.insert(out.end(), src, src + n);
  } else {
    out[2] = (uint8_t)((1 << 5) | (shuffled ? 0x1 : 0));
    out.resize(20, 0);
    wr32(16, 20);  // bstarts: single block at offset 20
    out.insert(out.end(), payload.begin(), payload.end());
  }
  wr32(4, (int32_t)n);
  wr32(8, (int32_t)n);  // blocksize == nbytes: single block
  wr32(12, (int32_t)out.size());
}

// int64-framed data block (io::writeCompressedData): positive = compressed
// payload size, negative = raw payload of |size| bytes.  With kHalf the
// values are narrowed to binary16 first (io::RealToHalf semantics).
void data_block(Buf& o, const float* vals, size_t count, uint32_t comp) {
  std::vector<uint16_t> halves;
  const uint8_t* raw_p = (const uint8_t*)vals;
  size_t nbytes = count * 4;
  int typesize = 4;
  if (comp & kHalf) {
    halves.resize(count);
    for (size_t i = 0; i < count; ++i) halves[i] = vdbio::float_to_half(vals[i]);
    raw_p = (const uint8_t*)halves.data();
    nbytes = count * 2;
    typesize = 2;
  }
  if (!(comp & (kZip | kBlosc))) {
    o.raw(raw_p, nbytes);
    return;
  }
  std::vector<uint8_t> payload;
  if (comp & kBlosc) {
    blosc_frame(raw_p, (int64_t)nbytes, payload, typesize);
  } else {
    uLongf cap = compressBound((uLong)nbytes);
    payload.resize(cap);
    if (compress2(payload.data(), &cap, (const Bytef*)raw_p, (uLong)nbytes,
                  Z_DEFAULT_COMPRESSION) == Z_OK) {
      payload.resize(cap);
    } else {
      payload.clear();
    }
  }
  if (!payload.empty() && payload.size() < nbytes) {
    o.w<int64_t>((int64_t)payload.size());
    o.raw(payload.data(), payload.size());
  } else {
    o.w<int64_t>(-(int64_t)nbytes);
    o.raw(raw_p, nbytes);
  }
}

// Per-node value array with optional active-mask compression.
void compressed_values(Buf& o, const float* vals, const uint8_t* mask,
                       size_t count, uint32_t comp) {
  if (comp & kActiveMask) {
    o.w<int8_t>(kMetaMaskNoInactive);
    std::vector<float> on;
    on.reserve(count);
    for (size_t i = 0; i < count; ++i)
      if ((mask[i >> 3] >> (i & 7)) & 1) on.push_back(vals[i]);
    data_block(o, on.data(), on.size(), comp);
  } else {
    o.w<int8_t>(kMetaNoMaskAllVals);
    data_block(o, vals, count, comp);
  }
}

// ---- tree assembly ----

struct Leaf {
  uint8_t mask[64];
  float vals[512];
};

struct Lower {                       // InternalNode log2dim=4 (16^3 children of 8)
  std::vector<uint8_t> cmask, vmask; // 512 B each
  std::vector<float> tilevals;       // 4096 values (background or tile)
  std::map<int, Leaf> leaves;        // x-major child offset -> leaf
  Lower() : cmask(512, 0), vmask(512, 0), tilevals(4096, 0.0f) {}
};

struct Upper {                       // InternalNode log2dim=5 (32^3 children of 128)
  std::vector<uint8_t> cmask, vmask; // 4096 B each
  std::vector<float> tilevals;       // 32768
  std::map<int, Lower> lowers;
  Upper() : cmask(4096, 0), vmask(4096, 0), tilevals(32768, 0.0f) {}
};

struct Key3 {
  int32_t v[3];
  bool operator<(const Key3& o) const {
    return std::lexicographical_compare(v, v + 3, o.v, o.v + 3);
  }
};

void write_transform(Buf& o, const double* mat, const double* vec) {
  bool diag = mat[1] == 0 && mat[2] == 0 && mat[3] == 0 && mat[5] == 0 &&
              mat[6] == 0 && mat[7] == 0;
  auto v3 = [&](double a, double b, double c) {
    o.w(a); o.w(b); o.w(c);
  };
  if (diag) {
    double sx = mat[0], sy = mat[4], sz = mat[8];
    o.str("ScaleTranslateMap");
    v3(vec[0], vec[1], vec[2]);      // mTranslation
    v3(sx, sy, sz);                  // mScaleValues
    v3(sx, sy, sz);                  // mVoxelSize
    v3(1 / sx, 1 / sy, 1 / sz);      // mScaleValuesInverse
    v3(1 / (sx * sx), 1 / (sy * sy), 1 / (sz * sz));
    v3(1 / (2 * sx), 1 / (2 * sy), 1 / (2 * sz));
  } else {
    o.str("AffineMap");
    // Mat4d row-major, linear part transposed vs our row-major
    // index->world mat (OpenVDB applies p * M), translation in row 3.
    double m4[16] = {mat[0], mat[3], mat[6], 0, mat[1], mat[4], mat[7], 0,
                     mat[2], mat[5], mat[8], 0, vec[0], vec[1], vec[2], 1};
    for (double d : m4) o.w(d);
  }
}

void write_metamap(Buf& o, const std::vector<std::pair<std::string, std::string>>& entries) {
  o.w<uint32_t>((uint32_t)entries.size());
  for (auto& e : entries) {
    o.str(e.first);
    o.str("string");
    // string metadata payload: u32 length + chars
    o.w<int32_t>((int32_t)(4 + e.second.size()));
    o.w<uint32_t>((uint32_t)e.second.size());
    o.raw(e.second.data(), e.second.size());
  }
}

void write_grid(Buf& o, const float* data, const int64_t dims[3],
                const int32_t bmin[3], const double* mat, const double* vec,
                const std::string& name, uint32_t comp) {
  // ---- descriptor ----
  o.str(name);
  o.str("Tree_float_5_4_3");
  o.w<uint8_t>((comp & kHalf) ? 1 : 0);  // saveFloatAsHalf
  size_t off_at = o.pos();
  o.w<int64_t>(0);  // grid pos (body start)
  o.w<int64_t>(0);  // block pos
  o.w<int64_t>(0);  // end pos
  size_t body = o.pos();
  o.patch64(off_at, (int64_t)body);

  // ---- body ----
  write_metamap(o, {{"name", name}, {"class", "fog volume"}});
  write_transform(o, mat, vec);
  o.w<uint32_t>(1);    // buffer count
  o.w<float>(0.0f);    // background

  // Assemble the tree.  Leaves live on the GLOBAL 8-aligned lattice (the
  // dense array's origin bmin is arbitrary), root children on the
  // 4096-aligned one.
  std::map<Key3, Upper> uppers;
  auto at = [&](int64_t x, int64_t y, int64_t z) {
    return data[(x * dims[1] + y) * dims[2] + z];
  };
  auto fl = [](int64_t c, int64_t s) {
    return (int32_t)((c >= 0 ? c / s : -((-c + s - 1) / s)) * s);
  };
  for (int64_t gx0 = fl(bmin[0], 8); gx0 <= bmin[0] + dims[0] - 1; gx0 += 8)
    for (int64_t gy0 = fl(bmin[1], 8); gy0 <= bmin[1] + dims[1] - 1; gy0 += 8)
      for (int64_t gz0 = fl(bmin[2], 8); gz0 <= bmin[2] + dims[2] - 1;
           gz0 += 8) {
        Leaf lf;
        std::memset(lf.mask, 0, 64);
        std::fill(lf.vals, lf.vals + 512, 0.0f);
        bool any = false, uniform = true;
        float first = 0.0f;
        bool have_first = false;
        int covered = 0;
        for (int64_t x = std::max(gx0, (int64_t)bmin[0]);
             x < std::min(gx0 + 8, bmin[0] + dims[0]); ++x)
          for (int64_t y = std::max(gy0, (int64_t)bmin[1]);
               y < std::min(gy0 + 8, bmin[1] + dims[1]); ++y)
            for (int64_t z = std::max(gz0, (int64_t)bmin[2]);
                 z < std::min(gz0 + 8, bmin[2] + dims[2]); ++z) {
              float v = at(x - bmin[0], y - bmin[1], z - bmin[2]);
              ++covered;
              if (!have_first) { first = v; have_first = true; }
              if (v != first) uniform = false;
              if (v != 0.0f) {
                int i = (int)(((x - gx0) << 6) | ((y - gy0) << 3) |
                              (z - gz0));
                lf.mask[i >> 3] |= 1 << (i & 7);
                lf.vals[i] = v;
                any = true;
              }
            }
        if (!any) continue;
        bool full = uniform && covered == 512;
        int32_t gx = (int32_t)gx0, gy = (int32_t)gy0, gz = (int32_t)gz0;
        Key3 uk{{fl(gx, 4096), fl(gy, 4096), fl(gz, 4096)}};
        Upper& up = uppers[uk];
        int ux = (gx - uk.v[0]) / 128, uy = (gy - uk.v[1]) / 128,
            uz = (gz - uk.v[2]) / 128;
        int ui = (ux << 10) | (uy << 5) | uz;
        up.cmask[ui >> 3] |= 1 << (ui & 7);
        int32_t lox = uk.v[0] + ux * 128, loy = uk.v[1] + uy * 128,
                loz = uk.v[2] + uz * 128;
        Lower& lo = up.lowers[ui];
        int cx = (gx - lox) / 8, cy = (gy - loy) / 8, cz = (gz - loz) / 8;
        int ci = (cx << 8) | (cy << 4) | cz;
        if (full) {
          // Uniform 8^3 region -> lower-node active value tile.
          lo.vmask[ci >> 3] |= 1 << (ci & 7);
          lo.tilevals[ci] = first;
        } else {
          lo.cmask[ci >> 3] |= 1 << (ci & 7);
          lo.leaves[ci] = lf;
        }
      }

  o.w<uint32_t>(0);                          // root tile count
  o.w<uint32_t>((uint32_t)uppers.size());    // root child count
  std::vector<const Leaf*> leaf_order;
  for (auto& [uk, up] : uppers) {
    o.w<int32_t>(uk.v[0]); o.w<int32_t>(uk.v[1]); o.w<int32_t>(uk.v[2]);
    o.raw(up.cmask.data(), 4096);
    o.raw(up.vmask.data(), 4096);
    compressed_values(o, up.tilevals.data(), up.vmask.data(), 32768, comp);
    for (auto& [ui, lo] : up.lowers) {       // std::map: ascending ui = x-major
      o.raw(lo.cmask.data(), 512);
      o.raw(lo.vmask.data(), 512);
      compressed_values(o, lo.tilevals.data(), lo.vmask.data(), 4096, comp);
      for (auto& [ci, lf] : lo.leaves) {
        o.raw(lf.mask, 64);                  // leaf topology: value mask only
        leaf_order.push_back(&lf);
      }
    }
  }
  // Leaf buffers in topology order.  GridDescriptor's blockPos records
  // where this stream starts (real OpenVDB seekToBlocks() seeks here
  // before Tree::readBuffers).
  o.patch64(off_at + 8, (int64_t)o.pos());
  for (const Leaf* lf : leaf_order) {
    o.raw(lf->mask, 64);
    compressed_values(o, lf->vals, lf->mask, 512, comp);
  }
  o.patch64(off_at + 16, (int64_t)o.pos());  // end pos
}

}  // namespace

extern "C" {

// Test/interop hooks: the Blosc1 codec pair as flat C calls, so the suite
// can check frame-header conformance with the c-blosc spec byte-by-byte.
int64_t vdbio_blosc_compress(const uint8_t* src, int64_t n, uint8_t* dst,
                             int64_t cap, int typesize) {
  std::vector<uint8_t> out;
  blosc_frame(src, n, out, typesize);
  if ((int64_t)out.size() > cap) return -1;
  std::memcpy(dst, out.data(), out.size());
  return (int64_t)out.size();
}

int64_t vdbio_blosc_decompress(const uint8_t* src, int64_t n, uint8_t* dst,
                               int64_t cap) {
  return vdbio::blosc_decompress(src, n, dst, cap);
}

// Write an OpenVDB .vdb file holding `n_grids` dense FloatGrids.
//   datas[i]  : dims[3i]*dims[3i+1]*dims[3i+2] floats (x-major)
//   bmins     : index-space origin per grid (3 each)
//   mats/vecs : row-major 3x3 index->world linear map + translation per grid
//   compression: bit0 zlib, bit1 active-mask, bit2 blosc(LZ4),
//                bit3 float-as-half value buffers
int vdbio_write_vdb(const char* path, int n_grids, const float* const* datas,
                    const int64_t* dims, const int32_t* bmins,
                    const double* mats, const double* vecs,
                    const char* const* names, uint32_t compression,
                    char* errbuf, int errlen) {
  if (n_grids <= 0) {
    std::snprintf(errbuf, errlen, "no grids");
    return 1;
  }
  Buf o;
  o.w<int64_t>((int64_t)kMagic);
  o.w<uint32_t>(kFileVersion);
  o.w<uint32_t>(10);  // library major
  o.w<uint32_t>(1);   // library minor
  o.w<uint8_t>(1);    // grid offsets present
  // File-level compression flags exclude kHalf: float-as-half is a
  // per-grid descriptor property, not an io::Compression flag.
  o.w<uint32_t>(compression & (kZip | kActiveMask | kBlosc));
  o.raw("00000000-0000-0000-0000-000000000000", 36);
  write_metamap(o, {{"creator", "volumerenderer_tpu vdb_write"}});
  o.w<uint32_t>((uint32_t)n_grids);
  for (int i = 0; i < n_grids; ++i) {
    write_grid(o, datas[i], dims + 3 * i, bmins + 3 * i, mats + 9 * i,
               vecs + 3 * i, names[i], compression);
  }
  FILE* f = std::fopen(path, "wb");
  if (!f) {
    std::snprintf(errbuf, errlen, "cannot open %s for writing", path);
    return 1;
  }
  size_t wrote = std::fwrite(o.b.data(), 1, o.b.size(), f);
  std::fclose(f);
  if (wrote != o.b.size()) {
    std::snprintf(errbuf, errlen, "short write");
    return 1;
  }
  return 0;
}

}  // extern "C"
