// vdb_read — OpenVDB ``.vdb`` file reader (subset) for volumerenderer_tpu.
//
// The reference app ingests ``.vdb`` files through the full OpenVDB C++
// stack (src/main.cpp:1157-1191).  This is a from-scratch, dependency-free
// reader for the modern common case:
//
//   * file version >= 222 (NODE_MASK_COMPRESSION); 220/221 partially
//   * compression: NONE, ZIP (zlib), BLOSC(+LZ4) — via lz4_blosc.h
//   * FloatGrid with the standard Tree4<float,5,4,3> topology
//   * transforms: UniformScale/Scale/ScaleTranslate/UniformScaleTranslate/
//     Translation/Affine maps
//   * float-as-half value buffers (widened to f32 at ingest)
//   * no instancing, no delayed-load multipass grids
//
// Unsupported features fail loudly with a descriptive error, never
// silently misparse.  tests/vdb_writer.py emits spec-conformant files for
// the round-trip suite.
//
// Output goes straight to the dense-brick ingestion path (same contract as
// vdbio.cpp): a dense float array over the active bounding box + the
// index->world affine map.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

#include "zlib_api.h"

#include "lz4_blosc.h"

namespace {

constexpr uint64_t kVdbMagic = 0x56444220ULL;  // int64 "VDB " (LE int64)

// file version feature gates
constexpr uint32_t kVerBoostUuid = 218;
constexpr uint32_t kVerNewTransform = 219;
constexpr uint32_t kVerSelectiveCompression = 220;
constexpr uint32_t kVerNodeMaskCompression = 222;

// compression flags
constexpr uint32_t kCompressZip = 0x1;
constexpr uint32_t kCompressActiveMask = 0x2;
constexpr uint32_t kCompressBlosc = 0x4;

// per-node compression metadata (io/Compression.h semantics)
enum Meta : int8_t {
  kNoMaskOrInactiveVals = 0,   // no mask; inactive == +background
  kNoMaskAndMinusBg = 1,       // no mask; inactive == -background
  kNoMaskAndOneInactiveVal = 2,
  kMaskAndNoInactiveVals = 3,
  kMaskAndOneInactiveVal = 4,
  kMaskAndTwoInactiveVals = 5,
  kNoMaskAndAllVals = 6,
};

struct Reader {
  const uint8_t* p;
  size_t len;
  size_t pos = 0;
  std::string err;

  bool fail(const std::string& m) {
    if (err.empty()) err = m + " (at byte " + std::to_string(pos) + ")";
    return false;
  }
  bool need(size_t n) {
    if (pos + n > len) return fail("unexpected end of file");
    return true;
  }
  template <typename T>
  bool rd(T* out) {
    if (!need(sizeof(T))) return false;
    std::memcpy(out, p + pos, sizeof(T));
    pos += sizeof(T);
    return true;
  }
  bool skip(size_t n) {
    if (!need(n)) return false;
    pos += n;
    return true;
  }
  bool rd_string(std::string* out) {
    uint32_t n;
    if (!rd(&n)) return false;
    if (n > 1u << 20) return fail("implausible string length");
    if (!need(n)) return false;
    out->assign((const char*)p + pos, n);
    pos += n;
    return true;
  }
};

struct VdbDense {
  std::vector<float> data;
  int32_t bmin[3] = {0, 0, 0}, bmax[3] = {-1, -1, -1};
  double mat[9] = {1, 0, 0, 0, 1, 0, 0, 0, 1};
  double vec[3] = {0, 0, 0};
  std::string grid_name;
};

struct Ctx {
  uint32_t file_version = 0;
  uint32_t compression = 0;
  bool half = false;
  float background = 0.0f;
};

// ---- compressed-block primitives ----

// A zipped/blosc'd stream: int64 nbytes (negative => stored raw).  With
// float-as-half grids the stored values are binary16 (io::HalfReader);
// they are widened to f32 here at ingest.
bool read_data_block(Reader& r, const Ctx& c, float* dst, size_t count) {
  const size_t vsize = c.half ? 2 : 4;
  size_t nbytes = count * vsize;
  std::vector<uint16_t> halves;
  uint8_t* raw_dst = (uint8_t*)dst;
  if (c.half) {
    halves.resize(count);
    raw_dst = (uint8_t*)halves.data();
  }
  auto widen = [&]() {
    if (c.half)
      for (size_t i = 0; i < count; ++i)
        dst[i] = vdbio::half_to_float(halves[i]);
    return true;
  };
  if (c.compression & (kCompressZip | kCompressBlosc)) {
    int64_t stored;
    if (!r.rd(&stored)) return false;
    if (count == 0) {  // header written even for empty blocks; skip payload
      return r.skip(stored > 0 ? (size_t)stored : (size_t)(-stored));
    }
    if (stored <= 0) {
      size_t raw = (size_t)(-stored);
      if (raw != nbytes) return r.fail("raw block size mismatch");
      if (!r.need(raw)) return false;
      std::memcpy(raw_dst, r.p + r.pos, raw);
      r.pos += raw;
      return widen();
    }
    if (!r.need((size_t)stored)) return false;
    const uint8_t* src = r.p + r.pos;
    if (c.compression & kCompressBlosc) {
      int64_t got = vdbio::blosc_decompress(src, stored, raw_dst, nbytes);
      if (got != (int64_t)nbytes) return r.fail("blosc block failed");
    } else {
      uLongf dlen = nbytes;
      if (uncompress((Bytef*)raw_dst, &dlen, src, stored) != Z_OK ||
          dlen != nbytes)
        return r.fail("zlib block failed");
    }
    r.pos += (size_t)stored;
    return widen();
  }
  if (!r.need(nbytes)) return false;
  std::memcpy(raw_dst, r.p + r.pos, nbytes);
  r.pos += nbytes;
  return widen();
}

// io::readCompressedValues: per-node metadata + optional selection mask +
// data block, scattered through the value mask.
bool read_compressed_values(Reader& r, const Ctx& c, float* dst, size_t count,
                            const uint8_t* value_mask, size_t mask_bytes) {
  int8_t meta = kNoMaskAndAllVals;
  if (c.file_version >= kVerNodeMaskCompression) {
    if (!r.rd(&meta)) return false;
  }

  float inactive0 = c.background, inactive1 = c.background;
  if (meta == kNoMaskAndMinusBg) inactive0 = -c.background;
  if (meta == kNoMaskAndOneInactiveVal || meta == kMaskAndOneInactiveVal ||
      meta == kMaskAndTwoInactiveVals) {
    if (!r.rd(&inactive0)) return false;
  }
  if (meta == kMaskAndTwoInactiveVals) {
    if (!r.rd(&inactive1)) return false;
  }
  std::vector<uint8_t> selection;
  bool mask_compressed = meta == kMaskAndNoInactiveVals ||
                         meta == kMaskAndOneInactiveVal ||
                         meta == kMaskAndTwoInactiveVals;
  if (mask_compressed && (meta == kMaskAndTwoInactiveVals)) {
    selection.resize(mask_bytes);
    if (!r.need(mask_bytes)) return false;
    std::memcpy(selection.data(), r.p + r.pos, mask_bytes);
    r.pos += mask_bytes;
  }

  auto bit = [](const uint8_t* m, size_t i) {
    return (m[i >> 3] >> (i & 7)) & 1;
  };

  if (!mask_compressed) {
    // All `count` values stored (or none meaningful beyond background).
    if (meta == kNoMaskOrInactiveVals || meta == kNoMaskAndMinusBg ||
        meta == kNoMaskAndOneInactiveVal) {
      // Values for ALL entries are stored in these modes too (the mask
      // optimization is off); active values real, inactive as written.
      if (!read_data_block(r, c, dst, count)) return false;
      return true;
    }
    if (!read_data_block(r, c, dst, count)) return false;  // NO_MASK_AND_ALL
    return true;
  }

  // Mask-compressed: only countOn(value_mask) values stored.
  size_t on = 0;
  for (size_t i = 0; i < count; ++i) on += bit(value_mask, i);
  std::vector<float> tmp(on);
  if (!read_data_block(r, c, tmp.data(), on)) return false;
  size_t k = 0;
  for (size_t i = 0; i < count; ++i) {
    if (bit(value_mask, i)) {
      dst[i] = tmp[k++];
    } else if (meta == kMaskAndTwoInactiveVals && bit(selection.data(), i)) {
      dst[i] = inactive1;
    } else if (meta == kMaskAndNoInactiveVals) {
      dst[i] = c.background;
    } else {
      dst[i] = inactive0;
    }
  }
  return true;
}

// ---- tree nodes (Tree4<float,5,4,3>) ----

struct LeafNode {
  int32_t origin[3];
  uint8_t value_mask[64];  // 512 bits
  float values[512];
};

struct Parsed {
  std::vector<LeafNode> leaves;
  // value tiles contribute constant regions
  struct Tile {
    int32_t origin[3];
    int32_t dim;
    float value;
    bool active;
  };
  std::vector<Tile> tiles;
};

// InternalNode<Log2Dim>: dim = 1<<Log2Dim per axis over children of size
// child_span voxels.
bool read_internal(Reader& r, Ctx& c, Parsed* out, int level,
                   const int32_t origin[3]);

bool read_leaf_topology(Reader& r, Ctx& c, Parsed* out,
                        const int32_t origin[3]) {
  LeafNode lf;
  std::memcpy(lf.origin, origin, sizeof(lf.origin));
  if (!r.need(64)) return false;
  std::memcpy(lf.value_mask, r.p + r.pos, 64);
  r.pos += 64;
  std::fill(lf.values, lf.values + 512, c.background);
  out->leaves.push_back(lf);
  return true;
}

bool read_internal(Reader& r, Ctx& c, Parsed* out, int level,
                   const int32_t origin[3]) {
  // level 2 = upper (Log2Dim 5, child span 128), level 1 = lower
  // (Log2Dim 4, child span 8).
  const int log2dim = level == 2 ? 5 : 4;
  const size_t n = (size_t)1 << (3 * log2dim);  // 32768 / 4096
  const size_t mask_bytes = n / 8;
  const int32_t child_span = level == 2 ? 128 : 8;

  std::vector<uint8_t> child_mask(mask_bytes), value_mask(mask_bytes);
  if (!r.need(mask_bytes * 2)) return false;
  std::memcpy(child_mask.data(), r.p + r.pos, mask_bytes);
  r.pos += mask_bytes;
  std::memcpy(value_mask.data(), r.p + r.pos, mask_bytes);
  r.pos += mask_bytes;

  std::vector<float> values(n);
  if (!read_compressed_values(r, c, values.data(), n, value_mask.data(),
                              mask_bytes))
    return false;

  auto bit = [](const std::vector<uint8_t>& m, size_t i) {
    return (m[i >> 3] >> (i & 7)) & 1;
  };
  const int dim = 1 << log2dim;
  for (size_t i = 0; i < n; ++i) {
    // offset -> local coords (x major, z minor — OpenVDB convention).
    int32_t lx = (int32_t)(i >> (2 * log2dim));
    int32_t ly = (int32_t)((i >> log2dim) & (dim - 1));
    int32_t lz = (int32_t)(i & (dim - 1));
    int32_t co[3] = {origin[0] + lx * child_span, origin[1] + ly * child_span,
                     origin[2] + lz * child_span};
    if (bit(child_mask, i)) {
      if (level == 2) {
        if (!read_internal(r, c, out, 1, co)) return false;
      } else {
        if (!read_leaf_topology(r, c, out, co)) return false;
      }
    } else if (bit(value_mask, i) || values[i] != c.background) {
      out->tiles.push_back(
          {{co[0], co[1], co[2]}, child_span, values[i],
           (bool)bit(value_mask, i)});
    }
  }
  return true;
}

bool read_transform(Reader& r, VdbDense* out) {
  std::string map_type;
  if (!r.rd_string(&map_type)) return false;
  auto rd_vec3 = [&](double* v) {
    return r.rd(&v[0]) && r.rd(&v[1]) && r.rd(&v[2]);
  };
  double scale[3] = {1, 1, 1}, trans[3] = {0, 0, 0}, dummy[3];
  if (map_type == "UniformScaleMap" || map_type == "ScaleMap") {
    // mScaleValues, mVoxelSize, mScaleValuesInverse, mInvScaleSqr,
    // mInvTwiceScale
    if (!rd_vec3(scale) || !rd_vec3(dummy) || !rd_vec3(dummy) ||
        !rd_vec3(dummy) || !rd_vec3(dummy))
      return false;
  } else if (map_type == "UniformScaleTranslateMap" ||
             map_type == "ScaleTranslateMap") {
    // mTranslation, then the five scale vectors
    if (!rd_vec3(trans) || !rd_vec3(scale) || !rd_vec3(dummy) ||
        !rd_vec3(dummy) || !rd_vec3(dummy) || !rd_vec3(dummy))
      return false;
  } else if (map_type == "TranslationMap") {
    if (!rd_vec3(trans)) return false;
  } else if (map_type == "AffineMap") {
    double m4[16];
    for (int i = 0; i < 16; ++i)
      if (!r.rd(&m4[i])) return false;
    // OpenVDB Mat4d is row-major with translation in the last row.
    out->mat[0] = m4[0]; out->mat[1] = m4[4]; out->mat[2] = m4[8];
    out->mat[3] = m4[1]; out->mat[4] = m4[5]; out->mat[5] = m4[9];
    out->mat[6] = m4[2]; out->mat[7] = m4[6]; out->mat[8] = m4[10];
    out->vec[0] = m4[12]; out->vec[1] = m4[13]; out->vec[2] = m4[14];
    return true;
  } else {
    return r.fail("unsupported map type: " + map_type);
  }
  out->mat[0] = scale[0];
  out->mat[4] = scale[1];
  out->mat[8] = scale[2];
  out->mat[1] = out->mat[2] = out->mat[3] = 0;
  out->mat[5] = out->mat[6] = out->mat[7] = 0;
  out->vec[0] = trans[0];
  out->vec[1] = trans[1];
  out->vec[2] = trans[2];
  return true;
}

bool skip_metamap(Reader& r) {
  uint32_t count;
  if (!r.rd(&count)) return false;
  if (count > 10000) return r.fail("implausible metadata count");
  for (uint32_t i = 0; i < count; ++i) {
    std::string name, type;
    if (!r.rd_string(&name) || !r.rd_string(&type)) return false;
    int32_t nbytes;
    if (!r.rd(&nbytes)) return false;
    if (nbytes < 0) return r.fail("negative metadata size");
    if (!r.skip((size_t)nbytes)) return false;
  }
  return true;
}

bool parse_vdb(const uint8_t* buf, size_t len, const char* want_name,
               VdbDense* out, std::string* err) {
  Reader r{buf, len};
  Ctx c;
  do {
    int64_t magic;
    if (!r.rd(&magic)) break;
    if ((uint64_t)magic != kVdbMagic) {
      r.fail("not an OpenVDB file (bad magic)");
      break;
    }
    if (!r.rd(&c.file_version)) break;
    if (c.file_version < kVerSelectiveCompression) {
      r.fail("file version " + std::to_string(c.file_version) +
             " too old (supported: >= 220)");
      break;
    }
    uint32_t lib_major = 0, lib_minor = 0;
    if (!r.rd(&lib_major) || !r.rd(&lib_minor)) break;
    uint8_t has_offsets;
    if (!r.rd(&has_offsets)) break;
    if (c.file_version >= kVerNodeMaskCompression) {
      if (!r.rd(&c.compression)) break;
    } else {
      uint8_t zipped;
      if (!r.rd(&zipped)) break;
      c.compression = zipped ? kCompressZip : 0;
    }
    if (c.file_version >= kVerBoostUuid) {
      if (!r.skip(36)) break;  // uuid as 36 ascii chars
    }
    if (!skip_metamap(r)) break;  // file-level metadata

    uint32_t grid_count;
    if (!r.rd(&grid_count)) break;
    if (grid_count == 0) {
      r.fail("file contains no grids");
      break;
    }

    bool done = false;
    for (uint32_t gi = 0; gi < grid_count && !done; ++gi) {
      std::string unique_name, grid_type;
      if (!r.rd_string(&unique_name) || !r.rd_string(&grid_type)) break;
      uint8_t half = 0;
      if (!r.rd(&half)) break;
      int64_t grid_pos, block_pos, end_pos;
      if (!r.rd(&grid_pos) || !r.rd(&block_pos) || !r.rd(&end_pos)) break;
      bool is_float =
          grid_type == "Tree_float_5_4_3" || grid_type.find("float") != std::string::npos;
      bool name_ok =
          !want_name || !*want_name || unique_name == want_name ||
          unique_name.rfind(std::string(want_name) + "\x1e", 0) == 0;
      if (!is_float || !name_ok) {
        // Skip this grid entirely using its end offset.
        if (end_pos <= 0 || (size_t)end_pos > len) {
          r.fail("cannot skip grid (bad offsets)");
          break;
        }
        r.pos = (size_t)end_pos;
        continue;
      }
      c.half = half != 0;  // binary16 value buffers, widened at ingest
      out->grid_name = unique_name.substr(0, unique_name.find('\x1e'));
      if (grid_pos > 0 && (size_t)grid_pos <= len) r.pos = (size_t)grid_pos;

      if (!skip_metamap(r)) break;  // grid metadata
      if (!read_transform(r, out)) break;

      // Tree topology: Index32 buffer count (==1), then root.
      uint32_t buffer_count;
      if (!r.rd(&buffer_count)) break;
      if (buffer_count != 1) {
        r.fail("multi-buffer trees unsupported");
        break;
      }
      if (!r.rd(&c.background)) break;
      uint32_t num_tiles, num_children;
      if (!r.rd(&num_tiles) || !r.rd(&num_children)) break;

      Parsed parsed;
      bool ok = true;
      for (uint32_t i = 0; i < num_tiles && ok; ++i) {
        int32_t xyz[3];
        float value;
        uint8_t active;
        ok = r.rd(&xyz[0]) && r.rd(&xyz[1]) && r.rd(&xyz[2]) &&
             r.rd(&value) && r.rd(&active);
        if (ok)
          parsed.tiles.push_back({{xyz[0], xyz[1], xyz[2]}, 4096, value,
                                  active != 0});
      }
      for (uint32_t i = 0; i < num_children && ok; ++i) {
        int32_t xyz[3];
        ok = r.rd(&xyz[0]) && r.rd(&xyz[1]) && r.rd(&xyz[2]);
        if (ok) ok = read_internal(r, c, &parsed, 2, xyz);
      }
      if (!ok) break;

      // Buffers: per leaf (topology order): value mask again + data.
      for (auto& lf : parsed.leaves) {
        if (!r.need(64)) {
          ok = false;
          break;
        }
        std::memcpy(lf.value_mask, r.p + r.pos, 64);
        r.pos += 64;
        if (!read_compressed_values(r, c, lf.values, 512, lf.value_mask,
                                    64)) {
          ok = false;
          break;
        }
      }
      if (!ok) break;

      // ---- rasterize to dense over the TIGHT active bbox ----
      bool any = false;
      int32_t bmin[3] = {0, 0, 0}, bmax[3] = {-1, -1, -1};
      auto grow1 = [&](int32_t x, int32_t y, int32_t z) {
        int32_t o[3] = {x, y, z};
        if (!any) {
          for (int i = 0; i < 3; ++i) bmin[i] = bmax[i] = o[i];
          any = true;
        } else {
          for (int i = 0; i < 3; ++i) {
            bmin[i] = std::min(bmin[i], o[i]);
            bmax[i] = std::max(bmax[i], o[i]);
          }
        }
      };
      for (auto& lf : parsed.leaves) {
        for (int i = 0; i < 512; ++i) {
          if (!((lf.value_mask[i >> 3] >> (i & 7)) & 1)) continue;
          grow1(lf.origin[0] + (i >> 6), lf.origin[1] + ((i >> 3) & 7),
                lf.origin[2] + (i & 7));
        }
      }
      for (auto& t : parsed.tiles)
        if (t.active) {
          grow1(t.origin[0], t.origin[1], t.origin[2]);
          grow1(t.origin[0] + t.dim - 1, t.origin[1] + t.dim - 1,
                t.origin[2] + t.dim - 1);
        }
      if (!any) {
        r.fail("grid has no active voxels");
        break;
      }
      int64_t nx = bmax[0] - bmin[0] + 1, ny = bmax[1] - bmin[1] + 1,
              nz = bmax[2] - bmin[2] + 1;
      if (nx * ny * nz > (int64_t)1 << 31) {
        r.fail("bbox too large");
        break;
      }
      out->data.assign((size_t)(nx * ny * nz), 0.0f);
      std::memcpy(out->bmin, bmin, sizeof(bmin));
      std::memcpy(out->bmax, bmax, sizeof(bmax));
      auto at = [&](int32_t x, int32_t y, int32_t z) -> float& {
        return out->data[((size_t)(x - bmin[0]) * ny + (y - bmin[1])) * nz +
                         (z - bmin[2])];
      };
      for (auto& t : parsed.tiles) {
        if (!t.active || t.value == 0.0f) continue;
        for (int32_t x = std::max(t.origin[0], bmin[0]);
             x <= std::min(t.origin[0] + t.dim - 1, bmax[0]); ++x)
          for (int32_t y = std::max(t.origin[1], bmin[1]);
               y <= std::min(t.origin[1] + t.dim - 1, bmax[1]); ++y)
            for (int32_t z = std::max(t.origin[2], bmin[2]);
                 z <= std::min(t.origin[2] + t.dim - 1, bmax[2]); ++z)
              at(x, y, z) = t.value;
      }
      for (auto& lf : parsed.leaves) {
        for (int i = 0; i < 512; ++i) {
          if (!((lf.value_mask[i >> 3] >> (i & 7)) & 1)) continue;
          int32_t x = lf.origin[0] + (i >> 6);
          int32_t y = lf.origin[1] + ((i >> 3) & 7);
          int32_t z = lf.origin[2] + (i & 7);
          at(x, y, z) = lf.values[i];
        }
      }
      done = true;
    }
    if (!done && r.err.empty()) r.fail("no matching FloatGrid found");
    if (!r.err.empty()) break;
    return true;
  } while (false);
  *err = r.err.empty() ? "parse error" : r.err;
  return false;
}

}  // namespace

extern "C" {

// Read the first (or named) FloatGrid of a .vdb file into a dense array.
int vdbio_read_vdb(const char* path, const char* grid_name, float** out_data,
                   int64_t* out_n, int32_t bbox[6], double mat[9],
                   double vec[3], char* name_out, int name_len, char* errbuf,
                   int errlen) {
  FILE* f = std::fopen(path, "rb");
  if (!f) {
    std::snprintf(errbuf, errlen, "cannot open %s", path);
    return 1;
  }
  std::fseek(f, 0, SEEK_END);
  long fsize = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> buf(fsize);
  if (std::fread(buf.data(), 1, fsize, f) != (size_t)fsize) {
    std::fclose(f);
    std::snprintf(errbuf, errlen, "short read");
    return 1;
  }
  std::fclose(f);

  VdbDense d;
  std::string err;
  bool ok;
  try {
    ok = parse_vdb(buf.data(), buf.size(), grid_name, &d, &err);
  } catch (const std::exception& e) {  // e.g. bad_alloc on corrupt sizes
    ok = false;
    err = std::string("parse failed: ") + e.what();
  }
  if (!ok) {
    std::snprintf(errbuf, errlen, "%s", err.c_str());
    return 1;
  }
  *out_data = (float*)std::malloc(d.data.size() * 4);
  std::memcpy(*out_data, d.data.data(), d.data.size() * 4);
  *out_n = (int64_t)d.data.size();
  for (int i = 0; i < 3; ++i) {
    bbox[i] = d.bmin[i];
    bbox[3 + i] = d.bmax[i];
  }
  std::memcpy(mat, d.mat, sizeof(d.mat));
  std::memcpy(vec, d.vec, sizeof(d.vec));
  if (name_out && name_len > 0)
    std::snprintf(name_out, name_len, "%s", d.grid_name.c_str());
  return 0;
}

}  // extern "C"
