// vdbio — native host-side sparse-volume ingestion for volumerenderer_tpu.
//
// TPU-native replacement for the reference's C++ ingestion path
// (src/main.cpp:1157-1215: OpenVDB file -> nanovdb::createNanoGrid ->
// device SSBO).  Here the device structure is a dense bricked grid in HBM,
// so ingestion means: parse the sparse NanoVDB tree on the host and
// scatter it into a dense float array (plus the affine map), which the
// Python layer uploads.  The inverse (dense -> NanoVDB blob/.nvdb file)
// is also provided — the equivalent of createNanoGrid for export and for
// round-trip testing.
//
// Implemented from the public NanoVDB 32.x byte layout (the same layout
// the reference's PNanoVDB GLSL traverses): 672-byte grid header with
// affine map, 64-byte tree header with node offsets/counts, root with
// linear tile table keyed by coord>>12 (key = z | y<<21 | x<<42), upper
// 32^3 / lower 16^3 internal nodes with bitmasks + 8-byte table entries
// (child offsets relative to the parent node address), 8^3 leaves with a
// 512-bit value mask and dense float table ordered
// ((x&7)<<6)|((y&7)<<3)|(z&7).
//
// File container (.nvdb): 16-byte FileHeader {magic "NanoVDB2", version,
// gridCount, codec}, then per grid a 176-byte FileMetaData + name +
// (possibly compressed) grid blob.  Codecs: NONE, ZIP (zlib), BLOSC
// (decoded by lz4_blosc.h — no external blosc dependency).
//
// Exposed as a plain C API consumed via ctypes (grid/vdbio_native.py).

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

// ---------- byte-layout constants (NanoVDB 32.x, float grid) ----------

constexpr uint64_t kMagicGrid0 = 0x304244566f6e614eULL;  // "NanoVDB0"
constexpr uint64_t kMagicGrid1 = 0x314244566f6e614eULL;  // "NanoVDB1"
constexpr uint64_t kMagicFile = 0x324244566f6e614eULL;   // "NanoVDB2"

constexpr uint32_t kGridSize = 672;
constexpr uint32_t kGridOffVersion = 16;
constexpr uint32_t kGridOffFlags = 20;
constexpr uint32_t kGridOffGridIndex = 24;
constexpr uint32_t kGridOffGridCount = 28;
constexpr uint32_t kGridOffGridSize = 32;
constexpr uint32_t kGridOffGridName = 40;
constexpr uint32_t kGridOffMap = 296;
constexpr uint32_t kMapOffMatF = 0;      // 3x3 float row-major
constexpr uint32_t kMapOffInvMatF = 36;
constexpr uint32_t kMapOffVecF = 72;
constexpr uint32_t kMapOffMatD = 88;     // 3x3 double
constexpr uint32_t kMapOffInvMatD = 160;
constexpr uint32_t kMapOffVecD = 232;
constexpr uint32_t kGridOffWorldBBox = 560;  // 6 doubles
constexpr uint32_t kGridOffVoxelSize = 608;  // 3 doubles
constexpr uint32_t kGridOffGridClass = 632;
constexpr uint32_t kGridOffGridType = 636;

constexpr uint32_t kTreeSize = 64;
// uint64 node offsets (relative to tree start): leaf, lower, upper, root
// then uint32 counts: leaf, lower, upper; tile counts x3; voxel count u64.

constexpr uint32_t kGridTypeFloat = 1;
constexpr uint32_t kGridClassFog = 3;  // nanovdb::GridClass::FogVolume

// Float-grid node constants (pnanovdb_grid_type_constants row 1).
constexpr uint32_t kRootOffBackground = 28;
constexpr uint32_t kRootOffMin = 32;
constexpr uint32_t kRootOffMax = 36;
constexpr uint32_t kRootSize = 64;
constexpr uint32_t kRootTileSize = 32;   // key u64, child i64, state u32, value f32
constexpr uint32_t kRootTileOffValue = 20;
constexpr uint32_t kUpperOffValueMask = 32;    // 32768 bits
constexpr uint32_t kUpperOffChildMask = 4128;  // 32768 bits
constexpr uint32_t kUpperOffTable = 8256;
constexpr uint32_t kUpperSize = 270400;
constexpr uint32_t kLowerOffValueMask = 32;    // 4096 bits
constexpr uint32_t kLowerOffChildMask = 544;   // 4096 bits
constexpr uint32_t kLowerOffTable = 1088;
constexpr uint32_t kLowerSize = 33856;
constexpr uint32_t kLeafOffBBoxMin = 0;
constexpr uint32_t kLeafOffValueMask = 16;  // 512 bits
constexpr uint32_t kLeafOffMin = 80;
constexpr uint32_t kLeafOffMax = 84;
constexpr uint32_t kLeafOffTable = 96;
constexpr uint32_t kLeafSize = 2144;

template <typename T>
T rd(const uint8_t* p) {
  T v;
  std::memcpy(&v, p, sizeof(T));
  return v;
}
template <typename T>
void wr(uint8_t* p, T v) {
  std::memcpy(p, &v, sizeof(T));
}

struct Err {
  char* buf;
  int len;
  void set(const std::string& m) {
    if (buf && len > 0) std::snprintf(buf, len, "%s", m.c_str());
  }
};

// ---------------- NanoVDB blob -> dense ----------------

struct DenseOut {
  std::vector<float> data;
  int32_t bbox[6];  // min xyz, max xyz inclusive
  double mat[9];
  double vec[3];
  float background;
};

bool blob_to_dense(const uint8_t* g, size_t len, DenseOut* out, Err err) {
  if (len < kGridSize + kTreeSize) {
    err.set("blob too small");
    return false;
  }
  uint64_t magic = rd<uint64_t>(g);
  if (magic != kMagicGrid0 && magic != kMagicGrid1) {
    err.set("bad grid magic");
    return false;
  }
  uint32_t grid_type = rd<uint32_t>(g + kGridOffGridType);
  if (grid_type != kGridTypeFloat) {
    err.set("unsupported grid type " + std::to_string(grid_type) +
            " (only float)");
    return false;
  }
  for (int i = 0; i < 9; ++i)
    out->mat[i] = rd<double>(g + kGridOffMap + kMapOffMatD + 8 * i);
  for (int i = 0; i < 3; ++i)
    out->vec[i] = rd<double>(g + kGridOffMap + kMapOffVecD + 8 * i);

  const uint8_t* tree = g + kGridSize;
  uint64_t off_leaf = rd<uint64_t>(tree + 0);
  uint64_t off_lower = rd<uint64_t>(tree + 8);
  uint64_t off_upper = rd<uint64_t>(tree + 16);
  uint64_t off_root = rd<uint64_t>(tree + 24);
  (void)off_leaf;
  (void)off_lower;
  (void)off_upper;
  const uint8_t* root = tree + off_root;
  if ((size_t)(root - g) + kRootSize > len) {
    err.set("root out of range");
    return false;
  }
  int32_t bmin[3], bmax[3];
  for (int i = 0; i < 3; ++i) bmin[i] = rd<int32_t>(root + 4 * i);
  for (int i = 0; i < 3; ++i) bmax[i] = rd<int32_t>(root + 12 + 4 * i);
  uint32_t table_size = rd<uint32_t>(root + 24);
  out->background = rd<float>(root + kRootOffBackground);

  for (int i = 0; i < 3; ++i) {
    out->bbox[i] = bmin[i];
    out->bbox[3 + i] = bmax[i];
  }
  int64_t nx = (int64_t)bmax[0] - bmin[0] + 1;
  int64_t ny = (int64_t)bmax[1] - bmin[1] + 1;
  int64_t nz = (int64_t)bmax[2] - bmin[2] + 1;
  if (nx <= 0 || ny <= 0 || nz <= 0 || nx * ny * nz > (int64_t)1 << 33) {
    err.set("bad bbox");
    return false;
  }
  out->data.assign((size_t)(nx * ny * nz), 0.0f);

  auto fill_region = [&](int32_t x0, int32_t y0, int32_t z0, int32_t n,
                         float value) {
    // Fill an n^3 region clipped to the bbox.
    if (value == 0.0f) return;
    for (int32_t x = std::max(x0, bmin[0]);
         x <= std::min(x0 + n - 1, bmax[0]); ++x)
      for (int32_t y = std::max(y0, bmin[1]);
           y <= std::min(y0 + n - 1, bmax[1]); ++y) {
        int32_t zlo = std::max(z0, bmin[2]);
        int32_t zhi = std::min(z0 + n - 1, bmax[2]);
        if (zlo > zhi) continue;
        size_t base = ((size_t)(x - bmin[0]) * ny + (y - bmin[1])) * nz;
        for (int32_t z = zlo; z <= zhi; ++z)
          out->data[base + (z - bmin[2])] = value;
      }
  };

  auto get_bit = [](const uint8_t* mask, uint32_t n) {
    return (mask[n >> 3] >> (n & 7)) & 1;
  };

  // Walk: root tiles -> upper -> lower -> leaf.
  const uint8_t* tiles = root + kRootSize;
  for (uint32_t t = 0; t < table_size; ++t) {
    const uint8_t* tile = tiles + (size_t)t * kRootTileSize;
    uint64_t key = rd<uint64_t>(tile);
    int64_t child = rd<int64_t>(tile + 8);
    uint32_t state = rd<uint32_t>(tile + 16);
    float tval = rd<float>(tile + kRootTileOffValue);
    // key = (z>>12) | (y>>12)<<21 | (x>>12)<<42, components as uint32>>12.
    int32_t ox = (int32_t)((uint32_t)((key >> 42) & 0x1FFFFF) << 12);
    int32_t oy = (int32_t)((uint32_t)((key >> 21) & 0x1FFFFF) << 12);
    int32_t oz = (int32_t)((uint32_t)(key & 0x1FFFFF) << 12);
    if (child == 0) {
      if (state) fill_region(ox, oy, oz, 4096, tval);
      continue;
    }
    const uint8_t* upper = root + child;
    if ((size_t)(upper - g) + kUpperSize > len) {
      err.set("upper out of range");
      return false;
    }
    for (uint32_t n = 0; n < 32768; ++n) {
      int32_t ux = ox + (int32_t)((n >> 10) & 31) * 128;
      int32_t uy = oy + (int32_t)((n >> 5) & 31) * 128;
      int32_t uz = oz + (int32_t)(n & 31) * 128;
      if (get_bit(upper + kUpperOffChildMask, n)) {
        int64_t lchild = rd<int64_t>(upper + kUpperOffTable + 8ull * n);
        const uint8_t* lower = upper + lchild;
        if ((size_t)(lower - g) + kLowerSize > len) {
          err.set("lower out of range");
          return false;
        }
        for (uint32_t m = 0; m < 4096; ++m) {
          int32_t lx = ux + (int32_t)((m >> 8) & 15) * 8;
          int32_t ly = uy + (int32_t)((m >> 4) & 15) * 8;
          int32_t lz = uz + (int32_t)(m & 15) * 8;
          if (get_bit(lower + kLowerOffChildMask, m)) {
            int64_t lf = rd<int64_t>(lower + kLowerOffTable + 8ull * m);
            const uint8_t* leaf = lower + lf;
            if ((size_t)(leaf - g) + kLeafSize > len) {
              err.set("leaf out of range");
              return false;
            }
            const uint8_t* vmask = leaf + kLeafOffValueMask;
            const uint8_t* table = leaf + kLeafOffTable;
            for (uint32_t v = 0; v < 512; ++v) {
              if (!get_bit(vmask, v)) continue;
              int32_t x = lx + (int32_t)((v >> 6) & 7);
              int32_t y = ly + (int32_t)((v >> 3) & 7);
              int32_t z = lz + (int32_t)(v & 7);
              if (x < bmin[0] || x > bmax[0] || y < bmin[1] ||
                  y > bmax[1] || z < bmin[2] || z > bmax[2])
                continue;
              out->data[((size_t)(x - bmin[0]) * ny + (y - bmin[1])) * nz +
                        (z - bmin[2])] = rd<float>(table + 4ull * v);
            }
          } else if (get_bit(lower + kLowerOffValueMask, m)) {
            fill_region(lx, ly, lz, 8,
                        rd<float>(lower + kLowerOffTable + 8ull * m));
          }
        }
      } else if (get_bit(upper + kUpperOffValueMask, n)) {
        fill_region(ux, uy, uz, 128,
                    rd<float>(upper + kUpperOffTable + 8ull * n));
      }
    }
  }
  return true;
}

// ---------------- dense -> NanoVDB blob ----------------

void build_blob(const float* data, const int32_t bbox[6], const double mat[9],
                const double vec[3], const char* name,
                std::vector<uint8_t>* out) {
  int32_t bmin[3] = {bbox[0], bbox[1], bbox[2]};
  int32_t bmax[3] = {bbox[3], bbox[4], bbox[5]};
  int64_t nx = bmax[0] - bmin[0] + 1, ny = bmax[1] - bmin[1] + 1,
          nz = bmax[2] - bmin[2] + 1;

  auto at = [&](int32_t x, int32_t y, int32_t z) -> float {
    if (x < bmin[0] || x > bmax[0] || y < bmin[1] || y > bmax[1] ||
        z < bmin[2] || z > bmax[2])
      return 0.0f;
    return data[((size_t)(x - bmin[0]) * ny + (y - bmin[1])) * nz +
                (z - bmin[2])];
  };

  // Collect occupied leaves (8^3), group by lower (128^3), upper (4096^3).
  struct Leaf {
    int32_t o[3];
    float vals[512];
    uint8_t mask[64];
    float vmin, vmax;
  };
  std::vector<Leaf> leaves;
  struct Key3 {
    int32_t x, y, z;
    bool operator<(const Key3& o) const {
      return std::memcmp(this, &o, sizeof(Key3)) < 0;
    }
  };
  // leaf origin aligned to 8.
  int32_t l0[3], l1[3];
  for (int i = 0; i < 3; ++i) {
    l0[i] = bmin[i] & ~7;
    l1[i] = bmax[i] & ~7;
  }
  for (int32_t lx = l0[0]; lx <= l1[0]; lx += 8)
    for (int32_t ly = l0[1]; ly <= l1[1]; ly += 8)
      for (int32_t lz = l0[2]; lz <= l1[2]; lz += 8) {
        Leaf lf;
        lf.o[0] = lx;
        lf.o[1] = ly;
        lf.o[2] = lz;
        std::memset(lf.mask, 0, sizeof(lf.mask));
        bool any = false;
        lf.vmin = 3.4e38f;
        lf.vmax = -3.4e38f;
        for (uint32_t v = 0; v < 512; ++v) {
          int32_t x = lx + ((v >> 6) & 7), y = ly + ((v >> 3) & 7),
                  z = lz + (v & 7);
          float val = at(x, y, z);
          lf.vals[v] = val;
          if (val != 0.0f) {
            lf.mask[v >> 3] |= 1u << (v & 7);
            any = true;
            lf.vmin = std::min(lf.vmin, val);
            lf.vmax = std::max(lf.vmax, val);
          }
        }
        if (any) leaves.push_back(lf);
      }

  // Group leaves into lowers and uppers.
  std::vector<Key3> lower_keys, upper_keys;
  auto lower_of = [](const Leaf& lf) {
    return Key3{lf.o[0] & ~127, lf.o[1] & ~127, lf.o[2] & ~127};
  };
  auto upper_of = [](const Key3& k) {
    return Key3{k.x & ~4095, k.y & ~4095, k.z & ~4095};
  };
  for (auto& lf : leaves) {
    Key3 k = lower_of(lf);
    bool found = false;
    for (auto& e : lower_keys)
      if (!std::memcmp(&e, &k, sizeof(k))) found = true;
    if (!found) lower_keys.push_back(k);
  }
  for (auto& k : lower_keys) {
    Key3 u = upper_of(k);
    bool found = false;
    for (auto& e : upper_keys)
      if (!std::memcmp(&e, &u, sizeof(u))) found = true;
    if (!found) upper_keys.push_back(u);
  }

  size_t n_leaf = leaves.size(), n_lower = lower_keys.size(),
         n_upper = upper_keys.size();
  // Layout (NanoVDB order): grid, tree, root+tiles, uppers, lowers, leaves.
  size_t off_grid = 0;
  size_t off_tree = kGridSize;
  size_t off_root = off_tree + kTreeSize;
  size_t off_uppers = off_root + kRootSize + n_upper * kRootTileSize;
  size_t off_lowers = off_uppers + n_upper * (size_t)kUpperSize;
  size_t off_leaves = off_lowers + n_lower * (size_t)kLowerSize;
  size_t total = off_leaves + n_leaf * (size_t)kLeafSize;
  out->assign(total, 0);
  uint8_t* g = out->data();

  // ---- grid header ----
  wr<uint64_t>(g, kMagicGrid0);
  wr<uint32_t>(g + kGridOffVersion, (32u << 21) | (7u << 10) | 0u);
  wr<uint32_t>(g + kGridOffFlags, 0);
  wr<uint32_t>(g + kGridOffGridIndex, 0);
  wr<uint32_t>(g + kGridOffGridCount, 1);
  wr<uint64_t>(g + kGridOffGridSize, total);
  std::snprintf((char*)g + kGridOffGridName, 256, "%s",
                name ? name : "density");
  // Map: float + double copies; inverse computed here.
  double inv[9];
  {
    const double* m = mat;
    double det = m[0] * (m[4] * m[8] - m[5] * m[7]) -
                 m[1] * (m[3] * m[8] - m[5] * m[6]) +
                 m[2] * (m[3] * m[7] - m[4] * m[6]);
    double id = det != 0.0 ? 1.0 / det : 0.0;
    inv[0] = (m[4] * m[8] - m[5] * m[7]) * id;
    inv[1] = (m[2] * m[7] - m[1] * m[8]) * id;
    inv[2] = (m[1] * m[5] - m[2] * m[4]) * id;
    inv[3] = (m[5] * m[6] - m[3] * m[8]) * id;
    inv[4] = (m[0] * m[8] - m[2] * m[6]) * id;
    inv[5] = (m[2] * m[3] - m[0] * m[5]) * id;
    inv[6] = (m[3] * m[7] - m[4] * m[6]) * id;
    inv[7] = (m[1] * m[6] - m[0] * m[7]) * id;
    inv[8] = (m[0] * m[4] - m[1] * m[3]) * id;
  }
  uint8_t* mp = g + kGridOffMap;
  for (int i = 0; i < 9; ++i) {
    wr<float>(mp + kMapOffMatF + 4 * i, (float)mat[i]);
    wr<float>(mp + kMapOffInvMatF + 4 * i, (float)inv[i]);
    wr<double>(mp + kMapOffMatD + 8 * i, mat[i]);
    wr<double>(mp + kMapOffInvMatD + 8 * i, inv[i]);
  }
  for (int i = 0; i < 3; ++i) {
    wr<float>(mp + kMapOffVecF + 4 * i, (float)vec[i]);
    wr<double>(mp + kMapOffVecD + 8 * i, vec[i]);
  }
  // World bbox + voxel size.
  auto idx2world = [&](double x, double y, double z, double* w) {
    w[0] = mat[0] * x + mat[1] * y + mat[2] * z + vec[0];
    w[1] = mat[3] * x + mat[4] * y + mat[5] * z + vec[1];
    w[2] = mat[6] * x + mat[7] * y + mat[8] * z + vec[2];
  };
  double w0[3], w1[3];
  idx2world(bmin[0], bmin[1], bmin[2], w0);
  idx2world(bmax[0] + 1.0, bmax[1] + 1.0, bmax[2] + 1.0, w1);
  for (int i = 0; i < 3; ++i) {
    wr<double>(g + kGridOffWorldBBox + 8 * i, std::min(w0[i], w1[i]));
    wr<double>(g + kGridOffWorldBBox + 24 + 8 * i, std::max(w0[i], w1[i]));
    wr<double>(g + kGridOffVoxelSize + 8 * i, mat[4 * i]);
  }
  wr<uint32_t>(g + kGridOffGridClass, kGridClassFog);
  wr<uint32_t>(g + kGridOffGridType, kGridTypeFloat);

  // ---- tree header ----
  uint8_t* tr = g + off_tree;
  wr<uint64_t>(tr + 0, off_leaves - off_tree);
  wr<uint64_t>(tr + 8, off_lowers - off_tree);
  wr<uint64_t>(tr + 16, off_uppers - off_tree);
  wr<uint64_t>(tr + 24, off_root - off_tree);
  wr<uint32_t>(tr + 32, (uint32_t)n_leaf);
  wr<uint32_t>(tr + 36, (uint32_t)n_lower);
  wr<uint32_t>(tr + 40, (uint32_t)n_upper);
  uint64_t voxel_count = 0;
  for (auto& lf : leaves)
    for (int i = 0; i < 64; ++i) voxel_count += __builtin_popcount(lf.mask[i]);
  wr<uint64_t>(tr + 56, voxel_count);

  // ---- root ----
  uint8_t* root = g + off_root;
  float gmin = 3.4e38f, gmax = -3.4e38f;
  for (auto& lf : leaves) {
    gmin = std::min(gmin, lf.vmin);
    gmax = std::max(gmax, lf.vmax);
  }
  for (int i = 0; i < 3; ++i) wr<int32_t>(root + 4 * i, bmin[i]);
  for (int i = 0; i < 3; ++i) wr<int32_t>(root + 12 + 4 * i, bmax[i]);
  wr<uint32_t>(root + 24, (uint32_t)n_upper);
  wr<float>(root + kRootOffBackground, 0.0f);
  wr<float>(root + kRootOffMin, gmin);
  wr<float>(root + kRootOffMax, gmax);

  auto coord_key = [](int32_t x, int32_t y, int32_t z) -> uint64_t {
    uint64_t iu = ((uint32_t)x) >> 12, ju = ((uint32_t)y) >> 12,
             ku = ((uint32_t)z) >> 12;
    return ku | (ju << 21) | (iu << 42);
  };

  for (size_t u = 0; u < n_upper; ++u) {
    uint8_t* tile = root + kRootSize + u * kRootTileSize;
    const Key3& uk = upper_keys[u];
    wr<uint64_t>(tile, coord_key(uk.x, uk.y, uk.z));
    int64_t child = (int64_t)(off_uppers + u * (size_t)kUpperSize - off_root);
    wr<int64_t>(tile + 8, child);
    wr<uint32_t>(tile + 16, 0);
    wr<float>(tile + kRootTileOffValue, 0.0f);
  }

  // ---- upper nodes ----
  for (size_t u = 0; u < n_upper; ++u) {
    uint8_t* up = g + off_uppers + u * (size_t)kUpperSize;
    const Key3& uk = upper_keys[u];
    for (int i = 0; i < 3; ++i) {
      wr<int32_t>(up + 4 * i, (&uk.x)[i]);
      wr<int32_t>(up + 12 + 4 * i, (&uk.x)[i] + 4095);
    }
    for (size_t l = 0; l < n_lower; ++l) {
      const Key3& lk = lower_keys[l];
      if ((lk.x & ~4095) != uk.x || (lk.y & ~4095) != uk.y ||
          (lk.z & ~4095) != uk.z)
        continue;
      uint32_t n = (uint32_t)(((lk.x >> 7) & 31) << 10 |
                              ((lk.y >> 7) & 31) << 5 | ((lk.z >> 7) & 31));
      up[kUpperOffChildMask + (n >> 3)] |= 1u << (n & 7);
      int64_t child = (int64_t)((off_lowers + l * (size_t)kLowerSize) -
                                (off_uppers + u * (size_t)kUpperSize));
      wr<int64_t>(up + kUpperOffTable + 8ull * n, child);
    }
  }

  // ---- lower nodes ----
  for (size_t l = 0; l < n_lower; ++l) {
    uint8_t* lo = g + off_lowers + l * (size_t)kLowerSize;
    const Key3& lk = lower_keys[l];
    for (int i = 0; i < 3; ++i) {
      wr<int32_t>(lo + 4 * i, (&lk.x)[i]);
      wr<int32_t>(lo + 12 + 4 * i, (&lk.x)[i] + 127);
    }
    for (size_t f = 0; f < n_leaf; ++f) {
      const Leaf& lf = leaves[f];
      if ((lf.o[0] & ~127) != lk.x || (lf.o[1] & ~127) != lk.y ||
          (lf.o[2] & ~127) != lk.z)
        continue;
      uint32_t m = (uint32_t)(((lf.o[0] >> 3) & 15) << 8 |
                              ((lf.o[1] >> 3) & 15) << 4 |
                              ((lf.o[2] >> 3) & 15));
      lo[kLowerOffChildMask + (m >> 3)] |= 1u << (m & 7);
      int64_t child = (int64_t)((off_leaves + f * (size_t)kLeafSize) -
                                (off_lowers + l * (size_t)kLowerSize));
      wr<int64_t>(lo + kLowerOffTable + 8ull * m, child);
    }
  }

  // ---- leaves ----
  for (size_t f = 0; f < n_leaf; ++f) {
    uint8_t* lf = g + off_leaves + f * (size_t)kLeafSize;
    const Leaf& L = leaves[f];
    for (int i = 0; i < 3; ++i) wr<int32_t>(lf + kLeafOffBBoxMin + 4 * i, L.o[i]);
    std::memcpy(lf + kLeafOffValueMask, L.mask, 64);
    wr<float>(lf + kLeafOffMin, L.vmin);
    wr<float>(lf + kLeafOffMax, L.vmax);
    for (uint32_t v = 0; v < 512; ++v)
      wr<float>(lf + kLeafOffTable + 4ull * v, L.vals[v]);
  }
}

// ---------------- .nvdb file container ----------------

enum Codec : uint16_t { kCodecNone = 0, kCodecZip = 1, kCodecBlosc = 2 };

struct FileGrid {
  std::vector<uint8_t> blob;
  std::string name;
};

bool read_nvdb_file(const char* path, int grid_index, FileGrid* out, Err err) {
  FILE* f = std::fopen(path, "rb");
  if (!f) {
    err.set(std::string("cannot open ") + path);
    return false;
  }
  std::fseek(f, 0, SEEK_END);
  long fsize = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> buf(fsize);
  if (std::fread(buf.data(), 1, fsize, f) != (size_t)fsize) {
    std::fclose(f);
    err.set("short read");
    return false;
  }
  std::fclose(f);
  if (fsize < 16 || rd<uint64_t>(buf.data()) != kMagicFile) {
    err.set("not a .nvdb file (bad magic)");
    return false;
  }
  uint16_t grid_count = rd<uint16_t>(buf.data() + 12);
  uint16_t codec = rd<uint16_t>(buf.data() + 14);
  if (grid_index >= grid_count) {
    err.set("grid index out of range");
    return false;
  }
  size_t p = 16;
  for (int gi = 0; gi < grid_count; ++gi) {
    if (p + 176 > (size_t)fsize) {
      err.set("truncated metadata");
      return false;
    }
    const uint8_t* md = buf.data() + p;
    uint64_t grid_size = rd<uint64_t>(md + 0);
    uint64_t file_size = rd<uint64_t>(md + 8);
    uint32_t name_size = rd<uint32_t>(md + 136);
    p += 176;
    if (p + name_size > (size_t)fsize) {
      err.set("truncated name");
      return false;
    }
    std::string name((const char*)buf.data() + p,
                     name_size ? name_size - 1 : 0);
    p += name_size;
    uint64_t payload = (codec == kCodecNone) ? grid_size : file_size;
    if (p + payload > (size_t)fsize) {
      err.set("truncated grid data");
      return false;
    }
    if (gi == grid_index) {
      out->name = name;
      out->blob.resize(grid_size);
      if (codec == kCodecNone) {
        std::memcpy(out->blob.data(), buf.data() + p, grid_size);
      } else if (codec == kCodecZip) {
        uLongf dlen = grid_size;
        if (uncompress(out->blob.data(), &dlen, buf.data() + p, payload) !=
                Z_OK ||
            dlen != grid_size) {
          err.set("zlib decompress failed");
          return false;
        }
      } else if (codec == kCodecBlosc) {
        int64_t got = vdbio::blosc_decompress(buf.data() + p, payload,
                                              out->blob.data(), grid_size);
        if (got != (int64_t)grid_size) {
          err.set("blosc decompress failed");
          return false;
        }
      } else {
        err.set("unknown codec");
        return false;
      }
      return true;
    }
    p += payload;
  }
  err.set("grid not found");
  return false;
}

bool write_nvdb_file(const char* path, const std::vector<uint8_t>& blob,
                     const char* name, uint16_t codec, Err err) {
  std::vector<uint8_t> payload;
  if (codec == kCodecNone) {
    payload = blob;
  } else if (codec == kCodecZip) {
    uLongf clen = compressBound(blob.size());
    payload.resize(clen);
    if (compress(payload.data(), &clen, blob.data(), blob.size()) != Z_OK) {
      err.set("zlib compress failed");
      return false;
    }
    payload.resize(clen);
  } else {
    err.set("unsupported write codec");
    return false;
  }
  std::string gname = name ? name : "density";
  uint32_t name_size = (uint32_t)gname.size() + 1;

  FILE* f = std::fopen(path, "wb");
  if (!f) {
    err.set(std::string("cannot open for write ") + path);
    return false;
  }
  uint8_t header[16] = {0};
  wr<uint64_t>(header, kMagicFile);
  wr<uint32_t>(header + 8, (32u << 21) | (7u << 10));
  wr<uint16_t>(header + 12, 1);
  wr<uint16_t>(header + 14, codec);
  std::fwrite(header, 1, 16, f);

  std::vector<uint8_t> md(176, 0);
  wr<uint64_t>(md.data() + 0, blob.size());
  wr<uint64_t>(md.data() + 8, payload.size());
  // gridType (float) / gridClass (fog) at the documented offsets.
  wr<uint32_t>(md.data() + 32, kGridTypeFloat);
  wr<uint32_t>(md.data() + 36, kGridClassFog);
  // index bbox (from blob root) at offset 88 (after world bbox 40..88).
  const uint8_t* root =
      blob.data() + kGridSize +
      rd<uint64_t>(blob.data() + kGridSize + 24);  // tree + root offset
  for (int i = 0; i < 6; ++i)
    wr<int32_t>(md.data() + 88 + 4 * i, rd<int32_t>(root + 4 * i));
  wr<uint32_t>(md.data() + 136, name_size);
  wr<uint32_t>(md.data() + 140, rd<uint32_t>(blob.data() + kGridSize + 32));
  wr<uint16_t>(md.data() + 168, codec);
  wr<uint32_t>(md.data() + 172, (32u << 21) | (7u << 10));
  std::fwrite(md.data(), 1, 176, f);
  std::fwrite(gname.c_str(), 1, name_size, f);
  std::fwrite(payload.data(), 1, payload.size(), f);
  std::fclose(f);
  return true;
}

}  // namespace

// ---------------- C API ----------------

extern "C" {

void vdbio_free(void* p) { std::free(p); }

// Parse an in-memory NanoVDB grid blob into a dense array.
// out_data: malloc'd nx*ny*nz floats (x-major, z-minor). bbox: min/max
// inclusive. mat/vec: index->world affine (row-major 3x3 + translation).
int vdbio_dense_from_blob(const uint8_t* blob, int64_t len, float** out_data,
                          int64_t* out_n, int32_t bbox[6], double mat[9],
                          double vec[3], char* errbuf, int errlen) {
  DenseOut d;
  if (!blob_to_dense(blob, (size_t)len, &d, {errbuf, errlen})) return 1;
  *out_data = (float*)std::malloc(d.data.size() * 4);
  std::memcpy(*out_data, d.data.data(), d.data.size() * 4);
  *out_n = (int64_t)d.data.size();
  std::memcpy(bbox, d.bbox, sizeof(d.bbox));
  std::memcpy(mat, d.mat, sizeof(d.mat));
  std::memcpy(vec, d.vec, sizeof(d.vec));
  return 0;
}

// Read grid `grid_index` of a .nvdb file into a dense array.
int vdbio_read_nvdb(const char* path, int grid_index, float** out_data,
                    int64_t* out_n, int32_t bbox[6], double mat[9],
                    double vec[3], char* name_out, int name_len, char* errbuf,
                    int errlen) {
  FileGrid fg;
  if (!read_nvdb_file(path, grid_index, &fg, {errbuf, errlen})) return 1;
  if (name_out && name_len > 0)
    std::snprintf(name_out, name_len, "%s", fg.name.c_str());
  return vdbio_dense_from_blob(fg.blob.data(), fg.blob.size(), out_data,
                               out_n, bbox, mat, vec, errbuf, errlen);
}

// Build a NanoVDB blob from a dense array and write it as a .nvdb file.
// codec: 0 = none, 1 = zip.
int vdbio_write_nvdb(const char* path, const float* data,
                     const int32_t bbox[6], const double mat[9],
                     const double vec[3], const char* grid_name, int codec,
                     char* errbuf, int errlen) {
  std::vector<uint8_t> blob;
  build_blob(data, bbox, mat, vec, grid_name, &blob);
  if (!write_nvdb_file(path, blob, grid_name, (uint16_t)codec,
                       {errbuf, errlen}))
    return 1;
  return 0;
}

// Build a NanoVDB blob in memory (createNanoGrid equivalent).
int vdbio_blob_from_dense(const float* data, const int32_t bbox[6],
                          const double mat[9], const double vec[3],
                          const char* grid_name, uint8_t** out_blob,
                          int64_t* out_len) {
  std::vector<uint8_t> blob;
  build_blob(data, bbox, mat, vec, grid_name, &blob);
  *out_blob = (uint8_t*)std::malloc(blob.size());
  std::memcpy(*out_blob, blob.data(), blob.size());
  *out_len = (int64_t)blob.size();
  return 0;
}

}  // extern "C"
