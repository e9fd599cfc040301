// imageio — native frame export for volumerenderer_tpu.
//
// The reference presents frames through a Vulkan swapchain + fullscreen
// blit (shaders/fullscreen.vert, sample_image.frag, src/main.cpp:864-886);
// the headless TPU equivalent is device->host copy + encode + write.  The
// encode/write half lives here in C++ so large progressive renders can be
// exported off the Python hot loop (io.frame_writer drives it from a
// background thread).
//
// PNG encoding from scratch: zlib (stored or default compression via
// libz's compress2) wrapped in PNG chunks with CRC32 from libz.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

#include "zlib_api.h"

namespace {

void put_u32_be(std::vector<uint8_t>& v, uint32_t x) {
  v.push_back((x >> 24) & 0xFF);
  v.push_back((x >> 16) & 0xFF);
  v.push_back((x >> 8) & 0xFF);
  v.push_back(x & 0xFF);
}

void chunk(std::vector<uint8_t>& out, const char type[4],
           const uint8_t* data, size_t len) {
  put_u32_be(out, (uint32_t)len);
  size_t start = out.size();
  out.insert(out.end(), type, type + 4);
  out.insert(out.end(), data, data + len);
  uint32_t crc = crc32(0, out.data() + start, (uInt)(len + 4));
  put_u32_be(out, crc);
}

}  // namespace

extern "C" {

// Encode an (h, w, 3) RGB8 buffer as a PNG file. Returns 0 on success.
int vdbio_write_png(const char* path, const uint8_t* rgb, int32_t width,
                    int32_t height, char* errbuf, int errlen) {
  // Filtered scanlines (filter byte 0 per row).
  std::vector<uint8_t> raw((size_t)height * (width * 3 + 1));
  for (int32_t y = 0; y < height; ++y) {
    uint8_t* row = raw.data() + (size_t)y * (width * 3 + 1);
    row[0] = 0;
    std::memcpy(row + 1, rgb + (size_t)y * width * 3, (size_t)width * 3);
  }
  uLongf clen = compressBound(raw.size());
  std::vector<uint8_t> comp(clen);
  if (compress2(comp.data(), &clen, raw.data(), raw.size(), 6) != Z_OK) {
    std::snprintf(errbuf, errlen, "zlib compress failed");
    return 1;
  }
  comp.resize(clen);

  std::vector<uint8_t> out;
  static const uint8_t sig[8] = {137, 80, 78, 71, 13, 10, 26, 10};
  out.insert(out.end(), sig, sig + 8);
  uint8_t ihdr[13];
  ihdr[0] = (width >> 24) & 0xFF;
  ihdr[1] = (width >> 16) & 0xFF;
  ihdr[2] = (width >> 8) & 0xFF;
  ihdr[3] = width & 0xFF;
  ihdr[4] = (height >> 24) & 0xFF;
  ihdr[5] = (height >> 16) & 0xFF;
  ihdr[6] = (height >> 8) & 0xFF;
  ihdr[7] = height & 0xFF;
  ihdr[8] = 8;   // bit depth
  ihdr[9] = 2;   // color type RGB
  ihdr[10] = 0;  // compression
  ihdr[11] = 0;  // filter
  ihdr[12] = 0;  // interlace
  chunk(out, "IHDR", ihdr, 13);
  chunk(out, "IDAT", comp.data(), comp.size());
  chunk(out, "IEND", nullptr, 0);

  FILE* f = std::fopen(path, "wb");
  if (!f) {
    std::snprintf(errbuf, errlen, "cannot open %s", path);
    return 1;
  }
  size_t wrote = std::fwrite(out.data(), 1, out.size(), f);
  std::fclose(f);
  if (wrote != out.size()) {
    std::snprintf(errbuf, errlen, "short write");
    return 1;
  }
  return 0;
}

// Binary P6 PPM (CPU_test/main.cpp:128-132 output format). 0 on success.
int vdbio_write_ppm(const char* path, const uint8_t* rgb, int32_t width,
                    int32_t height, char* errbuf, int errlen) {
  FILE* f = std::fopen(path, "wb");
  if (!f) {
    std::snprintf(errbuf, errlen, "cannot open %s", path);
    return 1;
  }
  std::fprintf(f, "P6\n%d %d\n255\n", width, height);
  size_t n = (size_t)width * height * 3;
  size_t wrote = std::fwrite(rgb, 1, n, f);
  std::fclose(f);
  if (wrote != n) {
    std::snprintf(errbuf, errlen, "short write");
    return 1;
  }
  return 0;
}

}  // extern "C"
