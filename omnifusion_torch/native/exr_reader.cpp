// Minimal OpenEXR scanline reader (single-part, NONE/ZIPS/ZIP compression,
// HALF/FLOAT channels).  Fills the host-IO gap for 360D depth maps
// (dataset_loader_360d.py reads depth from EXR channel R): neither cv2 (built
// without OpenEXR) nor the OpenEXR python module are available in the
// deployment image, and depth decode is on the input hot path, so this is
// native C++ with a ctypes binding (see omnifusion_torch/native/__init__.py,
// which builds it into omnifusion_torch/_build/ at first use). A copy of
// omnifusion_tpu/native/exr_reader.cpp.
//
// Build: g++ -O2 -shared -fPIC exr_reader.cpp -o libexr_reader.so -lz

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>
#include <zlib.h>

namespace {

constexpr uint32_t kMagic = 20000630;

struct Channel {
  std::string name;
  int32_t pixel_type;  // 0=UINT, 1=HALF, 2=FLOAT
};

struct Reader {
  const uint8_t* p;
  size_t n;
  size_t off = 0;
  bool ok = true;

  template <typename T>
  T get() {
    T v{};
    if (off + sizeof(T) > n) {
      ok = false;
      return v;
    }
    std::memcpy(&v, p + off, sizeof(T));
    off += sizeof(T);
    return v;
  }
  std::string cstr(size_t maxlen = 256) {
    std::string s;
    while (off < n && p[off] != 0 && s.size() < maxlen) s.push_back((char)p[off++]);
    if (off < n) ++off;  // skip NUL
    return s;
  }
  void skip(size_t k) {
    if (off + k > n) ok = false;
    else off += k;
  }
};

float half_to_float(uint16_t h) {
  uint32_t sign = (uint32_t)(h >> 15) << 31;
  uint32_t exp = (h >> 10) & 0x1f;
  uint32_t mant = h & 0x3ff;
  uint32_t bits;
  if (exp == 0) {
    if (mant == 0) {
      bits = sign;
    } else {  // subnormal
      exp = 127 - 15 + 1;
      while (!(mant & 0x400)) {
        mant <<= 1;
        --exp;
      }
      mant &= 0x3ff;
      bits = sign | (exp << 23) | (mant << 13);
    }
  } else if (exp == 31) {
    bits = sign | 0x7f800000u | (mant << 13);
  } else {
    bits = sign | ((exp - 15 + 127) << 23) | (mant << 13);
  }
  float f;
  std::memcpy(&f, &bits, 4);
  return f;
}

// OpenEXR zip postprocess: undo delta predictor, then de-interleave halves.
void exr_zip_postprocess(std::vector<uint8_t>& buf) {
  for (size_t i = 1; i < buf.size(); ++i) {
    int d = (int)buf[i - 1] + (int)buf[i] - 128;
    buf[i] = (uint8_t)d;
  }
  std::vector<uint8_t> out(buf.size());
  const uint8_t* t1 = buf.data();
  const uint8_t* t2 = buf.data() + (buf.size() + 1) / 2;
  for (size_t i = 0; i < buf.size(); ++i) out[i] = (i & 1) ? *t2++ : *t1++;
  buf.swap(out);
}

bool inflate_buf(const uint8_t* src, size_t src_len, std::vector<uint8_t>& dst) {
  uLongf dlen = dst.size();
  int rc = uncompress(dst.data(), &dlen, src, src_len);
  return rc == Z_OK && dlen == dst.size();
}

struct ExrInfo {
  int32_t xmin = 0, ymin = 0, xmax = -1, ymax = -1;
  bool has_window = false;
  uint8_t compression = 0;
  std::vector<Channel> channels;
  size_t data_off = 0;  // offset of the scanline offset table
};

bool parse_header(Reader& r, ExrInfo& info) {
  if (r.get<uint32_t>() != kMagic) return false;
  uint32_t version = r.get<uint32_t>();
  if (version & 0x200) return false;  // tiled
  while (r.ok) {
    std::string name = r.cstr();
    if (name.empty()) break;  // end of header
    std::string type = r.cstr();
    int32_t size = r.get<int32_t>();
    size_t value_off = r.off;
    if (name == "channels" && type == "chlist") {
      while (r.ok && r.off < value_off + (size_t)size) {
        std::string cname = r.cstr();
        if (cname.empty()) break;
        Channel c;
        c.name = cname;
        c.pixel_type = r.get<int32_t>();
        r.skip(4 + 4 + 4);  // pLinear+reserved, xSampling, ySampling
        info.channels.push_back(c);
      }
      r.off = value_off + size;
    } else if (name == "compression") {
      info.compression = r.get<uint8_t>();
      r.off = value_off + size;
    } else if (name == "dataWindow") {
      info.xmin = r.get<int32_t>();
      info.ymin = r.get<int32_t>();
      info.xmax = r.get<int32_t>();
      info.ymax = r.get<int32_t>();
      info.has_window = true;
      r.off = value_off + size;
    } else {
      r.skip(size);
    }
  }
  info.data_off = r.off;
  return r.ok;
}

}  // namespace

extern "C" {

// Returns 0 on success.  First call with out == nullptr to get width/height;
// then call again with an out buffer of width*height floats and the same
// width/height (a file whose window changed in between is refused). Every
// chunk must start on a block boundary inside the data window, so no write
// leaves the buffer.
int exr_read_channel(const char* path, const char* channel, float* out,
                     int* width, int* height) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return 1;
  std::fseek(f, 0, SEEK_END);
  long fsize = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> data(fsize > 0 ? (size_t)fsize : 0);
  if (fsize <= 0 || std::fread(data.data(), 1, data.size(), f) != data.size()) {
    std::fclose(f);
    return 2;
  }
  std::fclose(f);

  Reader r{data.data(), data.size()};
  ExrInfo info;
  if (!parse_header(r, info) || !info.has_window) return 3;
  int64_t w64 = (int64_t)info.xmax - info.xmin + 1;
  int64_t h64 = (int64_t)info.ymax - info.ymin + 1;
  if (w64 <= 0 || h64 <= 0 || w64 > (1 << 30) || h64 > (1 << 30)) return 3;
  int w = (int)w64, h = (int)h64;

  int lines_per_block;
  switch (info.compression) {
    case 0: lines_per_block = 1; break;  // NONE
    case 2: lines_per_block = 1; break;  // ZIPS
    case 3: lines_per_block = 16; break;  // ZIP
    default: return 4;  // unsupported compression
  }
  int n_blocks = (h + lines_per_block - 1) / lines_per_block;
  if (info.data_off + 8 * (size_t)n_blocks > data.size()) return 6;
  if (!out) {
    *width = w;
    *height = h;
    return 0;
  }
  if (*width != w || *height != h) return 3;

  // target channel + per-scanline layout (channels stored alphabetically)
  int target = -1;
  size_t line_bytes = 0, target_off = 0, target_size = 0;
  for (size_t i = 0; i < info.channels.size(); ++i) {
    const Channel& c = info.channels[i];
    if (c.pixel_type < 0 || c.pixel_type > 2) return 3;
    size_t psz = c.pixel_type == 1 ? 2 : 4;
    if (c.name == channel) {
      target = (int)i;
      target_off = line_bytes;
      target_size = psz;
    }
    line_bytes += psz * (size_t)w;
  }
  if (target < 0) return 5;
  // a scanline comes from the file, stored or inflated (at most 1032:1)
  if (line_bytes / 1032 > data.size()) return 6;

  Reader tbl{data.data(), data.size(), info.data_off};
  std::vector<uint64_t> offsets(n_blocks);
  for (int i = 0; i < n_blocks; ++i) offsets[i] = tbl.get<uint64_t>();
  if (!tbl.ok) return 6;

  int32_t ptype = info.channels[target].pixel_type;
  std::vector<uint8_t> raw;
  for (int b = 0; b < n_blocks; ++b) {
    if (offsets[b] > data.size() || data.size() - offsets[b] < 8) return 6;
    Reader ch{data.data(), data.size(), (size_t)offsets[b]};
    int32_t y = ch.get<int32_t>();
    int32_t csize = ch.get<int32_t>();
    if (!ch.ok || csize < 0 || ch.off + (size_t)csize > data.size()) return 6;
    int64_t y0_64 = (int64_t)y - info.ymin;
    if (y0_64 < 0 || y0_64 >= h || y0_64 % lines_per_block != 0) return 6;
    int y0 = (int)y0_64;
    int nlines = lines_per_block;
    if (y0 + nlines > h) nlines = h - y0;
    size_t raw_size = line_bytes * (size_t)nlines;

    const uint8_t* block;
    if (info.compression == 0 || (size_t)csize >= raw_size) {
      if ((size_t)csize < raw_size) return 6;
      block = data.data() + ch.off;
    } else {
      // zlib inflates at most 1032:1, so a larger claim is a corrupt chunk
      if (raw_size / 1032 > (size_t)csize) return 7;
      raw.assign(raw_size, 0);
      if (!inflate_buf(data.data() + ch.off, (size_t)csize, raw)) return 7;
      exr_zip_postprocess(raw);
      block = raw.data();
    }

    for (int l = 0; l < nlines; ++l) {
      const uint8_t* src = block + line_bytes * l + target_off;
      float* dst = out + (size_t)(y0 + l) * w;
      if (ptype == 2) {  // FLOAT
        std::memcpy(dst, src, 4 * (size_t)w);
      } else if (ptype == 1) {  // HALF
        for (int x = 0; x < w; ++x) {
          uint16_t hv;
          std::memcpy(&hv, src + 2 * x, 2);
          dst[x] = half_to_float(hv);
        }
      } else {  // UINT
        for (int x = 0; x < w; ++x) {
          uint32_t v;
          std::memcpy(&v, src + 4 * x, 4);
          dst[x] = (float)v;
        }
      }
    }
    (void)target_size;
  }
  return 0;
}

}  // extern "C"
