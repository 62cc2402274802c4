// ofri_io — native IO runtime for opticalflow_ri_tpu.
//
// Production PIV rigs stream thousands of frame pairs; with the TPU compute
// path at ~100+ pairs/s, Python-side image decoding becomes the bottleneck.
// This library provides:
//   * a minimal TIFF reader (uncompressed grayscale, 8/16-bit, strip-based —
//     the PIV camera format, cf. the reference's bundled
//     examples/testImages/*.tif) decoding straight to float32;
//   * a threaded batch loader (one worker per file) for feeding batched
//     pipelines;
//   * a MAT-5 writer emitting the PIV-tool-compatible flow schema
//     (velocities{u,v,iaWidth,iaHeight,margins} + parameters{...}), the same
//     artefact scipy.io.savemat produces in utils/io.py.
//
// Exposed as a plain C ABI consumed from Python via ctypes (no pybind11).
//
// Build: see build.sh (g++ -O2 -shared -fPIC -std=c++17 -pthread).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

struct TiffInfo {
  uint32_t width = 0;
  uint32_t height = 0;
  uint32_t bits = 8;
  uint32_t compression = 1;
  uint32_t rows_per_strip = 0xFFFFFFFF;
  std::vector<uint64_t> strip_offsets;
  std::vector<uint64_t> strip_counts;
  bool little = true;
};

uint16_t rd16(const uint8_t* p, bool le) {
  return le ? (uint16_t)(p[0] | p[1] << 8) : (uint16_t)(p[1] | p[0] << 8);
}
uint32_t rd32(const uint8_t* p, bool le) {
  return le ? (uint32_t)p[0] | (uint32_t)p[1] << 8 | (uint32_t)p[2] << 16 |
                  (uint32_t)p[3] << 24
            : (uint32_t)p[3] | (uint32_t)p[2] << 8 | (uint32_t)p[1] << 16 |
                  (uint32_t)p[0] << 24;
}

// Parse the first IFD of a classic TIFF. Returns false on malformed input or
// unsupported layout (caller falls back to the Python path).
bool parse_tiff(const std::vector<uint8_t>& buf, TiffInfo* info) {
  if (buf.size() < 8) return false;
  if (buf[0] == 'I' && buf[1] == 'I')
    info->little = true;
  else if (buf[0] == 'M' && buf[1] == 'M')
    info->little = false;
  else
    return false;
  const bool le = info->little;
  if (rd16(buf.data() + 2, le) != 42) return false;
  uint32_t ifd = rd32(buf.data() + 4, le);
  if (ifd + 2 > buf.size()) return false;
  uint16_t n = rd16(buf.data() + ifd, le);
  if (ifd + 2 + 12u * n > buf.size()) return false;

  auto entry_values = [&](const uint8_t* e, std::vector<uint64_t>* out) {
    uint16_t type = rd16(e + 2, le);
    uint32_t count = rd32(e + 4, le);
    uint32_t esz = (type == 3) ? 2 : (type == 4) ? 4 : (type == 1) ? 1 : 0;
    if (esz == 0) return false;
    uint64_t total = (uint64_t)esz * count;
    uint32_t src = (total <= 4) ? (uint32_t)(e + 8 - buf.data())
                                : rd32(e + 8, le);
    if ((uint64_t)src + total > buf.size()) return false;
    for (uint32_t i = 0; i < count; ++i) {
      const uint8_t* p = buf.data() + src + (uint64_t)i * esz;
      out->push_back(esz == 2 ? rd16(p, le) : esz == 4 ? rd32(p, le) : *p);
    }
    return true;
  };

  for (uint16_t i = 0; i < n; ++i) {
    const uint8_t* e = buf.data() + ifd + 2 + 12u * i;
    uint16_t tag = rd16(e, le);
    std::vector<uint64_t> vals;
    switch (tag) {
      case 256: if (!entry_values(e, &vals) || vals.empty()) return false;
                info->width = (uint32_t)vals[0]; break;
      case 257: if (!entry_values(e, &vals) || vals.empty()) return false;
                info->height = (uint32_t)vals[0]; break;
      case 258: if (!entry_values(e, &vals) || vals.empty()) return false;
                info->bits = (uint32_t)vals[0]; break;
      case 259: if (!entry_values(e, &vals) || vals.empty()) return false;
                info->compression = (uint32_t)vals[0]; break;
      case 273: if (!entry_values(e, &info->strip_offsets)) return false; break;
      case 278: if (!entry_values(e, &vals) || vals.empty()) return false;
                info->rows_per_strip = (uint32_t)vals[0]; break;
      case 279: if (!entry_values(e, &info->strip_counts)) return false; break;
      default: break;
    }
  }
  return info->width && info->height && !info->strip_offsets.empty() &&
         (info->compression == 1 || info->compression == 32773) &&
         (info->bits == 8 || info->bits == 16);
}

// PackBits (compression 32773) RLE: n in [0,127] copies n+1 literal bytes,
// n in [-127,-1] repeats the next byte 1-n times, n == -128 is a no-op.
bool unpackbits(const uint8_t* src, uint64_t cnt, std::vector<uint8_t>* out) {
  uint64_t i = 0;
  while (i < cnt) {
    int8_t n = (int8_t)src[i++];
    if (n >= 0) {
      uint64_t len = (uint64_t)n + 1;
      if (i + len > cnt) return false;
      out->insert(out->end(), src + i, src + i + len);
      i += len;
    } else if (n != -128) {
      if (i >= cnt) return false;
      out->insert(out->end(), (size_t)(1 - n), src[i++]);
    }
  }
  return true;
}

bool read_file(const char* path, std::vector<uint8_t>* out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  long sz = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  if (sz <= 0) { std::fclose(f); return false; }
  out->resize((size_t)sz);
  size_t got = std::fread(out->data(), 1, (size_t)sz, f);
  std::fclose(f);
  return got == (size_t)sz;
}

bool decode_to_f32(const std::vector<uint8_t>& buf, const TiffInfo& info,
                   float* dst) {
  const uint64_t npix = (uint64_t)info.width * info.height;
  const uint32_t bpp = info.bits / 8;
  uint64_t written = 0;
  for (size_t s = 0; s < info.strip_offsets.size(); ++s) {
    uint64_t off = info.strip_offsets[s];
    uint64_t cnt = s < info.strip_counts.size()
                       ? info.strip_counts[s]
                       : npix * bpp;  // single unbounded strip
    if (off + cnt > buf.size()) return false;
    std::vector<uint8_t> unpacked;
    const uint8_t* p = buf.data() + off;
    if (info.compression == 32773) {
      if (!unpackbits(p, cnt, &unpacked)) return false;
      p = unpacked.data();
      cnt = unpacked.size();
    }
    uint64_t vals = cnt / bpp;
    if (written + vals > npix) vals = npix - written;
    if (info.bits == 8) {
      for (uint64_t i = 0; i < vals; ++i) dst[written + i] = (float)p[i];
    } else {
      for (uint64_t i = 0; i < vals; ++i)
        dst[written + i] = (float)rd16(p + 2 * i, info.little);
    }
    written += vals;
  }
  return written == npix;
}

void put16(std::vector<uint8_t>* b, uint16_t v) {
  b->push_back((uint8_t)(v & 0xFF));
  b->push_back((uint8_t)(v >> 8));
}
void put32(std::vector<uint8_t>* b, uint32_t v) {
  for (int i = 0; i < 4; ++i) b->push_back((uint8_t)((v >> (8 * i)) & 0xFF));
}
void put_bytes(std::vector<uint8_t>* b, const void* p, size_t n) {
  const uint8_t* q = (const uint8_t*)p;
  b->insert(b->end(), q, q + n);
}
void pad8(std::vector<uint8_t>* b) {
  while (b->size() % 8) b->push_back(0);
}

// miMATRIX holding a scalar or 2-D double matrix, column-major.
void mat_matrix(std::vector<uint8_t>* b, const char* name, const double* data,
                uint32_t rows, uint32_t cols) {
  std::vector<uint8_t> body;
  // array flags: mxDOUBLE_CLASS (6)
  put32(&body, 6); put32(&body, 8); put32(&body, 6); put32(&body, 0);
  // dimensions
  put32(&body, 5); put32(&body, 8); put32(&body, rows); put32(&body, cols);
  // name
  uint32_t nlen = (uint32_t)std::strlen(name);
  put32(&body, 1); put32(&body, nlen); put_bytes(&body, name, nlen); pad8(&body);
  // real data (miDOUBLE)
  put32(&body, 9); put32(&body, rows * cols * 8);
  put_bytes(&body, data, (size_t)rows * cols * 8); pad8(&body);

  put32(b, 14);  // miMATRIX
  put32(b, (uint32_t)body.size());
  put_bytes(b, body.data(), body.size());
}

// miMATRIX holding a struct with named fields, each field a pre-serialised
// miMATRIX payload (with empty name, as MAT-5 requires for struct fields).
void mat_struct(std::vector<uint8_t>* b, const char* name,
                const std::vector<std::string>& fields,
                const std::vector<std::vector<uint8_t>>& field_bodies) {
  std::vector<uint8_t> body;
  put32(&body, 6); put32(&body, 8); put32(&body, 2); put32(&body, 0);  // mxSTRUCT
  put32(&body, 5); put32(&body, 8); put32(&body, 1); put32(&body, 1);
  uint32_t nlen = (uint32_t)std::strlen(name);
  put32(&body, 1); put32(&body, nlen); put_bytes(&body, name, nlen); pad8(&body);
  // field name length (int32, short element)
  put16(&body, 5); put16(&body, 4); put32(&body, 32);
  // field names, 32 bytes each
  put32(&body, 1); put32(&body, (uint32_t)(32 * fields.size()));
  for (const auto& f : fields) {
    char buf[32] = {0};
    std::snprintf(buf, sizeof buf, "%s", f.c_str());
    put_bytes(&body, buf, 32);
  }
  pad8(&body);
  for (const auto& fb : field_bodies) put_bytes(&body, fb.data(), fb.size());

  put32(b, 14);
  put32(b, (uint32_t)body.size());
  put_bytes(b, body.data(), body.size());
}

std::vector<uint8_t> scalar_field(double v) {
  std::vector<uint8_t> b;
  mat_matrix(&b, "", &v, 1, 1);
  return b;
}

}  // namespace

extern "C" {

// Returns 0 on success; fills (*height, *width). Probe call with dst == null
// to size the buffer first.
int ofri_tiff_read(const char* path, float* dst, int64_t dst_cap,
                   int32_t* height, int32_t* width) {
  std::vector<uint8_t> buf;
  if (!read_file(path, &buf)) return -1;
  TiffInfo info;
  if (!parse_tiff(buf, &info)) return -2;
  *height = (int32_t)info.height;
  *width = (int32_t)info.width;
  if (!dst) return 0;
  if (dst_cap < (int64_t)info.width * info.height) return -3;
  return decode_to_f32(buf, info, dst) ? 0 : -4;
}

// Threaded batch read of n equally-sized images into one (n, h, w) buffer.
// Every file must match (height, width). Returns 0 on success.
int ofri_tiff_read_batch(const char** paths, int32_t n, float* dst,
                         int32_t height, int32_t width) {
  std::vector<int> rc(n, 0);
  const int64_t npix = (int64_t)height * width;
  int hw = (int)std::thread::hardware_concurrency();
  int workers = hw < 1 ? 1 : (hw > n ? n : hw);
  std::vector<std::thread> threads;
  for (int t = 0; t < workers; ++t) {
    threads.emplace_back([&, t]() {
      for (int i = t; i < n; i += workers) {
        int32_t h = 0, w = 0;
        int r = ofri_tiff_read(paths[i], dst + (int64_t)i * npix, npix, &h, &w);
        if (r == 0 && (h != height || w != width)) r = -5;
        rc[i] = r;
      }
    });
  }
  for (auto& th : threads) th.join();
  for (int i = 0; i < n; ++i)
    if (rc[i] != 0) return rc[i];
  return 0;
}

// Write the PIV-tool flow schema as a MAT-5 file. u/v are row-major (h, w)
// float32; stored as double matrices (scipy.io.savemat parity).
int ofri_save_flow(const char* path, const float* u, const float* v,
                   int32_t h, int32_t w) {
  std::vector<uint8_t> out;
  // 128-byte header
  char header[116];
  std::memset(header, ' ', sizeof header);
  std::snprintf(header, sizeof header,
                "MATLAB 5.0 MAT-file, created by ofri_io (opticalflow_ri_tpu)");
  header[std::strlen(header)] = ' ';
  put_bytes(&out, header, 116);
  for (int i = 0; i < 8; ++i) out.push_back(0);  // subsys offset
  put16(&out, 0x0100);                           // version
  out.push_back('I'); out.push_back('M');        // endian

  // transpose to column-major doubles
  auto to_colmajor = [&](const float* src) {
    std::vector<double> d((size_t)h * w);
    for (int32_t r = 0; r < h; ++r)
      for (int32_t c = 0; c < w; ++c)
        d[(size_t)c * h + r] = (double)src[(size_t)r * w + c];
    return d;
  };
  std::vector<double> du = to_colmajor(u), dv = to_colmajor(v);

  std::vector<uint8_t> fu, fv;
  mat_matrix(&fu, "", du.data(), (uint32_t)h, (uint32_t)w);
  mat_matrix(&fv, "", dv.data(), (uint32_t)h, (uint32_t)w);

  std::vector<uint8_t> margins;
  mat_struct(&margins, "", {"top", "left", "bottom", "right"},
             {scalar_field(0), scalar_field(0), scalar_field(0), scalar_field(0)});

  std::vector<uint8_t> velocities;
  mat_struct(&velocities, "velocities",
             {"u", "v", "iaWidth", "iaHeight", "margins"},
             {fu, fv, scalar_field(1), scalar_field(1), margins});

  std::vector<uint8_t> parameters;
  mat_struct(&parameters, "parameters",
             {"overlapFactor", "imageHeight", "imageWidth"},
             {scalar_field(1.0), scalar_field(h), scalar_field(w)});

  put_bytes(&out, velocities.data(), velocities.size());
  put_bytes(&out, parameters.data(), parameters.size());

  FILE* f = std::fopen(path, "wb");
  if (!f) return -1;
  size_t wrote = std::fwrite(out.data(), 1, out.size(), f);
  std::fclose(f);
  return wrote == out.size() ? 0 : -2;
}

}  // extern "C"
