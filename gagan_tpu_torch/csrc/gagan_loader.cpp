// gagan_loader: dataset-zip reader with a parallel PNG decode, for the
// PyTorch port (gagan_tpu_torch/data/native_loader.py binds it by ctypes).
//
// A copy of native/gagan_loader.cpp with one change: the card's machine has
// zlib but not libpng, so this copy decodes PNG itself on zlib. It walks the
// chunks (IHDR, PLTE, IDAT, IEND), inflates the IDAT stream and undoes the
// five row filters (None, Sub, Up, Average, Paeth), then applies what the
// original asks of libpng: 16-bit samples keep their high byte
// (png_set_strip_16), gray of 1, 2 or 4 bits is scaled to 8
// (png_set_expand_gray_1_2_4_to_8), palette indices become RGB
// (png_set_palette_to_rgb) and alpha is dropped (png_set_strip_alpha).
// Unlike libpng it refuses interlaced (Adam7) PNGs; the dataset tool never
// writes them.  Everything else (the zip index, the stored / deflated
// entries, the thread fan-out into an NCHW uint8 batch with x-flips) is the
// original's.
//
// Build: g++ -O3 -fPIC -std=c++17 -shared gagan_loader.cpp -lz -pthread
// (gagan_tpu_torch/_build.py::load_host does this at first use).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <vector>
#include <algorithm>
#include <atomic>

#include <zlib.h>

namespace {

struct ZipEntry {
  std::string name;
  uint64_t header_offset;
  uint64_t comp_size;
  uint64_t uncomp_size;
  uint16_t method;  // 0 = stored, 8 = deflate
};

struct Loader {
  FILE* file = nullptr;
  std::mutex io_mutex;
  std::vector<ZipEntry> images;           // sorted by name
  int channels = 0, height = 0, width = 0;
  std::string error;
};

uint16_t rd16(const uint8_t* p) { return p[0] | (p[1] << 8); }
uint32_t rd32(const uint8_t* p) {
  return p[0] | (p[1] << 8) | (p[2] << 16) | ((uint32_t)p[3] << 24);
}

bool has_image_ext(const std::string& name) {
  auto dot = name.rfind('.');
  if (dot == std::string::npos) return false;
  std::string ext = name.substr(dot);
  for (auto& c : ext) c = tolower(c);
  return ext == ".png";
}

// Parse the end-of-central-directory record + central directory.
bool parse_zip(Loader* L) {
  FILE* f = L->file;
  fseek(f, 0, SEEK_END);
  long file_size = ftell(f);
  long scan = std::min(file_size, (long)(65536 + 22));
  std::vector<uint8_t> tail(scan);
  fseek(f, file_size - scan, SEEK_SET);
  if (fread(tail.data(), 1, scan, f) != (size_t)scan) {
    L->error = "failed to read zip tail";
    return false;
  }
  long eocd = -1;
  for (long i = scan - 22; i >= 0; i--) {
    if (rd32(&tail[i]) == 0x06054b50) { eocd = i; break; }
  }
  if (eocd < 0) { L->error = "no end-of-central-directory"; return false; }
  uint16_t num_entries = rd16(&tail[eocd + 10]);
  uint32_t cd_size = rd32(&tail[eocd + 12]);
  uint32_t cd_offset = rd32(&tail[eocd + 16]);

  std::vector<uint8_t> cd(cd_size);
  fseek(f, cd_offset, SEEK_SET);
  if (fread(cd.data(), 1, cd_size, f) != cd_size) {
    L->error = "failed to read central directory";
    return false;
  }
  size_t p = 0;
  for (int i = 0; i < num_entries; i++) {
    if (p + 46 > cd.size() || rd32(&cd[p]) != 0x02014b50) {
      L->error = "bad central directory entry";
      return false;
    }
    ZipEntry e;
    e.method = rd16(&cd[p + 10]);
    e.comp_size = rd32(&cd[p + 20]);
    e.uncomp_size = rd32(&cd[p + 24]);
    uint16_t name_len = rd16(&cd[p + 28]);
    uint16_t extra_len = rd16(&cd[p + 30]);
    uint16_t comment_len = rd16(&cd[p + 32]);
    e.header_offset = rd32(&cd[p + 42]);
    e.name.assign((const char*)&cd[p + 46], name_len);
    p += 46 + name_len + extra_len + comment_len;
    if (has_image_ext(e.name)) L->images.push_back(std::move(e));
  }
  std::sort(L->images.begin(), L->images.end(),
            [](const ZipEntry& a, const ZipEntry& b) { return a.name < b.name; });
  return true;
}

// Read an entry's (decompressed) bytes; thread-safe via the io mutex for the
// file read, decompression outside the lock.
bool read_entry(Loader* L, const ZipEntry& e, std::vector<uint8_t>* out,
                std::string* err) {
  std::vector<uint8_t> raw(e.comp_size);
  {
    std::lock_guard<std::mutex> lock(L->io_mutex);
    // Local file header: 30 bytes + name + extra (must re-read lengths).
    uint8_t lfh[30];
    fseek(L->file, e.header_offset, SEEK_SET);
    if (fread(lfh, 1, 30, L->file) != 30 || rd32(lfh) != 0x04034b50) {
      *err = "bad local file header";
      return false;
    }
    uint16_t name_len = rd16(&lfh[26]);
    uint16_t extra_len = rd16(&lfh[28]);
    fseek(L->file, e.header_offset + 30 + name_len + extra_len, SEEK_SET);
    if (fread(raw.data(), 1, raw.size(), L->file) != raw.size()) {
      *err = "short entry read";
      return false;
    }
  }
  if (e.method == 0) {
    *out = std::move(raw);
    return true;
  }
  if (e.method == 8) {
    out->resize(e.uncomp_size);
    z_stream zs;
    memset(&zs, 0, sizeof(zs));
    inflateInit2(&zs, -15);  // raw deflate
    zs.next_in = raw.data();
    zs.avail_in = raw.size();
    zs.next_out = out->data();
    zs.avail_out = out->size();
    int rc = inflate(&zs, Z_FINISH);
    inflateEnd(&zs);
    if (rc != Z_STREAM_END) {
      *err = "inflate failed";
      return false;
    }
    return true;
  }
  *err = "unsupported compression method";
  return false;
}

uint32_t rd32be(const uint8_t* p) {
  return ((uint32_t)p[0] << 24) | (p[1] << 16) | (p[2] << 8) | p[3];
}

// Decode a PNG from memory into HWC uint8 (8-bit samples, alpha stripped,
// palette expanded to RGB).
bool decode_png(const uint8_t* data, size_t size, std::vector<uint8_t>* out,
                int* channels, int* height, int* width, std::string* err) {
  static const uint8_t kSig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};
  if (size < 8 || memcmp(data, kSig, 8) != 0) {
    *err = "not a PNG";
    return false;
  }
  uint32_t w = 0, h = 0;
  int depth = 0, color = -1, interlace = 0;
  std::vector<uint8_t> idat, palette;
  size_t pos = 8;
  bool header = false;
  while (pos + 8 <= size) {
    uint32_t len = rd32be(data + pos);
    const uint8_t* tag = data + pos + 4;
    const uint8_t* body = data + pos + 8;
    if (pos + 12 + (size_t)len > size) {
      *err = "truncated PNG chunk";
      return false;
    }
    if (memcmp(tag, "IHDR", 4) == 0 && len >= 13) {
      w = rd32be(body);
      h = rd32be(body + 4);
      depth = body[8];
      color = body[9];
      interlace = body[12];
      header = true;
    } else if (memcmp(tag, "PLTE", 4) == 0) {
      palette.assign(body, body + len);
    } else if (memcmp(tag, "IDAT", 4) == 0) {
      idat.insert(idat.end(), body, body + len);
    } else if (memcmp(tag, "IEND", 4) == 0) {
      break;
    }
    pos += 12 + len;
  }
  if (!header || w == 0 || h == 0) {
    *err = "PNG without a valid IHDR";
    return false;
  }
  if (interlace != 0) {
    *err = "interlaced PNG not supported";
    return false;
  }
  int samples;
  switch (color) {
    case 0: samples = 1; break;
    case 2: samples = 3; break;
    case 3: samples = 1; break;
    case 4: samples = 2; break;
    case 6: samples = 4; break;
    default: *err = "bad PNG colour type"; return false;
  }
  bool ok_depth = (depth == 8 || depth == 16) ||
                  ((color == 0 || color == 3) &&
                   (depth == 1 || depth == 2 || depth == 4));
  if (!ok_depth || (color == 3 && depth == 16)) {
    *err = "bad PNG bit depth";
    return false;
  }
  const size_t bits_pp = (size_t)samples * depth;
  const size_t bpp = std::max<size_t>(1, bits_pp / 8);  // filter unit
  const size_t row_bytes = ((size_t)w * bits_pp + 7) / 8;
  std::vector<uint8_t> raw((row_bytes + 1) * h);
  uLongf raw_len = raw.size();
  if (uncompress(raw.data(), &raw_len, idat.data(), idat.size()) != Z_OK ||
      raw_len != raw.size()) {
    *err = "PNG inflate failed";
    return false;
  }
  // Unfilter in place, row by row.
  std::vector<uint8_t> zero(row_bytes, 0);
  for (uint32_t y = 0; y < h; y++) {
    uint8_t* row = raw.data() + y * (row_bytes + 1);
    const uint8_t ft = row[0];
    uint8_t* cur = row + 1;
    const uint8_t* prev = y ? raw.data() + (y - 1) * (row_bytes + 1) + 1
                            : zero.data();
    switch (ft) {
      case 0: break;
      case 1:
        for (size_t i = bpp; i < row_bytes; i++) cur[i] += cur[i - bpp];
        break;
      case 2:
        for (size_t i = 0; i < row_bytes; i++) cur[i] += prev[i];
        break;
      case 3:
        for (size_t i = 0; i < row_bytes; i++) {
          int left = i >= bpp ? cur[i - bpp] : 0;
          cur[i] += (uint8_t)((left + prev[i]) >> 1);
        }
        break;
      case 4:
        for (size_t i = 0; i < row_bytes; i++) {
          int a = i >= bpp ? cur[i - bpp] : 0, b = prev[i];
          int c = i >= bpp ? prev[i - bpp] : 0;
          int p = a + b - c;
          int pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
          cur[i] += (uint8_t)((pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c));
        }
        break;
      default:
        *err = "bad PNG filter type";
        return false;
    }
  }
  // Samples -> 8-bit HWC.
  const int out_c = (color == 2 || color == 3 || color == 6) ? 3 : 1;
  *width = (int)w;
  *height = (int)h;
  *channels = out_c;
  out->resize((size_t)h * w * out_c);
  if (color == 3 && palette.size() < 3) {
    *err = "palette PNG without PLTE";
    return false;
  }
  const size_t n_pal = palette.size() / 3;
  for (uint32_t y = 0; y < h; y++) {
    const uint8_t* src = raw.data() + y * (row_bytes + 1) + 1;
    uint8_t* dst = out->data() + (size_t)y * w * out_c;
    for (uint32_t x = 0; x < w; x++) {
      if (depth < 8) {  // gray or palette, packed high bits first
        size_t bit = (size_t)x * depth;
        int v = (src[bit >> 3] >> (8 - depth - (bit & 7))) & ((1 << depth) - 1);
        if (color == 3) {
          if ((size_t)v >= n_pal) { *err = "palette index out of range"; return false; }
          for (int k = 0; k < 3; k++) dst[x * 3 + k] = palette[v * 3 + k];
        } else {
          dst[x] = (uint8_t)(v * (255 / ((1 << depth) - 1)));
        }
        continue;
      }
      const size_t step = depth / 8;  // bytes a sample; keep the high byte
      const uint8_t* px = src + (size_t)x * samples * step;
      if (color == 3) {
        int v = px[0];
        if ((size_t)v >= n_pal) { *err = "palette index out of range"; return false; }
        for (int k = 0; k < 3; k++) dst[x * 3 + k] = palette[v * 3 + k];
      } else {
        for (int k = 0; k < out_c; k++) dst[x * out_c + k] = px[k * step];
      }
    }
  }
  return true;
}

}  // namespace

extern "C" {

void* gl_open(const char* zip_path) {
  Loader* L = new Loader();
  L->file = fopen(zip_path, "rb");
  if (!L->file) {
    L->error = "cannot open file";
    return L;
  }
  if (!parse_zip(L) || L->images.empty()) {
    if (L->error.empty()) L->error = "no images in zip";
    return L;
  }
  // Probe the first image for the dataset shape.
  std::vector<uint8_t> bytes, pixels;
  std::string err;
  if (read_entry(L, L->images[0], &bytes, &err) &&
      decode_png(bytes.data(), bytes.size(), &pixels, &L->channels,
                 &L->height, &L->width, &err)) {
    return L;
  }
  L->error = err.empty() ? "probe failed" : err;
  return L;
}

const char* gl_error(void* handle) {
  Loader* L = (Loader*)handle;
  return L->error.empty() ? nullptr : L->error.c_str();
}

long long gl_num_images(void* handle) {
  return (long long)((Loader*)handle)->images.size();
}

void gl_shape(void* handle, int* c, int* h, int* w) {
  Loader* L = (Loader*)handle;
  *c = L->channels;
  *h = L->height;
  *w = L->width;
}

// Decode `n` images (raw dataset indices) into out[n, C, H, W] uint8,
// x-flipping entry i when xflip[i] != 0.  Returns 0 on success.
int gl_read_batch(void* handle, const long long* indices,
                  const unsigned char* xflip, int n, unsigned char* out) {
  Loader* L = (Loader*)handle;
  const int C = L->channels, H = L->height, W = L->width;
  const size_t img_elems = (size_t)C * H * W;
  std::atomic<int> failed{0};

  int n_threads = std::min((int)std::thread::hardware_concurrency(),
                           std::max(n, 1));
  n_threads = std::max(1, std::min(n_threads, 16));

  auto worker = [&](int tid) {
    std::vector<uint8_t> bytes, pixels;
    std::string err;
    for (int i = tid; i < n; i += n_threads) {
      long long idx = indices[i];
      if (idx < 0 || idx >= (long long)L->images.size()) { failed = 1; continue; }
      int c, h, w;
      if (!read_entry(L, L->images[idx], &bytes, &err) ||
          !decode_png(bytes.data(), bytes.size(), &pixels, &c, &h, &w,
                      &err) || c != C || h != H || w != W) {
        failed = 1;
        continue;
      }
      // HWC -> CHW with optional horizontal flip.
      unsigned char* dst = out + (size_t)i * img_elems;
      bool flip = xflip && xflip[i];
      for (int ch = 0; ch < C; ch++) {
        for (int y = 0; y < H; y++) {
          const uint8_t* src_row = pixels.data() + ((size_t)y * W) * C + ch;
          unsigned char* dst_row = dst + ((size_t)ch * H + y) * W;
          if (!flip) {
            for (int x = 0; x < W; x++) dst_row[x] = src_row[(size_t)x * C];
          } else {
            for (int x = 0; x < W; x++)
              dst_row[x] = src_row[(size_t)(W - 1 - x) * C];
          }
        }
      }
    }
  };

  std::vector<std::thread> threads;
  for (int t = 0; t < n_threads; t++) threads.emplace_back(worker, t);
  for (auto& t : threads) t.join();
  return failed.load();
}

void gl_close(void* handle) {
  Loader* L = (Loader*)handle;
  if (L->file) fclose(L->file);
  delete L;
}

}  // extern "C"
