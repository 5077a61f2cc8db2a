// chadaloader — native host data loader for chadavit_tpu_torch.
//
// The port's copy of native/chadaloader.cpp, with each codec built only where
// its header is found (chadavit_tpu_torch/data/native.py probes them and
// passes CHADA_HAVE_*). A replacement for the reference's host-side decode stack
// (PIL / opencv / tifffile / NVIDIA DALI wrappers, reference
// src/data/dali_dataloader.py, src/utils/misc.py:465-478 and
// custom_datasets.py:166-190): a C++ threadpool that decodes per-channel
// image files (PNG 8/16-bit via libpng, JPEG via libjpeg, TIFF 8/16-bit via
// libtiff), bilinear-resizes (optionally shorter-side + center crop, the eval
// protocol), normalizes, and writes directly into a dense (B, C_max, H, W)
// float32 batch buffer — the exact layout the jitted train step consumes. No
// Python in the per-image inner loop; the GIL is released for the whole batch.
//
// C ABI (ctypes-friendly):
//   chada_decode_plane(path, out, out_cap, &w, &h)      decode one plane (f32, native size)
//   chada_decode_plane_raw(path, out, cap, &w, &h, &d)  raw u8/u16 bytes + bit depth
//   chada_load_dense_batch(...)                         square resize, legacy scale
//   chada_load_dense_batch_v2(..., resize_mode, resize_size, normalize)
//     resize_mode: 0 square->(H,W); 1 square->(resize_size)^2 then center crop;
//                  2 shorter-side->resize_size then center crop
//     normalize:   1 -> divide by the plane's dtype max (255/65535) before scale
//
//   chada_codecs()                                      bit mask of the codecs built
//
// Codecs, each compiled in only with its macro (and header):
//   CHADA_HAVE_DEFLATE  libdeflate  inflate of the grayscale PNG fast path
//   CHADA_HAVE_ZLIB     zlib        the same inflate where libdeflate is missing
//   CHADA_HAVE_PNG      libpng      every other PNG (palette, RGB, interlaced)
//   CHADA_HAVE_JPEG     libjpeg     JPEG
//   CHADA_HAVE_TIFF     libtiff     TIFF
// A file whose codec was not built fails with -16 - (the codec's bit), never
// decoded another way.
//
// Build: g++ -O3 -std=c++17 -shared -fPIC chadaloader.cpp -DCHADA_HAVE_... -l...
//        (driven by chadavit_tpu_torch/data/native.py)

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <csetjmp>
#include <string>
#include <thread>
#include <vector>

#if defined(CHADA_HAVE_DEFLATE)
#include <libdeflate.h>
#elif defined(CHADA_HAVE_ZLIB)
#include <zlib.h>
#endif
#ifdef CHADA_HAVE_PNG
#include <png.h>
#endif
#ifdef CHADA_HAVE_TIFF
#include <tiffio.h>
#endif
#ifdef CHADA_HAVE_JPEG
extern "C" {
#include <jpeglib.h>
}
#endif

namespace {

// codec bits (chada_codecs, and the failure code of a file whose codec is missing)
constexpr int CODEC_PNG_FAST = 1;  // the grayscale PNG fast path (an inflate)
constexpr int CODEC_PNG = 2;       // libpng
constexpr int CODEC_JPEG = 4;
constexpr int CODEC_TIFF = 8;

struct Plane {
  std::vector<float> data;
  int w = 0, h = 0;
  int depth = 8;  // source bit depth: 8, 16, or 32 (float)
  bool ok = false;
};

// raw-bytes variant: pixels in the source integer dtype (u8 / LE u16; depth 32
// stores IEEE floats) — the zero-conversion path for the uint8/uint16
// host->device transfer layout (decode never touches float for 8/16-bit files)
struct RawPlane {
  std::vector<uint8_t> bytes;
  int w = 0, h = 0;
  int depth = 8;
  bool ok = false;
  bool other = false;  // a PNG, but not the fast path's case
  int missing = 0;     // the codec bit this file needs and the build lacks
};

// zlib-wrapped stream -> out (exactly out_size bytes); false on any error
bool inflate_exact(const uint8_t* z, size_t n, uint8_t* out, size_t out_size) {
#if defined(CHADA_HAVE_DEFLATE)
  libdeflate_decompressor* d = libdeflate_alloc_decompressor();
  if (!d) return false;
  size_t actual = 0;
  const int res = libdeflate_zlib_decompress(d, z, n, out, out_size, &actual);
  libdeflate_free_decompressor(d);
  return res == LIBDEFLATE_SUCCESS && actual == out_size;
#elif defined(CHADA_HAVE_ZLIB)
  uLongf actual = (uLongf)out_size;
  const int res = uncompress(out, &actual, z, (uLong)n);
  return res == Z_OK && actual == out_size;
#else
  (void)z; (void)n; (void)out; (void)out_size;
  return false;
#endif
}

// ---------------------------------------------------------------- PNG ----
// Fast path: minimal decoder for the microscopy hot case — 8/16-bit
// GRAYSCALE, non-interlaced PNG (color type 0), which is what per-channel
// plane files are. IDAT inflates through libdeflate (~2x zlib) and the
// row unfilter is a tight loop over 1-2 byte pixels; everything else
// (palette/RGB/alpha/interlaced/sub-byte) falls back to libpng below.
RawPlane decode_png_fast(const uint8_t* p, size_t n) {
  RawPlane out;
  static const uint8_t sig[8] = {0x89, 'P', 'N', 'G', 0x0d, 0x0a, 0x1a, 0x0a};
  if (n < 8 + 25 || std::memcmp(p, sig, 8) != 0) return out;
  auto u32 = [&](size_t o) -> uint32_t {
    return ((uint32_t)p[o] << 24) | ((uint32_t)p[o + 1] << 16) |
           ((uint32_t)p[o + 2] << 8) | (uint32_t)p[o + 3];
  };
  size_t off = 8;  // IHDR must be the first chunk (PNG spec)
  if (u32(off) != 13 || std::memcmp(p + off + 4, "IHDR", 4) != 0) return out;
  const uint32_t w = u32(off + 8), h = u32(off + 12);
  const uint8_t bd = p[off + 16], ct = p[off + 17];
  const uint8_t comp = p[off + 18], filt = p[off + 19], il = p[off + 20];
  if (!w || !h || ct != 0 || (bd != 8 && bd != 16) || comp || filt || il) {
    out.other = true;  // not the grayscale hot case -> libpng
    return out;
  }
  if ((uint64_t)w * h > (uint64_t)1 << 30) return out;
  off += 8 + 13 + 4;
  // gather IDAT payload spans (no CRC checks: inflate's adler32 validates)
  std::vector<std::pair<const uint8_t*, size_t>> spans;
  size_t total = 0;
  while (off + 8 <= n) {
    const uint32_t len = u32(off);
    const uint8_t* type = p + off + 4;
    if (off + 8 + (size_t)len + 4 > n) return out;
    if (std::memcmp(type, "IDAT", 4) == 0) {
      spans.emplace_back(p + off + 8, (size_t)len);
      total += len;
    } else if (std::memcmp(type, "IEND", 4) == 0) {
      break;
    }
    off += 8 + (size_t)len + 4;
  }
  if (!total) return out;
  std::vector<uint8_t> joined;  // libdeflate needs one contiguous buffer
  const uint8_t* z = spans.size() == 1 ? spans[0].first : nullptr;
  if (!z) {
    joined.reserve(total);
    for (const auto& s : spans) joined.insert(joined.end(), s.first, s.first + s.second);
    z = joined.data();
  }
  const size_t bpp = bd / 8;
  const size_t rowbytes = (size_t)w * bpp;
  std::vector<uint8_t> raw((rowbytes + 1) * h);  // +1 filter byte per row
  if (!inflate_exact(z, total, raw.data(), raw.size())) return out;
  out.bytes.resize(rowbytes * h);
  const uint8_t* prev = nullptr;
  for (uint32_t y = 0; y < h; ++y) {
    const uint8_t* src = raw.data() + (size_t)y * (rowbytes + 1) + 1;
    const uint8_t ft = src[-1];
    uint8_t* dst = out.bytes.data() + (size_t)y * rowbytes;
    switch (ft) {
      case 0:  // None
        std::memcpy(dst, src, rowbytes);
        break;
      case 1:  // Sub
        std::memcpy(dst, src, bpp);
        for (size_t i = bpp; i < rowbytes; ++i) dst[i] = (uint8_t)(src[i] + dst[i - bpp]);
        break;
      case 2:  // Up
        if (!prev) std::memcpy(dst, src, rowbytes);
        else
          for (size_t i = 0; i < rowbytes; ++i) dst[i] = (uint8_t)(src[i] + prev[i]);
        break;
      case 3:  // Average
        for (size_t i = 0; i < bpp; ++i)
          dst[i] = (uint8_t)(src[i] + ((prev ? prev[i] : 0) >> 1));
        for (size_t i = bpp; i < rowbytes; ++i)
          dst[i] = (uint8_t)(src[i] +
                             (uint8_t)(((unsigned)dst[i - bpp] + (prev ? prev[i] : 0)) >> 1));
        break;
      case 4:  // Paeth
        for (size_t i = 0; i < bpp; ++i) dst[i] = (uint8_t)(src[i] + (prev ? prev[i] : 0));
        for (size_t i = bpp; i < rowbytes; ++i) {
          const int a = dst[i - bpp], b = prev ? prev[i] : 0, c = prev ? prev[i - bpp] : 0;
          const int pa = std::abs(b - c), pb = std::abs(a - c), pc = std::abs(a + b - 2 * c);
          const int pr = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          dst[i] = (uint8_t)(src[i] + pr);
        }
        break;
      default: {  // corrupt filter byte -> let libpng report it
        RawPlane bad;
        bad.other = true;
        return bad;
      }
    }
    prev = dst;
  }
  if (bd == 16)  // PNG is big-endian; RawPlane wants LE u16
    for (size_t i = 0; i + 1 < out.bytes.size(); i += 2) std::swap(out.bytes[i], out.bytes[i + 1]);
  out.w = (int)w;
  out.h = (int)h;
  out.depth = bd;
  out.ok = true;
  return out;
}

#ifdef CHADA_HAVE_PNG
RawPlane decode_png_raw(FILE* f) {
  RawPlane out;
  png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) return out;
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    return out;
  }
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    return out;
  }
  // skip per-chunk CRC verification on the hot decode path: inflate itself
  // still validates the stream (zlib adler32), and a corrupt file surfaces
  // as a decode error either way — crc32 over IDAT is pure overhead here
  png_set_crc_action(png, PNG_CRC_QUIET_USE, PNG_CRC_QUIET_USE);
  png_init_io(png, f);
  png_read_info(png, info);

  png_uint_32 w = png_get_image_width(png, info);
  png_uint_32 h = png_get_image_height(png, info);
  int bit_depth = png_get_bit_depth(png, info);
  int color = png_get_color_type(png, info);

  // normalize to 8- or 16-bit grayscale (single-channel microscopy planes;
  // color inputs collapse to their first channel after rgb->gray)
  if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color == PNG_COLOR_TYPE_GRAY && bit_depth < 8) png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  if (color & PNG_COLOR_MASK_ALPHA) png_set_strip_alpha(png);
  if (color == PNG_COLOR_TYPE_RGB || color == PNG_COLOR_TYPE_RGB_ALPHA ||
      color == PNG_COLOR_TYPE_PALETTE)
    png_set_rgb_to_gray_fixed(png, 1, -1, -1);
  if (bit_depth == 16) png_set_swap(png);  // PNG is big-endian; we want LE u16
  png_read_update_info(png, info);

  bit_depth = png_get_bit_depth(png, info);
  const size_t rowbytes = png_get_rowbytes(png, info);
  const size_t px = (size_t)(bit_depth == 16 ? 2 : 1);
  out.bytes.resize((size_t)w * h * px);
  std::vector<png_bytep> rows(h);
  if (rowbytes == w * px) {  // gray rows are tightly packed: read in place
    for (png_uint_32 y = 0; y < h; ++y) rows[y] = out.bytes.data() + (size_t)y * rowbytes;
    png_read_image(png, rows.data());
  } else {  // defensive: unexpected padding, bounce through a scratch buffer
    std::vector<uint8_t> raw(rowbytes * h);
    for (png_uint_32 y = 0; y < h; ++y) rows[y] = raw.data() + (size_t)y * rowbytes;
    png_read_image(png, rows.data());
    for (png_uint_32 y = 0; y < h; ++y)
      std::memcpy(out.bytes.data() + (size_t)y * w * px, raw.data() + (size_t)y * rowbytes,
                  w * px);
  }
  png_destroy_read_struct(&png, &info, nullptr);

  out.w = (int)w;
  out.h = (int)h;
  out.depth = bit_depth == 16 ? 16 : 8;
  out.ok = true;
  return out;
}
#endif  // CHADA_HAVE_PNG

#ifdef CHADA_HAVE_TIFF
// --------------------------------------------------------------- TIFF ----
// 8/16-bit grayscale (the microscopy format; reference decodes via
// tifffile/cv2 IMREAD_UNCHANGED, misc.py:465-478) and 32-bit float; RGB
// collapses to luma. Strip- and tile-organized files via TIFFReadScanline /
// TIFFReadEncodedTile.
Plane decode_tiff(const char* path) {
  Plane out;
  TIFFSetErrorHandler(nullptr);   // quiet; failure returns !ok
  TIFFSetWarningHandler(nullptr);
  TIFF* tif = TIFFOpen(path, "r");
  if (!tif) return out;
  uint32_t w = 0, h = 0;
  uint16_t bits = 8, spp = 1, fmt = SAMPLEFORMAT_UINT;
  TIFFGetField(tif, TIFFTAG_IMAGEWIDTH, &w);
  TIFFGetField(tif, TIFFTAG_IMAGELENGTH, &h);
  TIFFGetFieldDefaulted(tif, TIFFTAG_BITSPERSAMPLE, &bits);
  TIFFGetFieldDefaulted(tif, TIFFTAG_SAMPLESPERPIXEL, &spp);
  TIFFGetFieldDefaulted(tif, TIFFTAG_SAMPLEFORMAT, &fmt);
  if (!w || !h || (bits != 8 && bits != 16 && bits != 32)) {
    TIFFClose(tif);
    return out;
  }
  out.w = (int)w;
  out.h = (int)h;
  out.depth = (fmt == SAMPLEFORMAT_IEEEFP) ? 32 : (int)bits;
  out.data.resize((size_t)w * h);

  auto to_gray = [&](const uint8_t* row, float* dst, uint32_t ncols) {
    for (uint32_t x = 0; x < ncols; ++x) {
      double acc = 0;
      int used = std::min<int>(spp, 3);  // average first <=3 (RGB) samples
      for (int s = 0; s < used; ++s) {
        size_t i = (size_t)x * spp + s;
        if (bits == 8) acc += row[i];
        else if (bits == 16) acc += reinterpret_cast<const uint16_t*>(row)[i];
        else acc += reinterpret_cast<const float*>(row)[i];
      }
      dst[x] = (float)(acc / used);
    }
  };

  bool ok = true;
  if (TIFFIsTiled(tif)) {
    uint32_t tw = 0, th_ = 0;
    TIFFGetField(tif, TIFFTAG_TILEWIDTH, &tw);
    TIFFGetField(tif, TIFFTAG_TILELENGTH, &th_);
    std::vector<uint8_t> tile(TIFFTileSize(tif));
    std::vector<float> tmp(tw);
    for (uint32_t y0 = 0; y0 < h && ok; y0 += th_) {
      for (uint32_t x0 = 0; x0 < w && ok; x0 += tw) {
        if (TIFFReadTile(tif, tile.data(), x0, y0, 0, 0) < 0) { ok = false; break; }
        for (uint32_t ty = 0; ty < th_ && y0 + ty < h; ++ty) {
          const uint8_t* row = tile.data() + (size_t)ty * tw * spp * (bits / 8);
          to_gray(row, tmp.data(), tw);
          uint32_t n = std::min<uint32_t>(tw, w - x0);
          std::memcpy(out.data.data() + (size_t)(y0 + ty) * w + x0, tmp.data(),
                      n * sizeof(float));
        }
      }
    }
  } else {
    std::vector<uint8_t> row(TIFFScanlineSize(tif));
    for (uint32_t y = 0; y < h; ++y) {
      if (TIFFReadScanline(tif, row.data(), y) < 0) { ok = false; break; }
      to_gray(row.data(), out.data.data() + (size_t)y * w, w);
    }
  }
  TIFFClose(tif);
  out.ok = ok;
  return out;
}

#endif  // CHADA_HAVE_TIFF

#ifdef CHADA_HAVE_JPEG
// --------------------------------------------------------------- JPEG ----
struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jb;
};
void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* e = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(e->jb, 1);
}

RawPlane decode_jpeg_raw(FILE* f) {
  RawPlane out;
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return out;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_GRAYSCALE;
  jpeg_start_decompress(&cinfo);
  out.w = cinfo.output_width;
  out.h = cinfo.output_height;
  out.depth = 8;
  out.bytes.resize((size_t)out.w * out.h);
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW rp = out.bytes.data() + (size_t)cinfo.output_scanline * out.w;
    jpeg_read_scanlines(&cinfo, &rp, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  out.ok = true;
  return out;
}
#endif  // CHADA_HAVE_JPEG

// float <- raw conversion (for the legacy float entry points)
Plane plane_from_raw(RawPlane&& r) {
  Plane p;
  if (!r.ok) return p;
  p.w = r.w;
  p.h = r.h;
  p.depth = r.depth;
  const size_t n = (size_t)r.w * r.h;
  p.data.resize(n);
  if (r.depth == 16) {
    const uint16_t* s = reinterpret_cast<const uint16_t*>(r.bytes.data());
    for (size_t i = 0; i < n; ++i) p.data[i] = (float)s[i];
  } else if (r.depth == 32) {
    std::memcpy(p.data.data(), r.bytes.data(), n * sizeof(float));
  } else {
    for (size_t i = 0; i < n; ++i) p.data[i] = (float)r.bytes[i];
  }
  p.ok = true;
  return p;
}

#ifdef CHADA_HAVE_TIFF
// raw <- float conversion (TIFF rgb->gray / float fallback path)
RawPlane raw_from_plane(Plane&& p) {
  RawPlane r;
  if (!p.ok) return r;
  r.w = p.w;
  r.h = p.h;
  r.depth = p.depth;
  const size_t n = (size_t)p.w * p.h;
  if (p.depth == 32) {
    r.bytes.resize(n * sizeof(float));
    std::memcpy(r.bytes.data(), p.data.data(), n * sizeof(float));
  } else if (p.depth == 16) {
    r.bytes.resize(n * 2);
    uint16_t* d = reinterpret_cast<uint16_t*>(r.bytes.data());
    for (size_t i = 0; i < n; ++i)
      d[i] = (uint16_t)std::min(std::max(p.data[i], 0.0f), 65535.0f);
  } else {
    r.bytes.resize(n);
    for (size_t i = 0; i < n; ++i)
      r.bytes[i] = (uint8_t)std::min(std::max(p.data[i], 0.0f), 255.0f);
  }
  r.ok = true;
  return r;
}

// TIFF raw fast path: single-sample 8/16-bit strips/tiles memcpy straight to
// bytes (the microscopy layout); anything else bounces through the float path.
RawPlane decode_tiff_raw(const char* path) {
  RawPlane out;
  TIFFSetErrorHandler(nullptr);
  TIFFSetWarningHandler(nullptr);
  TIFF* tif = TIFFOpen(path, "r");
  if (!tif) return out;
  uint32_t w = 0, h = 0;
  uint16_t bits = 8, spp = 1, fmt = SAMPLEFORMAT_UINT;
  TIFFGetField(tif, TIFFTAG_IMAGEWIDTH, &w);
  TIFFGetField(tif, TIFFTAG_IMAGELENGTH, &h);
  TIFFGetFieldDefaulted(tif, TIFFTAG_BITSPERSAMPLE, &bits);
  TIFFGetFieldDefaulted(tif, TIFFTAG_SAMPLESPERPIXEL, &spp);
  TIFFGetFieldDefaulted(tif, TIFFTAG_SAMPLEFORMAT, &fmt);
  const bool fast = w && h && spp == 1 && (bits == 8 || bits == 16) &&
                    fmt != SAMPLEFORMAT_IEEEFP && !TIFFIsTiled(tif);
  if (!fast) {
    TIFFClose(tif);
    return raw_from_plane(decode_tiff(path));
  }
  const size_t px = bits / 8;
  out.w = (int)w;
  out.h = (int)h;
  out.depth = (int)bits;
  out.bytes.resize((size_t)w * h * px);
  bool ok = ((size_t)TIFFScanlineSize(tif) == (size_t)w * px);
  for (uint32_t y = 0; ok && y < h; ++y)
    if (TIFFReadScanline(tif, out.bytes.data() + (size_t)y * w * px, y) < 0) ok = false;
  TIFFClose(tif);
  out.ok = ok;
  if (!ok) return raw_from_plane(decode_tiff(path));
  return out;
}
#endif  // CHADA_HAVE_TIFF

RawPlane decode_file_raw(const char* path) {
  RawPlane out;
  FILE* f = fopen(path, "rb");
  if (!f) return out;
  uint8_t magic[4] = {0};
  if (fread(magic, 1, 4, f) != 4) {
    fclose(f);
    return out;
  }
  rewind(f);
  if (magic[0] == 0x89 && magic[1] == 'P') {
    // whole-file read, then the libdeflate grayscale fast path; exotic PNGs
    // (palette/RGB/alpha/interlaced) fall back to libpng on the same buffer
    std::fseek(f, 0, SEEK_END);
    const long fsz = std::ftell(f);
    std::rewind(f);
    if (fsz > 0) {
      std::vector<uint8_t> buf((size_t)fsz);
      if (std::fread(buf.data(), 1, buf.size(), f) == buf.size()) {
#if defined(CHADA_HAVE_DEFLATE) || defined(CHADA_HAVE_ZLIB)
        out = decode_png_fast(buf.data(), buf.size());
#else
        out.other = true;
#endif
        if (!out.ok) {
#ifdef CHADA_HAVE_PNG
          std::rewind(f);
          out = decode_png_raw(f);
#else
          if (out.other) out.missing = CODEC_PNG;
#endif
        }
      }
    }
    fclose(f);
  } else if (magic[0] == 0xFF && magic[1] == 0xD8) {
#ifdef CHADA_HAVE_JPEG
    out = decode_jpeg_raw(f);
#else
    out.missing = CODEC_JPEG;
#endif
    fclose(f);
  } else if ((magic[0] == 'I' && magic[1] == 'I' && magic[2] == 42) ||
             (magic[0] == 'M' && magic[1] == 'M' && magic[3] == 42)) {
    fclose(f);  // libtiff opens by path
#ifdef CHADA_HAVE_TIFF
    out = decode_tiff_raw(path);
#else
    out.missing = CODEC_TIFF;
#endif
  } else {
    fclose(f);
  }
  return out;
}

Plane decode_file(const char* path, int* missing = nullptr) {
  RawPlane r = decode_file_raw(path);
  if (missing) *missing = r.missing;
  return plane_from_raw(std::move(r));
}

// bilinear resample (half-pixel centers) of a virtual (vh, vw) resize of src,
// reading only the window starting at (oy, ox) of size (th, tw) — i.e.
// Resize(vh, vw) followed by a crop, without materializing the resize.
void resize_bilinear_window(const float* src, int h, int w, float* dst, int th,
                            int tw, int vh, int vw, int oy, int ox, float scale) {
  if (h == vh && w == vw && oy == 0 && ox == 0 && th == vh && tw == vw) {
    for (size_t i = 0; i < (size_t)th * tw; ++i) dst[i] = src[i] * scale;
    return;
  }
  const float sy = (float)h / vh, sx = (float)w / vw;
  for (int y = 0; y < th; ++y) {
    float fy = (y + oy + 0.5f) * sy - 0.5f;
    int y0 = (int)std::floor(fy);
    float wy = fy - y0;
    int y1 = std::min(y0 + 1, h - 1);
    y0 = std::max(y0, 0);
    for (int x = 0; x < tw; ++x) {
      float fx = (x + ox + 0.5f) * sx - 0.5f;
      int x0 = (int)std::floor(fx);
      float wx = fx - x0;
      int x1 = std::min(x0 + 1, w - 1);
      x0 = std::max(x0, 0);
      float v00 = src[(size_t)y0 * w + x0], v01 = src[(size_t)y0 * w + x1];
      float v10 = src[(size_t)y1 * w + x0], v11 = src[(size_t)y1 * w + x1];
      dst[(size_t)y * tw + x] =
          ((v00 * (1 - wx) + v01 * wx) * (1 - wy) + (v10 * (1 - wx) + v11 * wx) * wy) *
          scale;
    }
  }
}

// plain square resize (the legacy / training path)
void resize_bilinear(const float* src, int h, int w, float* dst, int th, int tw,
                     float scale) {
  resize_bilinear_window(src, h, w, dst, th, tw, th, tw, 0, 0, scale);
}

float plane_norm(const Plane& p) {
  if (p.depth == 16) return 1.0f / 65535.0f;
  if (p.depth == 32) return 1.0f;  // float TIFF assumed already scaled
  return 1.0f / 255.0f;
}

// resize_mode semantics shared by the batch entry points
void emit_plane(const Plane& p, float* dst, int th, int tw, int resize_mode,
                int resize_size, float scale) {
  if (resize_mode == 1) {  // A.Resize(square) -> CenterCrop (albumentations val)
    int v = std::max(resize_size, 1);
    resize_bilinear_window(p.data.data(), p.h, p.w, dst, th, tw, v, v,
                           (v - th) / 2, (v - tw) / 2, scale);
  } else if (resize_mode == 2) {  // Resize(shorter) -> CenterCrop (torchvision val)
    int v = std::max(resize_size, 1);
    int vh, vw;
    if (p.h <= p.w) {
      vh = v;
      vw = std::max(1, (int)std::lround((double)p.w * v / p.h));
    } else {
      vw = v;
      vh = std::max(1, (int)std::lround((double)p.h * v / p.w));
    }
    resize_bilinear_window(p.data.data(), p.h, p.w, dst, th, tw, vh, vw,
                           (vh - th) / 2, (vw - tw) / 2, scale);
  } else {
    resize_bilinear(p.data.data(), p.h, p.w, dst, th, tw, scale);
  }
}

}  // namespace

extern "C" {

// The codecs of this build, as the CODEC_* bits.
int chada_codecs() {
  int bits = 0;
#if defined(CHADA_HAVE_DEFLATE) || defined(CHADA_HAVE_ZLIB)
  bits |= CODEC_PNG_FAST;
#endif
#ifdef CHADA_HAVE_PNG
  bits |= CODEC_PNG;
#endif
#ifdef CHADA_HAVE_JPEG
  bits |= CODEC_JPEG;
#endif
#ifdef CHADA_HAVE_TIFF
  bits |= CODEC_TIFF;
#endif
  return bits;
}

// Decode one plane at native resolution into out (capacity out_cap floats).
// Returns 0 on success, negative on failure (-16 - bit: the file's codec
// was not built); writes natural size to w/h.
int chada_decode_plane(const char* path, float* out, long out_cap, int* w, int* h) {
  int missing = 0;
  Plane p = decode_file(path, &missing);
  if (!p.ok) return missing ? -16 - missing : -1;
  if ((long)p.data.size() > out_cap) {
    *w = p.w;
    *h = p.h;
    return -2;  // caller must re-alloc and retry
  }
  std::memcpy(out, p.data.data(), p.data.size() * sizeof(float));
  *w = p.w;
  *h = p.h;
  return 0;
}

// Raw integer decode: writes u8 or u16 (little-endian) pixels into out and
// reports the bit depth — the 1-2 bytes/pixel host->device transfer path
// (on-device normalization). 32f TIFF is not raw-representable -> -3.
int chada_decode_plane_raw(const char* path, uint8_t* out, long out_cap_bytes,
                           int* w, int* h, int* depth) {
  RawPlane p = decode_file_raw(path);
  if (!p.ok) return p.missing ? -16 - p.missing : -1;
  *w = p.w;
  *h = p.h;
  *depth = p.depth;
  if (p.depth == 32) return -3;
  const long need = (long)p.bytes.size();
  if (need > out_cap_bytes) return -2;
  std::memcpy(out, p.bytes.data(), p.bytes.size());
  return 0;
}

// Decode a whole batch into a dense (B, C_max, H, W) u8 or u16 (out_depth 8 /
// 16) buffer — the raw-transfer training path (normalize-on-device). Planes
// matching the target size and depth are straight memcpys from the decoder;
// size mismatches take a float bilinear resize; depth mismatches rescale
// (u8*257 <-> u16>>8). Padded channel planes are left untouched (caller
// zero-fills once). Returns the number of failed planes.
int chada_load_dense_batch_raw(const char** paths, const long* offsets, int batch,
                               int max_channels, int th, int tw, uint8_t* out,
                               int* counts, int num_threads, int out_depth) {
  std::atomic<int> failures{0};
  std::atomic<int> next{0};
  const size_t opx = out_depth == 16 ? 2 : 1;
  const size_t plane_bytes = (size_t)th * tw * opx;

  auto work = [&]() {
    std::vector<float> fsrc, fdst((size_t)th * tw);
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= batch) return;
      long s = offsets[i], e = offsets[i + 1];
      int c = (int)std::min<long>(e - s, max_channels);
      counts[i] = c;
      for (int j = 0; j < c; ++j) {
        RawPlane p = decode_file_raw(paths[s + j]);
        uint8_t* dst = out + ((size_t)i * max_channels + j) * plane_bytes;
        if (!p.ok || p.depth == 32) {
          failures.fetch_add(1);
          std::memset(dst, 0, plane_bytes);
          continue;
        }
        if (p.w == tw && p.h == th) {
          const size_t n = (size_t)th * tw;
          if (p.depth == out_depth) {
            std::memcpy(dst, p.bytes.data(), plane_bytes);
          } else if (p.depth == 8) {  // u8 -> u16 (x257 maps 255 -> 65535)
            uint16_t* o = reinterpret_cast<uint16_t*>(dst);
            for (size_t k = 0; k < n; ++k) o[k] = (uint16_t)(p.bytes[k] * 257);
          } else {  // u16 -> u8
            const uint16_t* sp = reinterpret_cast<const uint16_t*>(p.bytes.data());
            for (size_t k = 0; k < n; ++k) dst[k] = (uint8_t)(sp[k] >> 8);
          }
        } else {  // resize through float, then convert with depth rescale
          const size_t n = (size_t)p.w * p.h;
          fsrc.resize(n);
          if (p.depth == 16) {
            const uint16_t* sp = reinterpret_cast<const uint16_t*>(p.bytes.data());
            for (size_t k = 0; k < n; ++k) fsrc[k] = (float)sp[k];
          } else {
            for (size_t k = 0; k < n; ++k) fsrc[k] = (float)p.bytes[k];
          }
          float sc = 1.0f;
          if (p.depth == 8 && out_depth == 16) sc = 257.0f;
          else if (p.depth == 16 && out_depth == 8) sc = 1.0f / 257.0f;
          resize_bilinear(fsrc.data(), p.h, p.w, fdst.data(), th, tw, sc);
          const size_t m = (size_t)th * tw;
          if (out_depth == 16) {
            uint16_t* o = reinterpret_cast<uint16_t*>(dst);
            for (size_t k = 0; k < m; ++k)
              o[k] = (uint16_t)std::min(std::max(fdst[k] + 0.5f, 0.0f), 65535.0f);
          } else {
            for (size_t k = 0; k < m; ++k)
              dst[k] = (uint8_t)std::min(std::max(fdst[k] + 0.5f, 0.0f), 255.0f);
          }
        }
      }
    }
  };

  int nt = std::max(1, std::min(num_threads, batch));
  std::vector<std::thread> threads;
  threads.reserve(nt);
  for (int t = 0; t < nt; ++t) threads.emplace_back(work);
  for (auto& t : threads) t.join();
  return failures.load();
}

// Decode + resize + scale a whole batch into a dense (B, C_max, H, W) float32
// buffer (padded channel planes left untouched — caller zero-fills).
//   paths:   flat array of C-string pointers, grouped per image
//   offsets: per-image start index into paths (len B+1)
//   counts:  out (B,) actual channel counts (min(cap, files))
// Returns number of failed planes (0 == all good).
int chada_load_dense_batch_v2(const char** paths, const long* offsets, int batch,
                              int max_channels, int th, int tw, float* out,
                              int* counts, int num_threads, float scale,
                              int resize_mode, int resize_size, int normalize) {
  std::atomic<int> failures{0};
  std::atomic<int> next{0};

  auto work = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= batch) return;
      long s = offsets[i], e = offsets[i + 1];
      int c = (int)std::min<long>(e - s, max_channels);
      counts[i] = c;
      for (int j = 0; j < c; ++j) {
        Plane p = decode_file(paths[s + j]);
        float* dst = out + ((size_t)i * max_channels + j) * th * tw;
        if (!p.ok) {
          failures.fetch_add(1);
          std::memset(dst, 0, (size_t)th * tw * sizeof(float));
          continue;
        }
        float sc = scale * (normalize ? plane_norm(p) : 1.0f);
        emit_plane(p, dst, th, tw, resize_mode, resize_size, sc);
      }
    }
  };

  int nt = std::max(1, std::min(num_threads, batch));
  std::vector<std::thread> threads;
  threads.reserve(nt);
  for (int t = 0; t < nt; ++t) threads.emplace_back(work);
  for (auto& t : threads) t.join();
  return failures.load();
}

// legacy entry point: square resize, raw scale only
int chada_load_dense_batch(const char** paths, const long* offsets, int batch,
                           int max_channels, int th, int tw, float* out,
                           int* counts, int num_threads, float scale) {
  return chada_load_dense_batch_v2(paths, offsets, batch, max_channels, th, tw,
                                   out, counts, num_threads, scale, 0, 0, 0);
}

}  // extern "C"
