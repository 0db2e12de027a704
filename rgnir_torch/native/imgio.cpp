// Native batch image decoder: TIFF / JPEG / PNG -> HWC uint8 RGB, and
// the PNG and TIFF encoders of the batch pipeline's writer.
//
// A copy of rgnir_tpu/native/imgio.cpp with the same C ABI, so the two
// packages decode and encode the same bytes; unlike it, a truncated TIFF
// or JPEG is a decode failure here, as it is in Pillow. It decodes directly
// through libtiff/libjpeg/libpng into caller buffers and exposes a
// thread-pooled batch API that fills a contiguous (N, H, W, 3) arena
// (the batch loader passes a pinned one): no Python objects, no GIL,
// no allocation. It builds only where the four headers exist; where
// one is missing, rgnir_torch.native.imgio reports the compiler's
// output and the callers use Pillow.
//
// C ABI (consumed via ctypes from rgnir_torch.native.imgio — no pybind11
// in this environment):
//   ii_probe(path, &w, &h)                  -> 0 | error code
//   ii_decode_rgb(path, dst, w, h)          -> 0 | error code
//   ii_decode_batch_rgb(paths, n, dst, w, h, nthreads, status)
//       -> number of successes; status[i] = 0 ok / negative code
//
// Error codes: -1 open/read failure, -2 decode failure,
//              -3 dimension mismatch, -4 unsupported format.

#include <atomic>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

#include <tiffio.h>
#include <jpeglib.h>
#include <jerror.h>
#include <png.h>
#include <zlib.h>

namespace {

constexpr int kErrOpen = -1;
constexpr int kErrDecode = -2;
constexpr int kErrDims = -3;
constexpr int kErrFormat = -4;

enum class Format { kTiff, kJpeg, kPng, kUnknown };

Format sniff(const char* path, int* err) {
  *err = kErrFormat;
  FILE* f = std::fopen(path, "rb");
  if (!f) {
    *err = kErrOpen;
    return Format::kUnknown;
  }
  unsigned char m[8] = {0};
  size_t got = std::fread(m, 1, 8, f);
  std::fclose(f);
  if (got < 4) return Format::kUnknown;
  if ((m[0] == 'I' && m[1] == 'I' && m[2] == 42 && m[3] == 0) ||
      (m[0] == 'M' && m[1] == 'M' && m[2] == 0 && m[3] == 42))
    return Format::kTiff;
  if (m[0] == 0xFF && m[1] == 0xD8) return Format::kJpeg;
  if (m[0] == 0x89 && m[1] == 'P' && m[2] == 'N' && m[3] == 'G')
    return Format::kPng;
  return Format::kUnknown;
}

// ---------------------------------------------------------------- TIFF
struct TiffSilencer {
  TiffSilencer() {
    TIFFSetErrorHandler(nullptr);
    TIFFSetWarningHandler(nullptr);
  }
};
TiffSilencer g_tiff_silencer;  // process-wide, set before any TIFFOpen

// Only 8-bit unsigned samples decode identically to PIL here:
// TIFFReadRGBAImage *rescales* 16-bit samples (and converts floats)
// while PIL clamps/copies, so anything else must route to the PIL
// fallback (kErrFormat) rather than silently change pixel values.
bool tiff_is_8bit_uint(TIFF* tif) {
  uint16_t bps = 0, fmt = SAMPLEFORMAT_UINT;
  TIFFGetFieldDefaulted(tif, TIFFTAG_BITSPERSAMPLE, &bps);
  TIFFGetFieldDefaulted(tif, TIFFTAG_SAMPLEFORMAT, &fmt);
  return bps == 8 && (fmt == SAMPLEFORMAT_UINT || fmt == SAMPLEFORMAT_VOID);
}

int tiff_probe(const char* path, int* w, int* h) {
  TIFF* tif = TIFFOpen(path, "r");
  if (!tif) return kErrOpen;
  uint32_t tw = 0, th = 0;
  TIFFGetField(tif, TIFFTAG_IMAGEWIDTH, &tw);
  TIFFGetField(tif, TIFFTAG_IMAGELENGTH, &th);
  bool ok8 = tiff_is_8bit_uint(tif);
  TIFFClose(tif);
  if (!tw || !th) return kErrDecode;
  if (!ok8) return kErrFormat;
  *w = static_cast<int>(tw);
  *h = static_cast<int>(th);
  return 0;
}

int tiff_decode(const char* path, uint8_t* dst, int w, int h) {
  TIFF* tif = TIFFOpen(path, "r");
  if (!tif) return kErrOpen;
  if (!tiff_is_8bit_uint(tif)) {
    TIFFClose(tif);
    return kErrFormat;
  }
  uint32_t tw = 0, th = 0;
  TIFFGetField(tif, TIFFTAG_IMAGEWIDTH, &tw);
  TIFFGetField(tif, TIFFTAG_IMAGELENGTH, &th);
  if (static_cast<int>(tw) != w || static_cast<int>(th) != h) {
    TIFFClose(tif);
    return kErrDims;
  }
  std::vector<uint32_t> rgba(static_cast<size_t>(w) * h);
  // Top-left orientation: row 0 of the buffer is the top image row.
  // stop_on_error = 1: a strip that cannot be read (a truncated file) is
  // a decode failure, as in Pillow, not rows of zeros.
  int ok = TIFFReadRGBAImageOriented(tif, tw, th, rgba.data(),
                                     ORIENTATION_TOPLEFT, 1);
  TIFFClose(tif);
  if (!ok) return kErrDecode;
  const size_t n = static_cast<size_t>(w) * h;
  for (size_t i = 0; i < n; ++i) {
    uint32_t px = rgba[i];
    dst[3 * i + 0] = TIFFGetR(px);
    dst[3 * i + 1] = TIFFGetG(px);
    dst[3 * i + 2] = TIFFGetB(px);
  }
  return 0;
}

// ---------------------------------------------------------------- JPEG
struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jump;
};

void jpeg_error_trampoline(j_common_ptr cinfo) {
  JpegErr* e = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(e->jump, 1);
}

// Warnings print nothing. A premature end of the data (a truncated
// file, which libjpeg completes with gray rows) is a decode failure, as
// in Pillow; other warnings are not.
void jpeg_message_hook(j_common_ptr cinfo, int level) {
  if (level < 0 && cinfo->err->msg_code == JWRN_JPEG_EOF) jpeg_error_trampoline(cinfo);
}

int jpeg_probe_or_decode(const char* path, uint8_t* dst, int* w, int* h,
                         bool decode) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return kErrOpen;
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_error_trampoline;
  jerr.mgr.emit_message = jpeg_message_hook;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    std::fclose(f);
    return kErrDecode;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  if (!decode) {
    jpeg_calc_output_dimensions(&cinfo);
    *w = static_cast<int>(cinfo.output_width);
    *h = static_cast<int>(cinfo.output_height);
    jpeg_destroy_decompress(&cinfo);
    std::fclose(f);
    return 0;
  }
  jpeg_start_decompress(&cinfo);
  if (static_cast<int>(cinfo.output_width) != *w ||
      static_cast<int>(cinfo.output_height) != *h ||
      cinfo.output_components != 3) {
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    std::fclose(f);
    return kErrDims;
  }
  const size_t stride = static_cast<size_t>(*w) * 3;
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row = dst + stride * cinfo.output_scanline;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  std::fclose(f);
  return 0;
}

// ----------------------------------------------------------------- PNG
int png_probe(const char* path, int* w, int* h) {
  png_image img;
  std::memset(&img, 0, sizeof(img));
  img.version = PNG_IMAGE_VERSION;
  if (!png_image_begin_read_from_file(&img, path)) return kErrDecode;
  if (img.format & PNG_FORMAT_FLAG_LINEAR) {
    // 16-bit file: the simplified API would linearize/rescale instead
    // of clamping like PIL — route to the PIL fallback.
    png_image_free(&img);
    return kErrFormat;
  }
  *w = static_cast<int>(img.width);
  *h = static_cast<int>(img.height);
  png_image_free(&img);
  return 0;
}

int png_decode(const char* path, uint8_t* dst, int w, int h) {
  png_image img;
  std::memset(&img, 0, sizeof(img));
  img.version = PNG_IMAGE_VERSION;
  if (!png_image_begin_read_from_file(&img, path)) return kErrDecode;
  if (img.format & PNG_FORMAT_FLAG_LINEAR) {
    png_image_free(&img);
    return kErrFormat;
  }
  if (static_cast<int>(img.width) != w || static_cast<int>(img.height) != h) {
    png_image_free(&img);
    return kErrDims;
  }
  if (img.format & PNG_FORMAT_FLAG_ALPHA) {
    // Read RGBA and DROP alpha (PIL convert("RGB") parity) — asking the
    // simplified API for RGB would composite onto a background instead.
    img.format = PNG_FORMAT_RGBA;
    std::vector<uint8_t> rgba(static_cast<size_t>(w) * h * 4);
    if (!png_image_finish_read(&img, nullptr, rgba.data(), 0, nullptr)) {
      png_image_free(&img);
      return kErrDecode;
    }
    const size_t n = static_cast<size_t>(w) * h;
    for (size_t i = 0; i < n; ++i) {
      dst[3 * i + 0] = rgba[4 * i + 0];
      dst[3 * i + 1] = rgba[4 * i + 1];
      dst[3 * i + 2] = rgba[4 * i + 2];
    }
    return 0;
  }
  img.format = PNG_FORMAT_RGB;  // palette/gray/16-bit converted
  if (!png_image_finish_read(&img, nullptr, dst, 0, nullptr)) {
    png_image_free(&img);
    return kErrDecode;
  }
  return 0;
}

// ---------------------------------------------------------------------------
// PNG encoding (to memory). PIL's encoder spends most of its time on
// adaptive per-row filter selection (it tries all five filters); for
// figure/render output we pin filter NONE + a caller-chosen zlib level,
// which does less work for somewhat larger files (pixels identical —
// tests/test_native.py and tests/test_torch_imgio.py round-trip through
// PIL).
struct MemOut {
  uint8_t* buf;
  long cap;
  long len;
};

void mem_write(png_structp png, png_bytep data, png_size_t n) {
  MemOut* m = static_cast<MemOut*>(png_get_io_ptr(png));
  if (m->len + static_cast<long>(n) > m->cap) {
    png_error(png, "output capacity exceeded");
  }
  std::memcpy(m->buf + m->len, data, n);
  m->len += static_cast<long>(n);
}

void mem_flush(png_structp) {}

}  // namespace

extern "C" {

// Encode (h, w, 3) row-major RGB bytes as a PNG into ``out`` (capacity
// ``cap``); writes the byte count to ``out_len``. ``level``: zlib
// 0-9. ``fast`` != 0 selects filter SUB + zlib Z_RLE instead of filter
// NONE + the default strategy: a cheaper deflate on figure-like
// canvases for slightly larger files (decoded pixels are identical — PNG is
// lossless under any filter/strategy choice). Returns 0, or kErrDecode
// on any libpng error (including capacity overflow — size the buffer
// ~ w*h*3 + h + 64KiB).
int ii_encode_png_rgb(const uint8_t* rgb, int w, int h, int level,
                      int fast, uint8_t* out, long cap, long* out_len) {
  if (w <= 0 || h <= 0 || level < 0 || level > 9) return kErrFormat;
  png_structp png =
      png_create_write_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) return kErrDecode;
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_write_struct(&png, nullptr);
    return kErrDecode;
  }
  MemOut m{out, cap, 0};
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_write_struct(&png, &info);
    return kErrDecode;
  }
  png_set_write_fn(png, &m, mem_write, mem_flush);
  png_set_compression_level(png, level);
  if (fast) {
    png_set_filter(png, 0, PNG_FILTER_SUB);
    png_set_compression_strategy(png, Z_RLE);
  } else {
    png_set_filter(png, 0, PNG_FILTER_NONE);
  }
  png_set_IHDR(png, info, w, h, 8, PNG_COLOR_TYPE_RGB,
               PNG_INTERLACE_NONE, PNG_COMPRESSION_TYPE_DEFAULT,
               PNG_FILTER_TYPE_DEFAULT);
  png_write_info(png, info);
  const size_t stride = static_cast<size_t>(w) * 3;
  for (int y = 0; y < h; ++y) {
    png_write_row(png, const_cast<png_bytep>(rgb + stride * y));
  }
  png_write_end(png, info);
  png_destroy_write_struct(&png, &info);
  *out_len = m.len;
  return 0;
}

// Write (h, w, 3) row-major RGB bytes as an UNCOMPRESSED striped RGB
// TIFF at ``path`` (the same shape PIL's default .save(".tif")
// produces — compression "raw"; pixel parity round-tripped in
// tests/test_native.py). One strip per 64 rows keeps readers happy
// without per-row call overhead. Returns 0 or kErrDecode.
int ii_encode_tiff_rgb(const char* path, const uint8_t* rgb, int w,
                       int h) {
  if (w <= 0 || h <= 0) return kErrFormat;
  TIFF* tif = TIFFOpen(path, "w");
  if (!tif) return kErrDecode;
  TIFFSetField(tif, TIFFTAG_IMAGEWIDTH, static_cast<uint32_t>(w));
  TIFFSetField(tif, TIFFTAG_IMAGELENGTH, static_cast<uint32_t>(h));
  TIFFSetField(tif, TIFFTAG_SAMPLESPERPIXEL, 3);
  TIFFSetField(tif, TIFFTAG_BITSPERSAMPLE, 8);
  TIFFSetField(tif, TIFFTAG_ORIENTATION, ORIENTATION_TOPLEFT);
  TIFFSetField(tif, TIFFTAG_PLANARCONFIG, PLANARCONFIG_CONTIG);
  TIFFSetField(tif, TIFFTAG_PHOTOMETRIC, PHOTOMETRIC_RGB);
  TIFFSetField(tif, TIFFTAG_COMPRESSION, COMPRESSION_NONE);
  const uint32_t rows_per_strip = 64;
  TIFFSetField(tif, TIFFTAG_ROWSPERSTRIP, rows_per_strip);
  const size_t stride = static_cast<size_t>(w) * 3;
  uint32_t strip = 0;
  for (int y = 0; y < h; y += rows_per_strip, ++strip) {
    const uint32_t rows =
        (y + static_cast<int>(rows_per_strip) <= h)
            ? rows_per_strip
            : static_cast<uint32_t>(h - y);
    const tmsize_t nbytes = static_cast<tmsize_t>(stride) * rows;
    if (TIFFWriteEncodedStrip(
            tif, strip,
            const_cast<uint8_t*>(rgb + stride * static_cast<size_t>(y)),
            nbytes) != nbytes) {
      TIFFClose(tif);
      return kErrDecode;
    }
  }
  TIFFClose(tif);
  return 0;
}

int ii_probe(const char* path, int* w, int* h) {
  int err;
  switch (sniff(path, &err)) {
    case Format::kTiff:
      return tiff_probe(path, w, h);
    case Format::kJpeg:
      return jpeg_probe_or_decode(path, nullptr, w, h, false);
    case Format::kPng:
      return png_probe(path, w, h);
    default:
      return err;
  }
}

int ii_decode_rgb(const char* path, uint8_t* dst, int w, int h) {
  int err;
  switch (sniff(path, &err)) {
    case Format::kTiff:
      return tiff_decode(path, dst, w, h);
    case Format::kJpeg:
      return jpeg_probe_or_decode(path, dst, &w, &h, true);
    case Format::kPng:
      return png_decode(path, dst, w, h);
    default:
      return err;
  }
}

int ii_decode_batch_rgb(const char** paths, int n, uint8_t* dst, int w,
                        int h, int nthreads, int* status) {
  if (n <= 0) return 0;
  if (nthreads < 1) nthreads = 1;
  if (nthreads > n) nthreads = n;
  const size_t frame = static_cast<size_t>(w) * h * 3;
  std::atomic<int> next{0};
  std::atomic<int> ok_count{0};
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1, std::memory_order_relaxed);
      if (i >= n) return;
      int rc = ii_decode_rgb(paths[i], dst + frame * i, w, h);
      if (rc != 0) {
        // A mid-decode failure (e.g. truncated JPEG longjmp) may have
        // written partial scanlines; honor the "failed slots are
        // all-zero" contract so status-blind consumers see no garbage.
        std::memset(dst + frame * i, 0, frame);
      }
      status[i] = rc;
      if (rc == 0) ok_count.fetch_add(1, std::memory_order_relaxed);
    }
  };
  std::vector<std::thread> pool;
  pool.reserve(nthreads - 1);
  for (int t = 1; t < nthreads; ++t) pool.emplace_back(worker);
  worker();
  for (auto& th : pool) th.join();
  return ok_count.load();
}

}  // extern "C"
