// edt_native: native (C++) host data pipeline for efficientdet_tpu_torch.
//
// The PyTorch reference delegates its host pixel work to native code it does
// not own: cv2 (C++) for JPEG decode + resize (datasets/voc0712.py:107-109,
// datasets/augmentation.py:94-115) and torch's C++ DataLoader core for
// worker parallelism (train.py:199-210). This library is the package's own
// native equivalent: a threaded batch pipeline that fuses
//
//   JPEG decode -> longest-side bilinear resize -> optional horizontal flip
//   -> ImageNet normalize -> zero-pad to a square canvas
//
// into one pass per image, writing float32 NHWC directly into the caller's
// batch buffer (no intermediate full-size float image is ever materialized).
// The arithmetic exactly matches the Python path in data/transforms.py
// (Normalizer -> Augmenter -> Resizer): bilinear interpolation uses
// half-pixel centers (cv2 INTER_LINEAR float semantics), and because
// interpolation weights sum to 1 the normalize-then-resize order of the
// Python path commutes with the resize-then-normalize order used here.
//
// Exposed as a plain C ABI consumed via ctypes (native/__init__.py).

#include <cstddef>
#include <cstdio>

#include <jpeglib.h>
#include <setjmp.h>

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jmp;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* err = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(err->jmp, 1);
}

// Parse the EXIF orientation tag (0x0112) out of a JPEG byte stream.
// Returns the orientation value (1..8), or 1 if absent/unparseable.
// cv2.imread applies EXIF rotation by default, so the native path must NOT
// decode an EXIF-rotated image as-is — images and boxes would silently
// disagree with the Python path. Callers reject orientation != 1 (the
// per-image Python fallback then handles the rotation).
int exif_orientation(const uint8_t* d, size_t n) {
  auto u16 = [&](size_t off, bool be) -> unsigned {
    return be ? (d[off] << 8) | d[off + 1] : (d[off + 1] << 8) | d[off];
  };
  auto u32 = [&](size_t off, bool be) -> unsigned long {
    return be ? ((unsigned long)d[off] << 24) | (d[off + 1] << 16) |
                    (d[off + 2] << 8) | d[off + 3]
              : ((unsigned long)d[off + 3] << 24) | (d[off + 2] << 16) |
                    (d[off + 1] << 8) | d[off];
  };
  size_t p = 2;  // past SOI
  while (p + 4 <= n) {
    if (d[p] != 0xFF) return 1;
    const uint8_t marker = d[p + 1];
    if (marker == 0xD8 || (marker >= 0xD0 && marker <= 0xD7)) { p += 2; continue; }
    if (marker == 0xDA || marker == 0xD9) return 1;  // SOS/EOI: no EXIF ahead
    const size_t len = u16(p + 2, true);
    if (len < 2 || p + 2 + len > n) return 1;
    if (marker == 0xE1 && len >= 2 + 6 + 8 &&
        std::memcmp(d + p + 4, "Exif\0\0", 6) == 0) {
      const size_t t = p + 10;  // TIFF header
      if (t + 8 > n) return 1;
      bool be;
      if (d[t] == 'M' && d[t + 1] == 'M') be = true;
      else if (d[t] == 'I' && d[t + 1] == 'I') be = false;
      else return 1;
      if (u16(t + 2, be) != 42) return 1;
      const size_t ifd = t + u32(t + 4, be);
      if (ifd + 2 > n) return 1;
      const unsigned count = u16(ifd, be);
      for (unsigned i = 0; i < count; ++i) {
        const size_t e = ifd + 2 + static_cast<size_t>(i) * 12;
        if (e + 12 > n) return 1;
        if (u16(e, be) == 0x0112) {
          const unsigned v = u16(e + 8, be);  // SHORT value, first 2 bytes
          return (v >= 1 && v <= 8) ? static_cast<int>(v) : 1;
        }
      }
      return 1;
    }
    p += 2 + len;
  }
  return 1;
}

// Decode a JPEG file into an RGB uint8 buffer. Returns true on success and
// sets (w, h); `pixels` is resized to h*w*3.
bool decode_jpeg_file(const char* path, std::vector<uint8_t>& pixels,
                      int* out_w, int* out_h) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  // Slurp the file: jpeg_mem_src avoids stdio locking in the decode loop.
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  if (size <= 4) { std::fclose(f); return false; }
  std::vector<uint8_t> data(static_cast<size_t>(size));
  size_t got = std::fread(data.data(), 1, data.size(), f);
  std::fclose(f);
  if (got != data.size()) return false;
  if (!(data[0] == 0xFF && data[1] == 0xD8)) return false;  // not a JPEG
  // EXIF-rotated images go through the Python fallback (see exif_orientation).
  if (exif_orientation(data.data(), data.size()) != 1) return false;

  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jmp)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, data.data(), static_cast<unsigned long>(data.size()));
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  const int w = static_cast<int>(cinfo.output_width);
  const int h = static_cast<int>(cinfo.output_height);
  if (w <= 0 || h <= 0 || cinfo.output_components != 3) {
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  pixels.resize(static_cast<size_t>(w) * h * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row = pixels.data() + static_cast<size_t>(cinfo.output_scanline) * w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  *out_w = w;
  *out_h = h;
  return true;
}

// One image: decode `path`, resize longest side to `target` (bilinear,
// half-pixel centers), optional horizontal flip, normalize
// (p/255 - mean)/std, write into out[target*target*3] (row-major HWC). The
// canvas is zeroed first (zero padding AFTER normalization — reference
// Resizer semantics, datasets/augmentation.py:104-110).
bool process_one(const char* path, int target, bool flip, const float* norm_a,
                 const float* norm_b, float* out, float* scale,
                 std::vector<uint8_t>& scratch) {
  int w = 0, h = 0;
  if (!decode_jpeg_file(path, scratch, &w, &h)) return false;

  const float s = static_cast<float>(target) / static_cast<float>(std::max(h, w));
  // Match Python exactly: int() truncation of w*scale / h*scale.
  int nh, nw;
  if (h > w) {
    nh = target;
    nw = static_cast<int>(static_cast<float>(w) * s);
  } else {
    nh = static_cast<int>(static_cast<float>(h) * s);
    nw = target;
  }
  nh = std::max(nh, 1);
  nw = std::max(nw, 1);

  std::memset(out, 0, static_cast<size_t>(target) * target * 3 * sizeof(float));

  const float sx_ratio = static_cast<float>(w) / static_cast<float>(nw);
  const float sy_ratio = static_cast<float>(h) / static_cast<float>(nh);
  const uint8_t* src = scratch.data();

  // Precompute the x-axis sample positions/weights once per image.
  std::vector<int> x0s(nw), x1s(nw);
  std::vector<float> fxs(nw);
  for (int x = 0; x < nw; ++x) {
    float sx = (static_cast<float>(x) + 0.5f) * sx_ratio - 0.5f;
    if (flip) sx = static_cast<float>(w - 1) - sx;  // mirror-then-resize
    sx = std::min(std::max(sx, 0.0f), static_cast<float>(w - 1));
    int x0 = static_cast<int>(sx);
    x0s[x] = x0;
    x1s[x] = std::min(x0 + 1, w - 1);
    fxs[x] = sx - static_cast<float>(x0);
  }

  for (int y = 0; y < nh; ++y) {
    float sy = (static_cast<float>(y) + 0.5f) * sy_ratio - 0.5f;
    sy = std::min(std::max(sy, 0.0f), static_cast<float>(h - 1));
    const int y0 = static_cast<int>(sy);
    const int y1 = std::min(y0 + 1, h - 1);
    const float fy = sy - static_cast<float>(y0);
    const uint8_t* row0 = src + static_cast<size_t>(y0) * w * 3;
    const uint8_t* row1 = src + static_cast<size_t>(y1) * w * 3;
    float* dst = out + static_cast<size_t>(y) * target * 3;
    for (int x = 0; x < nw; ++x) {
      const int x0 = x0s[x] * 3, x1 = x1s[x] * 3;
      const float fx = fxs[x];
      const float w00 = (1.0f - fy) * (1.0f - fx);
      const float w01 = (1.0f - fy) * fx;
      const float w10 = fy * (1.0f - fx);
      const float w11 = fy * fx;
      float* px = dst + static_cast<size_t>(x) * 3;
      for (int c = 0; c < 3; ++c) {
        const float v = w00 * row0[x0 + c] + w01 * row0[x1 + c] +
                        w10 * row1[x0 + c] + w11 * row1[x1 + c];
        px[c] = v * norm_a[c] + norm_b[c];
      }
    }
  }
  *scale = s;
  return true;
}

}  // namespace

extern "C" {

// Batch pipeline. paths: n C strings; flips: n bytes (0/1); mean/std: 3
// floats each (applied to the [0,1]-scaled image); out: n*target*target*3
// float32 NHWC; scales: n floats; ok: n bytes (1 = success, 0 = caller must
// fall back to the Python path for that image). Returns the number of
// successfully processed images.
int edt_decode_resize_batch(const char** paths, int n, int target,
                            const uint8_t* flips, const float* mean,
                            const float* stddev, float* out, float* scales,
                            uint8_t* ok, int num_threads) {
  if (n <= 0 || target <= 0) return 0;
  float norm_a[3], norm_b[3];
  for (int c = 0; c < 3; ++c) {
    // (p/255 - mean)/std  ==  p * a + b
    norm_a[c] = 1.0f / (255.0f * stddev[c]);
    norm_b[c] = -mean[c] / stddev[c];
  }
  const size_t img_stride = static_cast<size_t>(target) * target * 3;
  std::atomic<int> next{0};
  std::atomic<int> done{0};
  int threads = std::max(1, std::min(num_threads, n));

  auto work = [&]() {
    std::vector<uint8_t> scratch;
    for (;;) {
      const int i = next.fetch_add(1);
      if (i >= n) return;
      const bool good =
          process_one(paths[i], target, flips && flips[i] != 0, norm_a, norm_b,
                      out + img_stride * static_cast<size_t>(i), &scales[i],
                      scratch);
      ok[i] = good ? 1 : 0;
      if (good) done.fetch_add(1);
      if (!good) {
        std::memset(out + img_stride * static_cast<size_t>(i), 0,
                    img_stride * sizeof(float));
        scales[i] = 1.0f;
      }
    }
  };

  if (threads == 1) {
    work();
  } else {
    std::vector<std::thread> pool;
    pool.reserve(threads);
    for (int t = 0; t < threads; ++t) pool.emplace_back(work);
    for (auto& t : pool) t.join();
  }
  return done.load();
}

// Image header probe: sets (w, h) without a full decode. Returns 1 on
// success. Used to compute box scaling on the Python side without decoding.
int edt_image_dims(const char* path, int* out_w, int* out_h) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return 0;
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  if (size <= 4) { std::fclose(f); return 0; }
  std::vector<uint8_t> data(static_cast<size_t>(size));
  size_t got = std::fread(data.data(), 1, data.size(), f);
  std::fclose(f);
  if (got != data.size() || !(data[0] == 0xFF && data[1] == 0xD8)) return 0;

  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jmp)) {
    jpeg_destroy_decompress(&cinfo);
    return 0;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, data.data(), static_cast<unsigned long>(data.size()));
  jpeg_read_header(&cinfo, TRUE);
  *out_w = static_cast<int>(cinfo.image_width);
  *out_h = static_cast<int>(cinfo.image_height);
  jpeg_destroy_decompress(&cinfo);
  return 1;
}

// Raw decode to uint8 RGB for parity tests. Two-call pattern: first call
// edt_image_dims for (w, h), then this with out sized h*w*3. Returns 1 on
// success.
int edt_decode_rgb(const char* path, uint8_t* out, int out_size) {
  std::vector<uint8_t> pixels;
  int w = 0, h = 0;
  if (!decode_jpeg_file(path, pixels, &w, &h)) return 0;
  if (static_cast<size_t>(out_size) < pixels.size()) return 0;
  std::memcpy(out, pixels.data(), pixels.size());
  return 1;
}

}  // extern "C"
