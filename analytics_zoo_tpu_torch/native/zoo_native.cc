// Native host-side image pipeline: decode + resize + normalize.
//
// TPU-native equivalent of the reference's OpenCV JNI path
// (zoo/.../feature/image/OpenCVMethod.scala: imdecode; ImageBytesToMat /
// ImageResize / ImageChannelNormalize transformers): the accelerator wants
// ready float batches in HBM, so the CPU-side decode must keep up with the
// device.  This library decodes JPEG (libjpeg) / PNG (libpng) blobs,
// bilinear-resizes, and normalizes to a float32 NHWC batch with a
// std::thread worker pool, called from Python via ctypes (no pybind11 in
// this environment).
//
// Build: g++ -O3 -fPIC -shared zoo_native.cc -o libzoo_native.so
//        -ljpeg -lpng -lpthread        (driven by native/__init__.py)

#include <atomic>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

#include <csetjmp>
#include <jpeglib.h>
#include <png.h>

namespace {

// ---------------------------------------------------------------------------
// JPEG

struct JerrMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void jerr_exit(j_common_ptr cinfo) {
  JerrMgr* err = reinterpret_cast<JerrMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

void jerr_emit(j_common_ptr, int) {}  // silence warnings

// Decode a JPEG blob to tightly-packed RGB8.  Returns malloc'd buffer or
// nullptr.
uint8_t* decode_jpeg(const uint8_t* data, size_t len, int* w, int* h) {
  jpeg_decompress_struct cinfo;
  JerrMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jerr_exit;
  jerr.pub.emit_message = jerr_emit;
  // volatile: modified between setjmp and longjmp — without it the
  // longjmp cleanup path may free a stale register value (C11 7.13.2.1)
  uint8_t* volatile out = nullptr;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    free(out);
    return nullptr;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(data),
               static_cast<unsigned long>(len));
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;  // grayscale/YCbCr -> RGB in-decoder
  jpeg_start_decompress(&cinfo);
  const int width = cinfo.output_width;
  const int height = cinfo.output_height;
  const int stride = width * 3;
  out = static_cast<uint8_t*>(malloc(static_cast<size_t>(stride) * height));
  if (!out) longjmp(jerr.setjmp_buffer, 1);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out + static_cast<size_t>(stride) * cinfo.output_scanline;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  *w = width;
  *h = height;
  return out;
}

// ---------------------------------------------------------------------------
// PNG (simplified libpng16 API)

uint8_t* decode_png(const uint8_t* data, size_t len, int* w, int* h) {
  png_image image;
  memset(&image, 0, sizeof image);
  image.version = PNG_IMAGE_VERSION;
  if (!png_image_begin_read_from_memory(&image, data, len)) return nullptr;
  image.format = PNG_FORMAT_RGB;
  uint8_t* out = static_cast<uint8_t*>(malloc(PNG_IMAGE_SIZE(image)));
  if (!out) {
    png_image_free(&image);
    return nullptr;
  }
  if (!png_image_finish_read(&image, nullptr, out, 0, nullptr)) {
    free(out);
    png_image_free(&image);
    return nullptr;
  }
  *w = static_cast<int>(image.width);
  *h = static_cast<int>(image.height);
  return out;
}

uint8_t* decode_any(const uint8_t* data, size_t len, int* w, int* h) {
  if (len >= 2 && data[0] == 0xFF && data[1] == 0xD8)
    return decode_jpeg(data, len, w, h);
  if (len >= 4 && data[0] == 0x89 && data[1] == 'P' && data[2] == 'N' &&
      data[3] == 'G')
    return decode_png(data, len, w, h);
  return nullptr;
}

// ---------------------------------------------------------------------------
// bilinear resize, RGB8 -> RGB8 (align_corners=false / half-pixel centers,
// matching PIL/OpenCV default)

void resize_bilinear(const uint8_t* src, int sw, int sh, uint8_t* dst,
                     int dw, int dh) {
  const float sx = static_cast<float>(sw) / dw;
  const float sy = static_cast<float>(sh) / dh;
  for (int y = 0; y < dh; ++y) {
    float fy = (y + 0.5f) * sy - 0.5f;
    if (fy < 0) fy = 0;
    int y0 = static_cast<int>(fy);
    int y1 = y0 + 1 < sh ? y0 + 1 : sh - 1;
    const float wy = fy - y0;
    for (int x = 0; x < dw; ++x) {
      float fx = (x + 0.5f) * sx - 0.5f;
      if (fx < 0) fx = 0;
      int x0 = static_cast<int>(fx);
      int x1 = x0 + 1 < sw ? x0 + 1 : sw - 1;
      const float wx = fx - x0;
      const uint8_t* p00 = src + (static_cast<size_t>(y0) * sw + x0) * 3;
      const uint8_t* p01 = src + (static_cast<size_t>(y0) * sw + x1) * 3;
      const uint8_t* p10 = src + (static_cast<size_t>(y1) * sw + x0) * 3;
      const uint8_t* p11 = src + (static_cast<size_t>(y1) * sw + x1) * 3;
      uint8_t* q = dst + (static_cast<size_t>(y) * dw + x) * 3;
      for (int c = 0; c < 3; ++c) {
        const float top = p00[c] + (p01[c] - p00[c]) * wx;
        const float bot = p10[c] + (p11[c] - p10[c]) * wx;
        q[c] = static_cast<uint8_t>(top + (bot - top) * wy + 0.5f);
      }
    }
  }
}

}  // namespace

extern "C" {

// Decode one blob to RGB8.  *out is malloc'd (free with zoo_free).
// Returns 0 on success, -1 on decode failure.
int zoo_decode_rgb(const uint8_t* data, size_t len, uint8_t** out, int* w,
                   int* h) {
  *out = decode_any(data, len, w, h);
  return *out ? 0 : -1;
}

void zoo_free(void* p) { free(p); }

void zoo_resize_bilinear(const uint8_t* src, int sw, int sh, uint8_t* dst,
                         int dw, int dh) {
  resize_bilinear(src, sw, sh, dst, dw, dh);
}

// Decode n blobs, resize each to (out_h, out_w), normalize
// (pixel * scale - mean[c]) / stdv[c], write float32 NHWC into out.
// Worker pool of num_threads (<=0: hardware_concurrency).  Returns 0 when
// all images decoded; otherwise the count of failures (their slots are
// zero-filled).
int zoo_decode_batch(const uint8_t* const* blobs, const size_t* lens, int n,
                     int out_h, int out_w, const float* mean,
                     const float* stdv, float scale, int num_threads,
                     float* out) {
  const size_t img_elems = static_cast<size_t>(out_h) * out_w * 3;
  std::atomic<int> next(0);
  std::atomic<int> failures(0);
  float m[3] = {0, 0, 0}, inv_s[3] = {1, 1, 1};
  for (int c = 0; c < 3; ++c) {
    if (mean) m[c] = mean[c];
    if (stdv) inv_s[c] = stdv[c] != 0 ? 1.0f / stdv[c] : 1.0f;
  }

  auto worker = [&]() {
    std::vector<uint8_t> resized(img_elems);
    for (;;) {
      const int i = next.fetch_add(1);
      if (i >= n) return;
      float* dst = out + img_elems * i;
      int w = 0, h = 0;
      uint8_t* rgb = decode_any(blobs[i], lens[i], &w, &h);
      if (!rgb) {
        memset(dst, 0, img_elems * sizeof(float));
        failures.fetch_add(1);
        continue;
      }
      const uint8_t* pixels = rgb;
      if (w != out_w || h != out_h) {
        resize_bilinear(rgb, w, h, resized.data(), out_w, out_h);
        pixels = resized.data();
      }
      for (size_t j = 0; j < img_elems; j += 3) {
        dst[j] = (pixels[j] * scale - m[0]) * inv_s[0];
        dst[j + 1] = (pixels[j + 1] * scale - m[1]) * inv_s[1];
        dst[j + 2] = (pixels[j + 2] * scale - m[2]) * inv_s[2];
      }
      free(rgb);
    }
  };

  int threads = num_threads > 0
                    ? num_threads
                    : static_cast<int>(std::thread::hardware_concurrency());
  if (threads < 1) threads = 1;
  if (threads > n) threads = n;
  if (threads == 1) {
    worker();
  } else {
    std::vector<std::thread> pool;
    pool.reserve(threads);
    for (int t = 0; t < threads; ++t) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
  }
  return failures.load();
}

int zoo_native_abi_version() { return 1; }

}  // extern "C"
