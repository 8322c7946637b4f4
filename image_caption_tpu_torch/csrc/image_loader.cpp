// Native host-side image loader: JPEG decode + PIL-exact bilinear resize
// + YOLO letterbox, multi-threaded, fixed-size outputs only across the
// C ABI.  The port's copy of the JAX package's csrc/image_loader.cpp, the
// same code under this header; ops/_build.py builds it with g++ (-pthread,
// -ljpeg) and vision/loader.py binds it with ctypes.
//
// Role: the reference's host image layer (cv2 decode/resize in
// `data/detect_for_preprocess.py:55,66`, PIL in `core/preprocess.py:48-51`)
// for the offline ETL and serving: decode + resize + letterbox run here,
// off the GIL (ctypes releases it for the whole batch call), and the card
// consumes the [B, S, S, 3] uint8 canvases.
//
// Exactness contract: the resize reproduces Pillow's 8-bit bilinear
// resample (Resample.c: triangle filter with support scaled on
// downscale, fixed-point accumulation at PRECISION_BITS, per-pass uint8
// rounding, horizontal-then-vertical) BIT-FOR-BIT (checked against PIL by
// tests/test_torch_native_loader.py), so native and PIL loaders are
// interchangeable mid-dataset.  JPEG decode uses the system libjpeg.
// Anything that is not a decodable JPEG reports ok=0 and the Python
// wrapper loads that image with PIL.

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

#include <csetjmp>
#include <jpeglib.h>

namespace {

// ---------------------------------------------------------------------
// Pillow-exact bilinear resample (8 bits per channel, RGB)
// ---------------------------------------------------------------------

constexpr int kPrecisionBits = 32 - 8 - 2;   // Pillow's PRECISION_BITS

inline double bilinear_filter(double x) {
  if (x < 0.0) x = -x;
  return x < 1.0 ? 1.0 - x : 0.0;
}

inline uint8_t clip8(int v) {
  v >>= kPrecisionBits;
  if (v < 0) return 0;
  if (v > 255) return 255;
  return static_cast<uint8_t>(v);
}

// Pillow precompute_coeffs (support=1.0 bilinear, box = whole axis),
// followed by the 8bpc fixed-point conversion.
void precompute_coeffs(int in_size, int out_size, std::vector<int>* bounds,
                       std::vector<int>* kk, int* ksize_out) {
  double scale = static_cast<double>(in_size) / out_size;
  double filterscale = scale < 1.0 ? 1.0 : scale;
  double support = 1.0 * filterscale;
  int ksize = static_cast<int>(std::ceil(support)) * 2 + 1;
  bounds->assign(out_size * 2, 0);
  std::vector<double> prekk(static_cast<size_t>(out_size) * ksize, 0.0);
  for (int xx = 0; xx < out_size; xx++) {
    double center = (xx + 0.5) * scale;
    double ww = 0.0;
    double ss = 1.0 / filterscale;
    // Pillow rounds the window edges with +0.5 truncation, not floor
    int xmin = static_cast<int>(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = static_cast<int>(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    xmax -= xmin;
    double* k = &prekk[static_cast<size_t>(xx) * ksize];
    for (int x = 0; x < xmax; x++) {
      double w = bilinear_filter((x + xmin - center + 0.5) * ss);
      k[x] = w;
      ww += w;
    }
    for (int x = 0; x < xmax; x++) {
      if (ww != 0.0) k[x] /= ww;
    }
    (*bounds)[xx * 2 + 0] = xmin;
    (*bounds)[xx * 2 + 1] = xmax;
  }
  kk->assign(prekk.size(), 0);
  for (size_t i = 0; i < prekk.size(); i++) {
    (*kk)[i] = prekk[i] < 0
                   ? static_cast<int>(-0.5 + prekk[i] * (1 << kPrecisionBits))
                   : static_cast<int>(0.5 + prekk[i] * (1 << kPrecisionBits));
  }
  *ksize_out = ksize;
}

// One separable pass along the last-but-one axis == rows (vertical) or
// columns (horizontal) of packed RGB data.
void resample_horizontal(const uint8_t* in, int h, int w, uint8_t* out,
                         int nw, const std::vector<int>& bounds,
                         const std::vector<int>& kk, int ksize) {
  for (int y = 0; y < h; y++) {
    const uint8_t* row = in + static_cast<size_t>(y) * w * 3;
    uint8_t* orow = out + static_cast<size_t>(y) * nw * 3;
    for (int xx = 0; xx < nw; xx++) {
      int xmin = bounds[xx * 2], xmax = bounds[xx * 2 + 1];
      const int* k = &kk[static_cast<size_t>(xx) * ksize];
      int s0 = 1 << (kPrecisionBits - 1);
      int s1 = s0, s2 = s0;
      for (int x = 0; x < xmax; x++) {
        const uint8_t* p = row + static_cast<size_t>(x + xmin) * 3;
        s0 += p[0] * k[x];
        s1 += p[1] * k[x];
        s2 += p[2] * k[x];
      }
      orow[xx * 3 + 0] = clip8(s0);
      orow[xx * 3 + 1] = clip8(s1);
      orow[xx * 3 + 2] = clip8(s2);
    }
  }
}

void resample_vertical(const uint8_t* in, int h, int w, uint8_t* out,
                       int nh, const std::vector<int>& bounds,
                       const std::vector<int>& kk, int ksize) {
  for (int yy = 0; yy < nh; yy++) {
    int ymin = bounds[yy * 2], ymax = bounds[yy * 2 + 1];
    const int* k = &kk[static_cast<size_t>(yy) * ksize];
    uint8_t* orow = out + static_cast<size_t>(yy) * w * 3;
    for (int x = 0; x < w * 3; x++) {
      int s = 1 << (kPrecisionBits - 1);
      for (int y = 0; y < ymax; y++) {
        s += in[static_cast<size_t>(y + ymin) * w * 3 + x] * k[y];
      }
      orow[x] = clip8(s);
    }
  }
}

// Full Pillow-order resize: horizontal pass first, then vertical, each
// skipped when its size is unchanged (Pillow skips them too — and the
// result is identical either way for the identity coefficients).
void resize_bilinear(const uint8_t* in, int h, int w, uint8_t* out, int nh,
                     int nw) {
  std::vector<int> bounds, kk;
  int ksize;
  const uint8_t* cur = in;
  std::vector<uint8_t> tmp;
  int cur_h = h, cur_w = w;
  if (nw != w) {
    precompute_coeffs(w, nw, &bounds, &kk, &ksize);
    tmp.resize(static_cast<size_t>(h) * nw * 3);
    resample_horizontal(cur, h, w, tmp.data(), nw, bounds, kk, ksize);
    cur = tmp.data();
    cur_w = nw;
  }
  if (nh != h) {
    precompute_coeffs(h, nh, &bounds, &kk, &ksize);
    std::vector<uint8_t> tmp2(static_cast<size_t>(nh) * cur_w * 3);
    resample_vertical(cur, cur_h, cur_w, tmp2.data(), nh, bounds, kk,
                      ksize);
    std::memcpy(out, tmp2.data(), tmp2.size());
    return;
  }
  std::memcpy(out, cur, static_cast<size_t>(cur_h) * cur_w * 3);
}

// ---------------------------------------------------------------------
// JPEG decode (system libjpeg, ISLOW baseline — PIL-equivalent)
// ---------------------------------------------------------------------

struct JpegError {
  jpeg_error_mgr mgr;
  jmp_buf jump;
};

void jpeg_error_exit(j_common_ptr cinfo) {
  JpegError* err = reinterpret_cast<JpegError*>(cinfo->err);
  longjmp(err->jump, 1);
}

// Decode path into an RGB buffer; returns true on success and fills
// (h, w).  Non-JPEG / truncated / CMYK etc. -> false (PIL fallback).
bool decode_jpeg(const char* path, std::vector<uint8_t>* rgb, int* h,
                 int* w) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  jpeg_decompress_struct cinfo;
  JpegError jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_error_exit;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    std::fclose(f);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    std::fclose(f);
    return false;
  }
  cinfo.out_color_space = JCS_RGB;   // YCbCr + grayscale both convert
  jpeg_start_decompress(&cinfo);
  if (cinfo.output_components != 3) {
    jpeg_destroy_decompress(&cinfo);
    std::fclose(f);
    return false;
  }
  *h = static_cast<int>(cinfo.output_height);
  *w = static_cast<int>(cinfo.output_width);
  rgb->resize(static_cast<size_t>(*h) * *w * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row =
        rgb->data() + static_cast<size_t>(cinfo.output_scanline) * *w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  std::fclose(f);
  return true;
}

// ---------------------------------------------------------------------
// Letterbox geometry — EXACT transcription of vision/ops.py
// letterbox_params / letterbox_params_rect, including Python round()'s
// half-to-even (nearbyint under the default FE_TONEAREST mode)
// ---------------------------------------------------------------------

inline int py_round(double x) {
  return static_cast<int>(std::nearbyint(x));
}

struct Letterbox {
  double r;
  int nh, nw, top, left, rect_h, rect_w;
};

Letterbox letterbox_params(int h, int w, int size, bool rect, int stride) {
  Letterbox lb;
  lb.r = std::min(static_cast<double>(size) / h,
                  static_cast<double>(size) / w);
  lb.nh = py_round(h * lb.r);
  lb.nw = py_round(w * lb.r);
  if (!rect) {
    lb.top = (size - lb.nh) / 2;
    lb.left = (size - lb.nw) / 2;
    lb.rect_h = lb.rect_w = 0;
    return lb;
  }
  int dh = (size - lb.nh) % stride;
  int dw = (size - lb.nw) % stride;
  lb.top = py_round(dh / 2.0 - 0.1);
  int bottom = py_round(dh / 2.0 + 0.1);
  lb.left = py_round(dw / 2.0 - 0.1);
  int right = py_round(dw / 2.0 + 0.1);
  lb.rect_h = lb.nh + lb.top + bottom;
  lb.rect_w = lb.nw + lb.left + right;
  return lb;
}

void load_one(const char* path, int canvas_size, bool rect, int stride,
              uint8_t* canvas, float* meta, float* size_out, uint8_t* ok) {
  std::vector<uint8_t> rgb;
  int h = 0, w = 0;
  if (!decode_jpeg(path, &rgb, &h, &w) || h <= 0 || w <= 0) {
    *ok = 0;
    return;
  }
  Letterbox lb = letterbox_params(h, w, canvas_size, rect, stride);
  std::vector<uint8_t> resized(static_cast<size_t>(lb.nh) * lb.nw * 3);
  resize_bilinear(rgb.data(), h, w, resized.data(), lb.nh, lb.nw);
  std::memset(canvas, 114,
              static_cast<size_t>(canvas_size) * canvas_size * 3);
  for (int y = 0; y < lb.nh; y++) {
    std::memcpy(canvas + (static_cast<size_t>(lb.top + y) * canvas_size +
                          lb.left) * 3,
                resized.data() + static_cast<size_t>(y) * lb.nw * 3,
                static_cast<size_t>(lb.nw) * 3);
  }
  meta[0] = static_cast<float>(lb.r);
  meta[1] = static_cast<float>(lb.top);
  meta[2] = static_cast<float>(lb.left);
  meta[3] = static_cast<float>(lb.rect_h);
  meta[4] = static_cast<float>(lb.rect_w);
  size_out[0] = static_cast<float>(h);
  size_out[1] = static_cast<float>(w);
  *ok = 1;
}

}  // namespace

extern "C" {

// Exactness-test entry: Pillow-bit-exact bilinear RGB resize.
void icx_resize_bilinear(const uint8_t* in, int h, int w, uint8_t* out,
                         int nh, int nw) {
  resize_bilinear(in, h, w, out, nh, nw);
}

// Batch decode + letterbox.  canvases [n, S, S, 3] u8, metas [n, 5] f32
// (scale, top, left, rect_h, rect_w — callers slice [:3] for square
// mode), sizes [n, 2] f32 (h, w), ok [n] u8 (0 = fall back to PIL for
// that image; its output slots are untouched).
void icx_load_letterboxed_batch(const char* const* paths, int n,
                                int canvas_size, int rect, int stride,
                                int nthreads, uint8_t* canvases,
                                float* metas, float* sizes, uint8_t* ok) {
  if (n <= 0) return;  // n==0 would clamp nthreads to 0 below and the
                       // reserve(nthreads - 1) size_t underflow throws a
                       // C++ exception across the extern "C" boundary
  if (nthreads < 1) nthreads = 1;
  if (nthreads > n) nthreads = n;
  std::atomic<int> next(0);
  auto worker = [&]() {
    for (int i = next.fetch_add(1); i < n; i = next.fetch_add(1)) {
      load_one(paths[i], canvas_size, rect != 0, stride,
               canvases + static_cast<size_t>(i) * canvas_size *
                              canvas_size * 3,
               metas + static_cast<size_t>(i) * 5,
               sizes + static_cast<size_t>(i) * 2, ok + i);
    }
  };
  std::vector<std::thread> threads;
  threads.reserve(nthreads - 1);
  for (int t = 1; t < nthreads; t++) threads.emplace_back(worker);
  worker();
  for (auto& th : threads) th.join();
}

}  // extern "C"
