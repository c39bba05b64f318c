// Multithreaded JPEG batch decoder + host bilinear resize.
//
// The data-loading front-end of the serving pipeline (PIPELINE: host JPEG
// bytes -> this decoder -> fixed-size uint8 RGB batch -> device-side
// resize/crop/normalize fused into the model program, vitax/pipeline.py).
// The reference has no data path at all (SURVEY.md §5); this is the
// framework's native equivalent of a production loader: libjpeg decode and
// resize run on host CPU threads with the GIL released (ctypes), so decode
// overlaps device compute.
//
// Build: make -C native    (g++ -O3 -shared -fPIC ... -ljpeg -lpthread)
// ABI: see vt_decode_jpeg_batch below; bound via ctypes in vitax/data.py.

#include <cstddef>
#include <cstdio>

#include <jpeglib.h>

#include <algorithm>
#include <atomic>
#include <csetjmp>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct ErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void error_exit(j_common_ptr cinfo) {
  ErrorMgr* err = reinterpret_cast<ErrorMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

// Decode flags (must mirror vitax/data.py).
constexpr int kDctScale = 1;  // IDCT-domain downscale to the smallest
                              // power-of-two size still >= out_size
constexpr int kFastIdct = 2;  // JDCT_IFAST + plain (non-fancy) upsampling;
                              // measured NO gain on libjpeg-turbo (its
                              // ISLOW is already SIMD: 187 vs 196 img/s) —
                              // kept for plain-libjpeg hosts, not set by
                              // vitax's fast mode

// Decode one JPEG to an RGB buffer (h*w*3). Returns false on corrupt input.
bool decode_one(const uint8_t* buf, size_t len, int out_size, int flags,
                std::vector<uint8_t>* rgb, int* h, int* w) {
  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, buf, len);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  if (flags & kDctScale) {
    // Decode at the smallest power-of-two scale (1/8, 1/4, 1/2) whose
    // output still covers out_size on both axes: the IDCT does the
    // low-pass for free, and the bilinear below finishes from a 1x-2x
    // source instead of full size. Power-of-two only — libjpeg-turbo's
    // SIMD covers those scaled IDCTs, while odd M/8 sizes fall back to
    // scalar code and measure SLOWER than a full-scale SIMD decode
    // (480x320->256, M=7: 164 vs 196 img/s; M=4 at target 160: 336 vs
    // 276). Images under 2x the target keep full scale — scaling never
    // drops below out_size.
    cinfo.scale_denom = 8;
    for (int m : {1, 2, 4, 8}) {
      cinfo.scale_num = m;
      jpeg_calc_output_dimensions(&cinfo);
      if (static_cast<int>(cinfo.output_width) >= out_size &&
          static_cast<int>(cinfo.output_height) >= out_size) {
        break;
      }
      cinfo.scale_num = 8;  // fall back to full scale if never covered
    }
  }
  if (flags & kFastIdct) {
    cinfo.dct_method = JDCT_IFAST;
    cinfo.do_fancy_upsampling = FALSE;
  }
  jpeg_start_decompress(&cinfo);
  *h = cinfo.output_height;
  *w = cinfo.output_width;
  rgb->resize(static_cast<size_t>(*h) * *w * 3);
  const size_t stride = static_cast<size_t>(*w) * 3;
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = rgb->data() + cinfo.output_scanline * stride;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

// Bilinear resize (half-pixel centers, matching jax.image.resize /
// torchvision antialias=False) from (h, w, 3) to (out, out, 3).
void resize_bilinear(const uint8_t* src, int h, int w, uint8_t* dst, int out) {
  const float sy = static_cast<float>(h) / out;
  const float sx = static_cast<float>(w) / out;
  for (int oy = 0; oy < out; ++oy) {
    float fy = (oy + 0.5f) * sy - 0.5f;
    fy = std::max(0.0f, std::min(fy, static_cast<float>(h - 1)));
    const int y0 = static_cast<int>(fy);
    const int y1 = std::min(y0 + 1, h - 1);
    const float wy = fy - y0;
    for (int ox = 0; ox < out; ++ox) {
      float fx = (ox + 0.5f) * sx - 0.5f;
      fx = std::max(0.0f, std::min(fx, static_cast<float>(w - 1)));
      const int x0 = static_cast<int>(fx);
      const int x1 = std::min(x0 + 1, w - 1);
      const float wx = fx - x0;
      const uint8_t* p00 = src + (static_cast<size_t>(y0) * w + x0) * 3;
      const uint8_t* p01 = src + (static_cast<size_t>(y0) * w + x1) * 3;
      const uint8_t* p10 = src + (static_cast<size_t>(y1) * w + x0) * 3;
      const uint8_t* p11 = src + (static_cast<size_t>(y1) * w + x1) * 3;
      uint8_t* o = dst + (static_cast<size_t>(oy) * out + ox) * 3;
      for (int c = 0; c < 3; ++c) {
        const float top = p00[c] + (p01[c] - p00[c]) * wx;
        const float bot = p10[c] + (p11[c] - p10[c]) * wx;
        o[c] = static_cast<uint8_t>(top + (bot - top) * wy + 0.5f);
      }
    }
  }
}

}  // namespace

extern "C" {

// Bump when the exported signature changes; vitax/data.py rebuilds any
// .so whose version doesn't match (a stale binary would otherwise be
// called with the wrong argument list).
int vt_api_version() { return 2; }

// Decode n JPEGs (concatenated in `data`, image i spanning
// [offsets[i], offsets[i+1])) into out[n, out_size, out_size, 3] uint8 RGB,
// resized bilinearly. status[i] = 0 ok, 1 decode error (output zeroed).
// flags: kDctScale | kFastIdct (0 = exact full decode, the PIL-parity
// path). Returns the number of failures. Runs on n_threads host threads.
int vt_decode_jpeg_batch(const uint8_t* data, const int64_t* offsets, int n,
                         int out_size, uint8_t* out, int64_t* status,
                         int n_threads, int flags) {
  std::atomic<int> next(0);
  std::atomic<int> failures(0);
  const size_t out_stride =
      static_cast<size_t>(out_size) * out_size * 3;

  auto worker = [&]() {
    std::vector<uint8_t> rgb;
    for (;;) {
      const int i = next.fetch_add(1);
      if (i >= n) return;
      const uint8_t* buf = data + offsets[i];
      const size_t len = static_cast<size_t>(offsets[i + 1] - offsets[i]);
      int h = 0, w = 0;
      uint8_t* dst = out + i * out_stride;
      if (!decode_one(buf, len, out_size, flags, &rgb, &h, &w)) {
        std::memset(dst, 0, out_stride);
        status[i] = 1;
        failures.fetch_add(1);
        continue;
      }
      if (h == out_size && w == out_size) {
        std::memcpy(dst, rgb.data(), out_stride);
      } else {
        resize_bilinear(rgb.data(), h, w, dst, out_size);
      }
      status[i] = 0;
    }
  };

  n_threads = std::max(1, std::min(n_threads, n));
  std::vector<std::thread> threads;
  threads.reserve(n_threads);
  for (int t = 0; t < n_threads; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
  return failures.load();
}

}  // extern "C"
