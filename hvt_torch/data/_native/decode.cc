// Native data-loader core: JPEG decode + fused resize/crop/flip, GIL-free.
//
// A copy of hvt's core (hvt/data/_native/decode.cc), built by
// hvt_torch/data/native.py: the CPU-side JPEG decode and augment, the
// training input's hot path (torch's DataLoader workers + PIL/libjpeg
// would take its place; "the known throughput bottleneck is the CPU-side JPEG
// decode/augment path"). One C call decodes a whole batch with an internal
// thread pool, so Python threads never contend on the GIL for pixel work.
//
// Semantics match hvt_torch/data/transforms.py:
//   train: [virtual shorter-side resize] -> RandomResizedCrop(scale, ratio,
//          10 attempts + clamped-center fallback) -> bilinear to out_size
//          -> p=0.5 horizontal flip
//   eval:  [virtual shorter-side resize] -> center crop -> bilinear to out_size
// The crop box is sampled in (virtually) resized coordinates and mapped back
// to source pixels, so the region is resampled exactly once (quality >= the
// two-pass PIL pipeline). libjpeg DCT scaling decodes at 1/2^k resolution
// when the target is much smaller than the source.
//
// RNG: splitmix64 seeded per (sample, epoch) by the caller — fully
// deterministic and independent of thread scheduling.

#include <cstddef>
#include <cstdio>

#include <jpeglib.h>  // requires cstddef/cstdio first (uses size_t, FILE)

#include <algorithm>
#include <atomic>
#include <cmath>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------- RNG -----
struct SplitMix64 {
  uint64_t state;
  explicit SplitMix64(uint64_t seed) : state(seed) {}
  uint64_t next() {
    uint64_t z = (state += 0x9e3779b97f4a7c15ULL);
    z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
    z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
    return z ^ (z >> 31);
  }
  double uniform() { return (next() >> 11) * 0x1.0p-53; }
  double uniform(double lo, double hi) { return lo + uniform() * (hi - lo); }
  int64_t randint(int64_t lo, int64_t hi) {  // [lo, hi] inclusive
    return lo + static_cast<int64_t>(uniform() * (hi - lo + 1));
  }
};

// ------------------------------------------------------------- decode -----
struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jump;
};

void jpeg_error_exit(j_common_ptr cinfo) {
  JpegErr* err = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(err->jump, 1);
}

struct Image {
  std::vector<uint8_t> pixels;  // HWC RGB
  int w = 0, h = 0;
};

// JPEG source: a file path (loader) or an in-memory buffer (serving — the
// HTTP engine hands request bytes straight to the decoder).
struct Source {
  const char* path = nullptr;
  const uint8_t* buf = nullptr;
  size_t len = 0;
};

// Decode a JPEG to RGB. min_dim: smallest useful output dimension —
// libjpeg DCT scaling (M/8 for M in 1..8) is chosen so the decoded image
// stays >= max(min_w, min_h) in each dimension when possible.
bool decode_jpeg(const Source& src, double min_w, double min_h, Image* out) {
  FILE* f = nullptr;
  if (src.path != nullptr) {
    f = std::fopen(src.path, "rb");
    if (!f) return false;
  } else if (src.buf == nullptr || src.len == 0) {
    return false;
  }

  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_error_exit;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    if (f) std::fclose(f);
    return false;
  }

  jpeg_create_decompress(&cinfo);
  if (f) {
    jpeg_stdio_src(&cinfo, f);
  } else {
    jpeg_mem_src(&cinfo, const_cast<unsigned char*>(src.buf),
                 static_cast<unsigned long>(src.len));
  }
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;

  // Pick the smallest DCT scale M/8 that keeps both dims >= the needed size.
  int m = 8;
  for (int cand = 1; cand <= 8; ++cand) {
    double sw = cinfo.image_width * cand / 8.0;
    double sh = cinfo.image_height * cand / 8.0;
    if (sw >= min_w && sh >= min_h) {
      m = cand;
      break;
    }
  }
  cinfo.scale_num = m;
  cinfo.scale_denom = 8;

  jpeg_start_decompress(&cinfo);
  out->w = cinfo.output_width;
  out->h = cinfo.output_height;
  const int ch = cinfo.output_components;
  out->pixels.resize(static_cast<size_t>(out->w) * out->h * 3);

  std::vector<uint8_t> row(static_cast<size_t>(out->w) * ch);
  for (int y = 0; y < out->h; ++y) {
    uint8_t* rowptr = row.data();
    jpeg_read_scanlines(&cinfo, &rowptr, 1);
    uint8_t* dst = out->pixels.data() + static_cast<size_t>(y) * out->w * 3;
    if (ch == 3) {
      std::memcpy(dst, row.data(), static_cast<size_t>(out->w) * 3);
    } else {  // grayscale -> replicate
      for (int x = 0; x < out->w; ++x) {
        uint8_t v = row[x * ch];
        dst[x * 3 + 0] = v;
        dst[x * 3 + 1] = v;
        dst[x * 3 + 2] = v;
      }
    }
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  if (f) std::fclose(f);
  return true;
}

// Read only the header for (w, h).
bool jpeg_dims(const Source& src, int* w, int* h) {
  FILE* f = nullptr;
  if (src.path != nullptr) {
    f = std::fopen(src.path, "rb");
    if (!f) return false;
  } else if (src.buf == nullptr || src.len == 0) {
    return false;
  }
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_error_exit;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    if (f) std::fclose(f);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  if (f) {
    jpeg_stdio_src(&cinfo, f);
  } else {
    jpeg_mem_src(&cinfo, const_cast<unsigned char*>(src.buf),
                 static_cast<unsigned long>(src.len));
  }
  jpeg_read_header(&cinfo, TRUE);
  *w = cinfo.image_width;
  *h = cinfo.image_height;
  jpeg_abort_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  if (f) std::fclose(f);
  return true;
}

// --------------------------------------------------------- resampling -----
// Bilinear resample of the source box [bx, by, bw, bh] to out_size x out_size.
// Box coords are in source pixels (clamped); optional horizontal flip.
void resample_box(const Image& img, double bx, double by, double bw, double bh,
                  int out_size, bool hflip, uint8_t* out) {
  const double sx = bw / out_size;
  const double sy = bh / out_size;

  // Precompute the column mapping once (fixed-point 8-bit weights).
  std::vector<int> xs0(out_size), xs1(out_size);
  std::vector<int> wxs(out_size);
  for (int ox = 0; ox < out_size; ++ox) {
    double fx = bx + (ox + 0.5) * sx - 0.5;
    fx = std::min(std::max(fx, 0.0), static_cast<double>(img.w - 1));
    int x0 = static_cast<int>(fx);
    xs0[ox] = x0 * 3;
    xs1[ox] = std::min(x0 + 1, img.w - 1) * 3;
    wxs[ox] = static_cast<int>((fx - x0) * 256.0 + 0.5);
  }

  for (int oy = 0; oy < out_size; ++oy) {
    double fy = by + (oy + 0.5) * sy - 0.5;
    fy = std::min(std::max(fy, 0.0), static_cast<double>(img.h - 1));
    int y0 = static_cast<int>(fy);
    int y1 = std::min(y0 + 1, img.h - 1);
    int wy = static_cast<int>((fy - y0) * 256.0 + 0.5);
    const uint8_t* row0 = img.pixels.data() + static_cast<size_t>(y0) * img.w * 3;
    const uint8_t* row1 = img.pixels.data() + static_cast<size_t>(y1) * img.w * 3;
    uint8_t* dst_row = out + static_cast<size_t>(oy) * out_size * 3;
    for (int ox = 0; ox < out_size; ++ox) {
      const int x0 = xs0[ox], x1 = xs1[ox], wx = wxs[ox];
      int out_x = hflip ? (out_size - 1 - ox) : ox;
      uint8_t* dst = dst_row + out_x * 3;
      for (int c = 0; c < 3; ++c) {
        int top = row0[x0 + c] * (256 - wx) + row0[x1 + c] * wx;   // <<8
        int bot = row1[x0 + c] * (256 - wx) + row1[x1 + c] * wx;   // <<8
        int v = top * (256 - wy) + bot * wy;                        // <<16
        dst[c] = static_cast<uint8_t>((v + (1 << 15)) >> 16);
      }
    }
  }
}

struct Box {
  double x, y, w, h;
};

// RandomResizedCrop box in *virtual* (post shorter-side resize) coordinates
// (matches hvt_torch/data/transforms.py random_resized_crop: 10 attempts, then a
// ratio-clamped center fallback).
Box sample_rrc_box(int vw, int vh, double smin, double smax, double rmin,
                   double rmax, SplitMix64* rng) {
  const double area = static_cast<double>(vw) * vh;
  for (int attempt = 0; attempt < 10; ++attempt) {
    double target = area * rng->uniform(smin, smax);
    double aspect = std::exp(rng->uniform(std::log(rmin), std::log(rmax)));
    int cw = static_cast<int>(std::lround(std::sqrt(target * aspect)));
    int ch = static_cast<int>(std::lround(std::sqrt(target / aspect)));
    if (cw > 0 && cw <= vw && ch > 0 && ch <= vh) {
      double x = static_cast<double>(rng->randint(0, vw - cw));
      double y = static_cast<double>(rng->randint(0, vh - ch));
      return {x, y, static_cast<double>(cw), static_cast<double>(ch)};
    }
  }
  double in_ratio = static_cast<double>(vw) / vh;
  int cw, ch;
  if (in_ratio < rmin) {
    cw = vw;
    ch = static_cast<int>(std::lround(vw / rmin));
  } else if (in_ratio > rmax) {
    ch = vh;
    cw = static_cast<int>(std::lround(vh * rmax));
  } else {
    cw = vw;
    ch = vh;
  }
  return {(vw - cw) / 2.0, (vh - ch) / 2.0, static_cast<double>(cw),
          static_cast<double>(ch)};
}

// Map a virtual-coordinate box back to source pixels.
Box to_source(const Box& b, double f) {
  return {b.x / f, b.y / f, b.w / f, b.h / f};
}

int load_one(const Source& src, uint64_t seed, int is_train, int resize_size,
             int out_size, double smin, double smax, double rmin, double rmax,
             uint8_t* out) {
  int w = 0, h = 0;
  if (!jpeg_dims(src, &w, &h) || w <= 0 || h <= 0) return 1;

  // Virtual pre-resize factor (shorter side -> resize_size).
  double f = 1.0;
  if (resize_size > 0) f = static_cast<double>(resize_size) / std::min(w, h);
  int vw = std::max(1, static_cast<int>(std::lround(w * f)));
  int vh = std::max(1, static_cast<int>(std::lround(h * f)));

  Box vbox;
  bool hflip = false;
  if (is_train) {
    SplitMix64 rng(seed);
    vbox = sample_rrc_box(vw, vh, smin, smax, rmin, rmax, &rng);
    hflip = rng.uniform() < 0.5;
  } else {
    // Center crop of out_size in virtual coords; if the virtual image is
    // smaller, take the full image (pad-by-resize semantics).
    double cw = std::min(static_cast<double>(out_size), static_cast<double>(vw));
    double chh = std::min(static_cast<double>(out_size), static_cast<double>(vh));
    vbox = {(vw - cw) / 2.0, (vh - chh) / 2.0, cw, chh};
  }
  Box sbox = to_source(vbox, f);

  Image img;
  // Decode with just enough resolution that the sampled box still maps to
  // >= out_size pixels (DCT scaling then skips most of the IDCT work for
  // large sources).
  double need_w = std::min(static_cast<double>(w),
                           w * out_size / std::max(sbox.w, 1.0));
  double need_h = std::min(static_cast<double>(h),
                           h * out_size / std::max(sbox.h, 1.0));
  if (!decode_jpeg(src, need_w, need_h, &img)) return 1;
  // Decoding may be DCT-scaled; rescale box coordinates accordingly.
  double dsx = static_cast<double>(img.w) / w;
  double dsy = static_cast<double>(img.h) / h;
  resample_box(img, sbox.x * dsx, sbox.y * dsy, sbox.w * dsx, sbox.h * dsy,
               out_size, hflip, out);
  return 0;
}

}  // namespace

extern "C" {

// Batch entry point. paths: n C strings; seeds: n uint64; out: n*S*S*3 bytes.
// Returns the number of failed images (their slots are zero-filled).
int hvt_load_batch(const char** paths, const uint64_t* seeds, int n,
                   int is_train, int resize_size, int out_size, double smin,
                   double smax, double rmin, double rmax, int n_threads,
                   uint8_t* out) {
  const size_t stride = static_cast<size_t>(out_size) * out_size * 3;
  std::atomic<int> failures{0};
  std::atomic<int> cursor{0};

  auto worker = [&]() {
    for (;;) {
      int i = cursor.fetch_add(1);
      if (i >= n) break;
      uint8_t* dst = out + stride * i;
      Source src;
      src.path = paths[i];
      int rc = load_one(src, seeds ? seeds[i] : 0, is_train, resize_size,
                        out_size, smin, smax, rmin, rmax, dst);
      if (rc != 0) {
        std::memset(dst, 0, stride);
        failures.fetch_add(1);
      }
    }
  };

  int threads = std::max(1, std::min(n_threads, n));
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

// In-memory single-image decode for the serving path: the HTTP engine hands
// the request body here (eval law: virtual shorter-side resize -> center
// crop -> bilinear, identical to the loader's native eval path). ctypes
// releases the GIL for the call, so concurrent server threads decode in
// parallel. Returns 0 on success.
int hvt_decode_eval_buffer(const uint8_t* data, size_t len, int resize_size,
                           int out_size, uint8_t* out) {
  Source src;
  src.buf = data;
  src.len = len;
  return load_one(src, 0, /*is_train=*/0, resize_size, out_size, 0.08, 1.0,
                  0.75, 4.0 / 3.0, out);
}

// DCT-scaled decode floor: the smallest useful decode resolution for the
// sampled box is the box itself (we only ever downsample to out_size).
// Exposed for tests.
int hvt_jpeg_dims(const char* path, int* w, int* h) {
  Source src;
  src.path = path;
  return jpeg_dims(src, w, h) ? 0 : 1;
}

}  // extern "C"
