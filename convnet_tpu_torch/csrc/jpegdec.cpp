// Native JPEG decode + crop/resize pipeline of convnet_tpu_torch: a copy
// of the JAX package's native/jpegdec.cpp with the same C ABI (version 2).
//
// The decode half of the reference's DataLoader worker processes (read
// file → decode → transform). This library runs the whole per-sample
// path — pread from the indexed tar (or a blob in memory), libjpeg
// decode, RandomResizedCrop (train) or shorter-side-scale + center-crop
// (eval), triangle-filter resampling like PIL's BILINEAR — inside a C++
// thread pool, outside Python's GIL, emitting a ready uint8 NHWC batch.
// Horizontal flip and normalization stay in the device transform
// (data/preprocess.py), as in the PIL path.
//
// A plain C ABI for ctypes. Built with g++ -ljpeg on first use by
// convnet_tpu_torch/ops/kernels/_build.py into convnet_tpu_torch/_build/;
// Python wrapper: convnet_tpu_torch/data/native.py (PIL fallback when
// the library or libjpeg is absent).

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <csetjmp>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <unistd.h>

#include <jpeglib.h>

namespace {

// ---------------------------------------------------------------- RNG
// Deterministic per-sample generator: splitmix64 streams keyed by
// (seed, sample index) — stable across thread schedules.
struct Rng {
  uint64_t s;
  explicit Rng(uint64_t seed) : s(seed) {}
  uint64_t next() {
    s += 0x9e3779b97f4a7c15ull;
    uint64_t z = s;
    z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ull;
    z = (z ^ (z >> 27)) * 0x94d049bb133111ebull;
    return z ^ (z >> 31);
  }
  double uniform() { return (next() >> 11) * (1.0 / 9007199254740992.0); }
  // uniform integer in [0, n]
  int64_t randint(int64_t n) {
    return n <= 0 ? 0 : (int64_t)(next() % (uint64_t)(n + 1));
  }
};

// ------------------------------------------------------- jpeg decode
struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jb;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* e = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(e->jb, 1);
}

// Parse only the JPEG header: full image dimensions without decoding
// any pixels (~µs; used to choose crop boxes and the DCT scale before
// the expensive decode). Applies the same decompression-bomb guard as
// decode_rgb.
bool peek_dims(const uint8_t* data, size_t len, int* w, int* h) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(data), len);
  jpeg_read_header(&cinfo, TRUE);
  *w = cinfo.image_width;
  *h = cinfo.image_height;
  jpeg_destroy_decompress(&cinfo);
  return *w > 0 && *h > 0
         && (uint64_t)(*w) * (*h) <= 178956970ull;
}

// Decode a JPEG byte blob to RGB8 at scale_num/8 of full resolution
// (scale_num=8 → full). Fractional-M/8 scaling rides libjpeg(-turbo)'s
// reduced-size IDCT — the decoder computes only the needed DCT
// coefficients per block, so IDCT + color-conversion + memory cost
// drops ~(M/8)²; entropy decoding is unchanged. Returns true on
// success; *w/*h receive the OUTPUT (scaled) dims.
bool decode_rgb(const uint8_t* data, size_t len, std::vector<uint8_t>* out,
                int* w, int* h, int scale_num = 8) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(data), len);
  jpeg_read_header(&cinfo, TRUE);
  // decompression-bomb guard (PIL's MAX_IMAGE_PIXELS): a crafted
  // header can declare huge dims and the resize below would attempt a
  // multi-GB allocation — fail the sample instead (PIL fallback path
  // raises its own DecompressionBombError for the same input)
  if ((uint64_t)cinfo.image_width * cinfo.image_height > 178956970ull) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  cinfo.out_color_space = JCS_RGB;
  cinfo.scale_num = scale_num;
  cinfo.scale_denom = 8;
  jpeg_start_decompress(&cinfo);
  *w = cinfo.output_width;
  *h = cinfo.output_height;
  out->resize((size_t)(*w) * (*h) * 3);
  JSAMPROW row;
  while (cinfo.output_scanline < cinfo.output_height) {
    row = out->data() + (size_t)cinfo.output_scanline * (*w) * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

// ------------------------------------------- triangle-filter resize
// Separable resampling with a triangle (linear) kernel whose support
// scales with the downscale factor — PIL Image.BILINEAR semantics —
// over a source RECTANGLE (the crop box), fused so the crop is never
// materialized.
struct Taps {
  std::vector<int> start;     // first source index per output pixel
  std::vector<int> count;     // taps per output pixel
  std::vector<float> weight;  // flattened weights
  std::vector<int> woff;      // offset into weight per output pixel
};

void build_taps(double src0, double src1, int src_limit, int out_n,
                Taps* t) {
  double scale = (src1 - src0) / out_n;
  double support = std::max(1.0, scale);
  t->start.resize(out_n);
  t->count.resize(out_n);
  t->woff.resize(out_n);
  t->weight.clear();
  for (int i = 0; i < out_n; ++i) {
    double center = src0 + (i + 0.5) * scale;
    int lo = (int)std::floor(center - support);
    int hi = (int)std::ceil(center + support);
    lo = std::max(lo, 0);
    hi = std::min(hi, src_limit);
    if (hi <= lo) {
      lo = std::min(std::max((int)center, 0), src_limit - 1);
      hi = lo + 1;
    }
    t->start[i] = lo;
    t->woff[i] = (int)t->weight.size();
    double total = 0.0;
    for (int k = lo; k < hi; ++k) {
      double d = (k + 0.5 - center) / support;
      double wgt = 1.0 - std::fabs(d);
      if (wgt < 0) wgt = 0;
      t->weight.push_back((float)wgt);
      total += wgt;
    }
    t->count[i] = hi - lo;
    if (total > 0) {
      for (int k = 0; k < t->count[i]; ++k)
        t->weight[t->woff[i] + k] = (float)(t->weight[t->woff[i] + k] / total);
    }
  }
}

// Resize the box [x0,x1)x[y0,y1) of src (h x w x 3) to out_n x out_n.
void resize_box(const uint8_t* src, int w, int h, double x0, double y0,
                double x1, double y1, int out_n, uint8_t* dst) {
  Taps tx, ty;
  build_taps(x0, x1, w, out_n, &tx);
  build_taps(y0, y1, h, out_n, &ty);
  // horizontal pass over the source rows the vertical taps touch
  int row_lo = ty.start[0];
  int row_hi = ty.start[out_n - 1] + ty.count[out_n - 1];
  int rows = row_hi - row_lo;
  std::vector<float> tmp((size_t)rows * out_n * 3);
  for (int r = 0; r < rows; ++r) {
    const uint8_t* srow = src + (size_t)(row_lo + r) * w * 3;
    float* trow = tmp.data() + (size_t)r * out_n * 3;
    for (int i = 0; i < out_n; ++i) {
      float acc0 = 0, acc1 = 0, acc2 = 0;
      const float* wp = tx.weight.data() + tx.woff[i];
      const uint8_t* sp = srow + (size_t)tx.start[i] * 3;
      for (int k = 0; k < tx.count[i]; ++k) {
        float wgt = wp[k];
        acc0 += wgt * sp[0];
        acc1 += wgt * sp[1];
        acc2 += wgt * sp[2];
        sp += 3;
      }
      trow[i * 3 + 0] = acc0;
      trow[i * 3 + 1] = acc1;
      trow[i * 3 + 2] = acc2;
    }
  }
  // vertical pass
  for (int j = 0; j < out_n; ++j) {
    uint8_t* drow = dst + (size_t)j * out_n * 3;
    const float* wp = ty.weight.data() + ty.woff[j];
    int base = ty.start[j] - row_lo;
    for (int i = 0; i < out_n * 3; ++i) {
      float acc = 0;
      for (int k = 0; k < ty.count[j]; ++k)
        acc += wp[k] * tmp[(size_t)(base + k) * out_n * 3 + i];
      int v = (int)std::lround(acc);
      drow[i] = (uint8_t)std::min(std::max(v, 0), 255);
    }
  }
}

}  // namespace

namespace {

// RandomResizedCrop box in FULL-RESOLUTION source coordinates, chosen
// from the header dims alone — the RNG consumption is two uniforms per
// attempt and two randints on success (randint(0) consumes nothing), so
// the crops do not depend on the fast-DCT decode scale.
struct Box {
  double x0, y0, x1, y1;
};

Box choose_rrc_box(uint64_t key, int w, int h, int out_size,
                   double scale_lo, double scale_hi, double ratio_lo,
                   double ratio_hi) {
  Rng rng(key);
  double area = (double)w * h;
  for (int attempt = 0; attempt < 10; ++attempt) {
    double target = (scale_lo + rng.uniform() * (scale_hi - scale_lo))
                    * area;
    double aspect = std::exp(std::log(ratio_lo) + rng.uniform()
                             * (std::log(ratio_hi) - std::log(ratio_lo)));
    int bw = (int)std::lround(std::sqrt(target * aspect));
    int bh = (int)std::lround(std::sqrt(target / aspect));
    if (bw <= w && bh <= h && bw > 0 && bh > 0) {
      int x0 = (int)rng.randint(w - bw);
      int y0 = (int)rng.randint(h - bh);
      return {(double)x0, (double)y0, (double)(x0 + bw),
              (double)(y0 + bh)};
    }
  }
  // fallback: shorter-side scale + center crop, as a source-coord box
  int ss = out_size * 256 / 224;
  double sc = (double)ss / std::min(w, h);
  double nw = w * sc, nh = h * sc;
  double cx0 = (nw - out_size) / 2 / sc, cy0 = (nh - out_size) / 2 / sc;
  return {cx0, cy0, cx0 + out_size / sc, cy0 + out_size / sc};
}

// Shared per-batch driver: `fetch(i, blob)` fills the raw JPEG bytes
// for sample i (pread from a tar, or a pointer into a memory buffer).
template <typename Fetch>
int64_t decode_batch_impl(Fetch fetch, int64_t n, int mode, int out_size,
                          int scale_size, uint64_t seed, double scale_lo,
                          double scale_hi, double ratio_lo, double ratio_hi,
                          int dup, int fast_dct, uint8_t* out,
                          uint8_t* fail_mask, int nthreads) {
  if (nthreads < 1) nthreads = 1;
  if (dup < 1) dup = 1;
  std::atomic<int64_t> next_idx{0}, ok_count{0};
  size_t plane = (size_t)out_size * out_size * 3;

  auto worker = [&]() {
    std::vector<uint8_t> blob, pix;
    while (true) {
      int64_t i = next_idx.fetch_add(1);
      if (i >= n) return;
      fail_mask[i] = 1;
      int w = 0, h = 0;
      try {
      if (!fetch(i, &blob)) {
        std::memset(out + (size_t)i * dup * plane, 0, dup * plane);
        continue;
      }
      if (mode == 0) {
        // Train RandomResizedCrop. Boxes depend only on the header
        // dims, so they are chosen BEFORE the pixel decode; with
        // fast_dct the decode then runs at the smallest M/8 DCT scale
        // that keeps every chosen crop ≥ out_size in both axes (the
        // resample stays a downscale), cutting IDCT/color/memory cost
        // ~(M/8)² on large sources. Box selection and therefore the
        // augmentation stream are identical either way.
        int fw = 0, fh = 0;
        if (!peek_dims(blob.data(), blob.size(), &fw, &fh)) {
          std::memset(out + (size_t)i * dup * plane, 0, dup * plane);
          continue;
        }
        std::vector<Box> boxes((size_t)dup);
        int scale_num = fast_dct ? 1 : 8;
        for (int d = 0; d < dup; ++d) {
          boxes[d] = choose_rrc_box(
              (seed * 0x9e3779b97f4a7c15ull + (uint64_t)i)
                  * 0xd1342543de82ef95ull + (uint64_t)d,
              fw, fh, out_size, scale_lo, scale_hi, ratio_lo, ratio_hi);
          if (fast_dct) {
            double mind = std::min(boxes[d].x1 - boxes[d].x0,
                                   boxes[d].y1 - boxes[d].y0);
            int need = (int)std::ceil(8.0 * out_size
                                      / std::max(mind, 1.0));
            scale_num = std::max(scale_num,
                                 std::min(8, std::max(1, need)));
          }
        }
        if (!fast_dct) scale_num = 8;
        bool ok = decode_rgb(blob.data(), blob.size(), &pix, &w, &h,
                             scale_num);
        if (!ok && scale_num != 8) {
          // scaled decode rejected by this libjpeg → full-res retry
          ok = decode_rgb(blob.data(), blob.size(), &pix, &w, &h, 8);
          scale_num = 8;
        }
        if (!ok) {
          std::memset(out + (size_t)i * dup * plane, 0, dup * plane);
          continue;
        }
        // geometric map full-res → decoded coords is exactly M/8; if
        // the library applied a different ratio (non-turbo libjpeg
        // rounds to 1/2/4/8), recover it from the actual output dims
        if (w != (fw * scale_num + 7) / 8)
          scale_num = (int)std::lround(8.0 * w / fw);
        double f = scale_num / 8.0;
        for (int d = 0; d < dup; ++d) {
          uint8_t* dst = out + ((size_t)i * dup + d) * plane;
          resize_box(pix.data(), w, h, boxes[d].x0 * f, boxes[d].y0 * f,
                     boxes[d].x1 * f, boxes[d].y1 * f, out_size, dst);
        }
        fail_mask[i] = 0;
        ok_count.fetch_add(1);
        continue;
      }
      if (!decode_rgb(blob.data(), blob.size(), &pix, &w, &h)) {
        // honor the documented contract: failed planes are ZEROED
        // (the caller-visible buffer is allocated uninitialized)
        std::memset(out + (size_t)i * dup * plane, 0, dup * plane);
        continue;
      }
      // batch augmentation ("duplicates", reference --duplicates /
      // Hoffer et al. CVPR'20): K independently-cropped copies per
      // DECODE — the expensive decode is amortized across the copies.
      for (int d = 0; d < dup; ++d) {
      uint8_t* dst = out + ((size_t)i * dup + d) * plane;
      {
        // Mirror preprocess.scale_center EXACTLY (PIL semantics):
        // integer resized dims via truncation, integer center-crop
        // origin, then express the crop as a box resize in source
        // coordinates — output pixel i maps to source center
        // (x0 + i + 0.5) * w / nw, identical to PIL's taps, so the
        // result is bitwise-equal to the Python path.
        int ss = scale_size > 0 ? scale_size : out_size * 256 / 224;
        int nw, nh;
        if (w < h) {
          nw = ss;
          nh = (int)((double)h * ss / w);
        } else {
          nw = (int)((double)w * ss / h);
          nh = ss;
        }
        int x0 = (nw - out_size) / 2;
        int y0 = (nh - out_size) / 2;
        double sx = (double)w / nw, sy = (double)h / nh;
        resize_box(pix.data(), w, h, x0 * sx, y0 * sy,
                   (x0 + out_size) * sx, (y0 + out_size) * sy,
                   out_size, dst);
      }
      }  // dup
      fail_mask[i] = 0;
      ok_count.fetch_add(1);
      } catch (...) {
        // an exception escaping a std::thread calls std::terminate and
        // kills the whole process — any failure (bad_alloc from a
        // pathological image, etc.) must become a per-sample fail
        // (fail_mask already 1), leaving zeros for the PIL fallback
        std::memset(out + (size_t)i * dup * plane, 0, dup * plane);
      }
    }
  };

  std::vector<std::thread> pool;
  for (int t = 0; t < nthreads - 1; ++t) pool.emplace_back(worker);
  worker();
  for (auto& th : pool) th.join();
  return ok_count.load();
}

}  // namespace

extern "C" {

// ABI handshake for the ctypes wrapper (convnet_tpu_torch/data/native.py).
// Bump whenever an exported signature changes; the wrapper refuses to
// call a library whose version differs (a library whose argument list
// has drifted from the Python signature reads pointers as ints and
// corrupts the heap).
// Version 2 = 16-arg decode entry points (… int dup, int fast_dct,
// uint8_t* out, uint8_t* fail_mask, int nthreads).
int64_t ctpu_jpegdec_abi_version(void) { return 2; }

// Decode + transform a batch of JPEG blobs from `tar_path`.
//   mode 0: RandomResizedCrop(out_size, scale=[scale_lo,scale_hi],
//           ratio=[ratio_lo,ratio_hi]) — train path (no flip: the
//           device transform flips).
//   mode 1: resize shorter side to scale_size, center-crop out_size —
//           eval path (PIL-geometry exact).
// fast_dct != 0 (mode 0 only): decode at reduced M/8 DCT scale chosen
// so every crop still covers out_size — same crop boxes, ~same output
// distribution, large sources decode faster (Huffman decode, which DCT
// scaling cannot skip, bounds the win). mode 1 ignores it
// (the eval path keeps its 1-LSB PIL parity).
// out: n * out_size * out_size * 3 uint8, HWC.
// Returns number of successfully decoded samples; failed decodes
// leave zeros and set fail_mask[i]=1 (caller falls back to PIL).
int64_t ctpu_decode_batch(const char* tar_path, const int64_t* offsets,
                          const int64_t* sizes, int64_t n, int mode,
                          int out_size, int scale_size, uint64_t seed,
                          double scale_lo, double scale_hi,
                          double ratio_lo, double ratio_hi, int dup,
                          int fast_dct, uint8_t* out, uint8_t* fail_mask,
                          int nthreads) {
  int fd = open(tar_path, O_RDONLY);
  if (fd < 0) return -1;
  auto fetch = [&](int64_t i, std::vector<uint8_t>* blob) {
    blob->resize(sizes[i]);
    return pread(fd, blob->data(), sizes[i], offsets[i])
           == (ssize_t)sizes[i];
  };
  int64_t ok = decode_batch_impl(fetch, n, mode, out_size, scale_size,
                                 seed, scale_lo, scale_hi, ratio_lo,
                                 ratio_hi, dup, fast_dct, out, fail_mask,
                                 nthreads);
  close(fd);
  return ok;
}

// Same, from an in-memory concatenation of blobs (serving path:
// convnet_tpu_torch/serve.py predict_jpeg; ImageFolder batches).
int64_t ctpu_decode_batch_mem(const uint8_t* base, const int64_t* offsets,
                              const int64_t* sizes, int64_t n, int mode,
                              int out_size, int scale_size, uint64_t seed,
                              double scale_lo, double scale_hi,
                              double ratio_lo, double ratio_hi, int dup,
                              int fast_dct, uint8_t* out, uint8_t* fail_mask,
                              int nthreads) {
  auto fetch = [&](int64_t i, std::vector<uint8_t>* blob) {
    blob->assign(base + offsets[i], base + offsets[i] + sizes[i]);
    return true;
  };
  return decode_batch_impl(fetch, n, mode, out_size, scale_size, seed,
                           scale_lo, scale_hi, ratio_lo, ratio_hi, dup,
                           fast_dct, out, fail_mask, nthreads);
}

}  // extern "C"
