// Depthwise k x k convolution on NHWC for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_build_fwd.body` behind
// `depthwise_conv_pallas` in convnet_tpu/ops/pallas/depthwise.py (pallas_call
// at line 62). It computes
//
//   y[b, i, j, c] = sum over (di, dj) of
//       xpad[b, i*sh + di, j*sw + dj, c] * w[c, 0, di, dj]
//
// with x (B, H, W, C) and y (B, Ho, Wo, C) NHWC, the zero padding read as
// zero, and w the port's OIHW weight (C, 1, kh, kw), read as it is: channel
// c's taps are the kh*kw elements at w + c*kh*kw. The taps are added in the
// Pallas body's order, di outer and dj inner, each product rounded to
// float32 and then added (__fmul_rn, __fadd_rn: no fused multiply-add),
// which is what the plain version's multiply-then-add does; so in float32
// the two agree bit for bit. In bf16 a product of two bf16 values is exact
// in float32, so a fused multiply-add rounds once where the two steps round
// once too, and gives the same sum; y's final rounding is the same too.
//
// What bounds it on an H100: bytes. Each output element takes kh*kw products
// (18 operations at 3x3) against reading its input once and writing itself
// once; at MobileNet v1's nine shapes at batch 64 in bf16 that is about
// 0.19 ms at 3.35 TB/s against 0.07 ms of float32 multiplies and adds
// issued one by one.
//
// Two kernels, picked by a stated shape rule (`tiled_ok`), never on failure:
//
// * Tiled (3x3, equal strides 1 or 2, C a multiple of the 16-byte vector,
//   x, w and y 16-byte aligned): every depthwise conv of the port's models.
//   A work item is a tile of up to 8 output rows x up to 256/cv output
//   columns x a slab of cv <= 32 channel vectors (the channels cut evenly
//   into slabs). A persistent grid of 256-thread blocks, two an SM, walks
//   the items; a block stages an item's haloed input into shared memory
//   once with 16-byte cp.async copies (zero-filled in the padding), into
//   one of two buffers, so the copies of its next item fly while it
//   computes this one. Each thread owns one 16-byte channel vector and one
//   output column and walks down the tile's rows: every staged input row
//   it loads (its three column vectors) feeds the three output rows it
//   belongs to (one at stride 2, two where rows overlap), whose sums stay
//   in registers, so each staged vector is read from shared memory about
//   3 times (once per neighbouring column) rather than 9. Its 9 x VEC
//   weights come from w once per slab, as nine 16-byte loads (a vector's
//   taps are contiguous in OIHW), into registers: float32 as they are,
//   bf16 two to a register, widened at use (a shift or a mask), which
//   keeps the bf16 kernel within 128 registers without spilling. y is
//   written once, 16 bytes a thread.
// * Per pixel (any other kernel size, unequal strides, C not a multiple of
//   the vector, or an unaligned pointer): the first design, kept. One
//   thread per output pixel and channel vector (or channel), each tap read
//   from device memory; the weights read one by one from the OIHW layout.
//
// Offsets within x and y are 32-bit where the wrapper allows it: it checks
// that x and y hold fewer than 2^31 elements.
//
// Plain C interface, no PyTorch headers: built with nvcc into a shared
// library and called through ctypes (convnet_tpu_torch/ops/kernels).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Geom {
  int B, H, W, C, Ho, Wo, kh, kw, sh, sw, ph, pw;
};

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// acc + x * w with the product rounded to float32 first. In bf16 the
// product of two bf16 values is exact, so one fused multiply-add gives the
// same float32 as the two rounded steps.
__device__ __forceinline__ float tap(float acc, float x, float w, float) {
  return __fadd_rn(acc, __fmul_rn(x, w));
}
__device__ __forceinline__ float tap(float acc, float x, float w,
                                     __nv_bfloat16) {
  return __fmaf_rn(x, w, acc);
}

// --------------------------------------------------------- per-pixel kernel

constexpr int THREADS = 256;

template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS)
    depthwise_conv2d_kernel(const T* __restrict__ x, const T* __restrict__ w,
                            T* __restrict__ y, Geom g) {
  const int cv = g.C / VEC;
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= g.B * g.Ho * g.Wo * cv) return;
  const int c = (i % cv) * VEC;
  int r = i / cv;
  const int ow = r % g.Wo;
  r /= g.Wo;
  const int oh = r % g.Ho;
  const int b = r / g.Ho;
  const int taps = g.kh * g.kw;

  float acc[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) acc[v] = 0.0f;
  for (int di = 0; di < g.kh; ++di) {
    const int ih = oh * g.sh - g.ph + di;
    if (ih < 0 || ih >= g.H) continue;  // a padded tap adds zero
    for (int dj = 0; dj < g.kw; ++dj) {
      const int iw = ow * g.sw - g.pw + dj;
      if (iw < 0 || iw >= g.W) continue;
      const Pack<T, VEC> xv = *reinterpret_cast<const Pack<T, VEC>*>(
          x + ((b * g.H + ih) * g.W + iw) * g.C + c);
      const T* wt = w + c * taps + di * g.kw + dj;
#pragma unroll
      for (int v = 0; v < VEC; ++v)
        acc[v] = __fadd_rn(acc[v],
                           __fmul_rn(to_f32(xv.v[v]), to_f32(wt[v * taps])));
    }
  }
  Pack<T, VEC> out;
#pragma unroll
  for (int v = 0; v < VEC; ++v) out.v[v] = from_f32<T>(acc[v]);
  *reinterpret_cast<Pack<T, VEC>*>(y + i * VEC) = out;
}

template <typename T>
int launch(const void* x, const void* w, void* y, Geom g, bool vec,
           cudaStream_t s) {
  constexpr int VEC = 16 / sizeof(T);
  const long long total =
      (long long)g.B * g.Ho * g.Wo * (vec ? g.C / VEC : g.C);
  const unsigned blocks = (unsigned)((total + THREADS - 1) / THREADS);
  const auto* xt = static_cast<const T*>(x);
  const auto* wt = static_cast<const T*>(w);
  auto* yt = static_cast<T*>(y);
  if (vec)
    depthwise_conv2d_kernel<T, VEC><<<blocks, THREADS, 0, s>>>(xt, wt, yt, g);
  else
    depthwise_conv2d_kernel<T, 1><<<blocks, THREADS, 0, s>>>(xt, wt, yt, g);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------ tiled kernel

constexpr int TL_THREADS = 256;
constexpr int MAX_SLAB = 32;          // channel vectors a slab
constexpr int MAX_ROWS = 8;           // output rows a tile
constexpr int SMEM_CAP = 55 * 1024;   // a staged tile (2 a block, 2 an SM)

struct TileGeom {
  int B, H, W, C, Ho, Wo, ph, pw;
  int nv;                        // channel vectors, C / VEC
  int cv, slabs;                 // vectors a slab, slabs
  int tw, rt;                    // output columns, rows a tile
  int tiles_h, tiles_w, spatial; // tiles an image (rows, columns); all images
  int hr, hc;                    // staged rows, columns: (rt-1)S+3, (tw-1)S+3
};

__device__ __forceinline__ void cp_async16(uint32_t smem, const void* gmem,
                                           bool valid) {
  const int src_bytes = valid ? 16 : 0;  // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem),
               "l"(gmem), "r"(src_bytes));
}

// Starts the cp.async copies of item u's haloed input into dst: hr x hc
// pixels x cv vectors, zeros outside the image and past the last vector.
template <typename T, int S>
__device__ __forceinline__ void stage_tile(const T* __restrict__ x,
                                           uint32_t dst, const TileGeom& g,
                                           int u) {
  constexpr int VEC = 16 / sizeof(T);
  const int slab = u / g.spatial;
  int sp = u - slab * g.spatial;
  const int tx = sp % g.tiles_w;
  sp /= g.tiles_w;
  const int ty = sp % g.tiles_h;
  const int b = sp / g.tiles_h;
  const int ih0 = ty * g.rt * S - g.ph, iw0 = tx * g.tw * S - g.pw;
  // each thread copies one vector of every STEP-th pixel, stepping its
  // (row, column) forward rather than dividing
  const int step = TL_THREADS / g.cv;
  int pix = threadIdx.x / g.cv;
  if (pix >= step) return;
  const int vec = threadIdx.x - pix * g.cv;
  const int cvec = slab * g.cv + vec;
  const bool cok = cvec < g.nv;
  const T* xb = x + (size_t)b * g.H * g.W * g.C + cvec * VEC;
  const int npix = g.hr * g.hc;
  int c = pix % g.hc, r = pix / g.hc;
  for (; pix < npix; pix += step) {
    const int ih = ih0 + r, iw = iw0 + c;
    const bool valid = cok && ih >= 0 && ih < g.H && iw >= 0 && iw < g.W;
    const T* src = valid ? xb + (size_t)(ih * g.W + iw) * g.C : x;
    cp_async16(dst + (pix * g.cv + vec) * 16, src, valid);
    for (c += step; c >= g.hc; c -= g.hc) ++r;
  }
}

// The 9 taps of a thread's VEC channels, loaded from the OIHW weight, where
// channel c's taps are the 9 elements at c*9: the thread's 9*VEC elements
// are contiguous, nine 16-byte vectors. tap(t, e) is tap t of channel e.
template <typename T>
struct Taps;

template <>
struct Taps<float> {
  float w[9][4];
  __device__ __forceinline__ void load(const float* src) {
#pragma unroll
    for (int q = 0; q < 9; ++q) {
      const float4 v = reinterpret_cast<const float4*>(src)[q];
      const float f[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) w[(q * 4 + e) % 9][(q * 4 + e) / 9] = f[e];
    }
  }
  __device__ __forceinline__ float tap(int t, int e) const { return w[t][e]; }
};

// bf16: tap t of channels 2i and 2i + 1 in the low and high half of w[t][i]
template <>
struct Taps<__nv_bfloat16> {
  uint32_t w[9][4];
  __device__ __forceinline__ void load(const __nv_bfloat16* src) {
    uint32_t raw[36];  // element n (channel n / 9, tap n % 9): half n % 2
#pragma unroll
    for (int q = 0; q < 9; ++q) {
      const uint4 v = reinterpret_cast<const uint4*>(src)[q];
      raw[4 * q] = v.x, raw[4 * q + 1] = v.y;
      raw[4 * q + 2] = v.z, raw[4 * q + 3] = v.w;
    }
#pragma unroll
    for (int t = 0; t < 9; ++t) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int lo = 2 * i * 9 + t, hi = (2 * i + 1) * 9 + t;
        const int b0 = (lo & 1) * 2, b2 = 4 + (hi & 1) * 2;
        w[t][i] = __byte_perm(raw[lo / 2], raw[hi / 2],
                              b0 | (b0 + 1) << 4 | b2 << 8 | (b2 + 1) << 12);
      }
    }
  }
  __device__ __forceinline__ float tap(int t, int e) const {
    const uint32_t v = w[t][e / 2];
    return __uint_as_float(e & 1 ? v & 0xffff0000u : v << 16);
  }
};

// A persistent grid walks the items u = slab * spatial + tile (tiles
// fastest, so the blocks running together share halos in L2, and a block's
// slab, hence its weights, changes rarely).
template <typename T, int S>
__global__ void __launch_bounds__(TL_THREADS, 2)
    depthwise_tiled(const T* __restrict__ x, const T* __restrict__ w,
                    T* __restrict__ y, TileGeom g) {
  constexpr int VEC = 16 / sizeof(T);
  using V = Pack<T, VEC>;
  extern __shared__ __align__(16) unsigned char smem[];  // 2 x (hr, hc, cv)
  const V* stage = reinterpret_cast<const V*>(smem);
  const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int buf_vecs = g.hr * g.hc * g.cv;
  const int items = g.spatial * g.slabs;
  const int v = threadIdx.x % g.cv, col = threadIdx.x / g.cv;
  const bool active = col < g.tw;

  Taps<T> taps;  // the thread's 9 taps of its VEC channels
  int wslab = -1;

  int u = blockIdx.x;
  if (u < items) stage_tile<T, S>(x, base, g, u);
  asm volatile("cp.async.commit_group;\n" ::);
  for (int it = 0; u < items; u += gridDim.x, ++it) {
    const V* buf = stage + (it & 1) * buf_vecs;
    if (u + (int)gridDim.x < items)
      stage_tile<T, S>(x, base + ((it + 1) & 1) * buf_vecs * 16, g,
                       u + gridDim.x);
    asm volatile("cp.async.commit_group;\n" ::);  // possibly empty
    asm volatile("cp.async.wait_group 1;\n" ::);  // item u has landed
    __syncthreads();

    const int slab = u / g.spatial;
    int sp = u - slab * g.spatial;
    const int tx = sp % g.tiles_w;
    sp /= g.tiles_w;
    const int ty = sp % g.tiles_h;
    const int b = sp / g.tiles_h;
    const int cvec = slab * g.cv + v;
    const int oh0 = ty * g.rt, ow = tx * g.tw + col;
    if (active && cvec < g.nv && ow < g.Wo) {
      if (slab != wslab) {
        taps.load(w + (size_t)cvec * VEC * 9);
        wslab = slab;
      }
      const int rows = min(g.rt, g.Ho - oh0);
      T* yrow = y + ((size_t)(b * g.Ho + oh0) * g.Wo + ow) * g.C + cvec * VEC;
      const V* src = buf + (col * S) * g.cv + v;
      // staged row k feeds output rows r with k = r*S + di, di in 0..2;
      // their sums live in acc[r % 3] (each in tap order: its rows in
      // order, and in a row the columns in order) until di = 2 adds the
      // last taps
      float acc[3][VEC];
#pragma unroll
      for (int k = 0; k < (MAX_ROWS - 1) * S + 3; ++k) {
        if (k >= (rows - 1) * S + 3) break;
#pragma unroll
        for (int dj = 0; dj < 3; ++dj) {
          const V xv = src[(k * g.hc + dj) * g.cv];
#pragma unroll
          for (int di = 0; di < 3; ++di) {
            if (k < di || (k - di) % S != 0) continue;
            const int r = (k - di) / S;
            if (r >= rows) continue;
            float* a = acc[r % 3];
#pragma unroll
            for (int e = 0; e < VEC; ++e) {
              const float xf = to_f32(xv.v[e]);
              const float wv = taps.tap(di * 3 + dj, e);
              a[e] = (di == 0 && dj == 0) ? __fmul_rn(xf, wv)
                                          : tap(a[e], xf, wv, T());
            }
          }
        }
        if (k >= 2 && (k - 2) % S == 0 && (k - 2) / S < rows) {
          const int r = (k - 2) / S;
          V out;
#pragma unroll
          for (int e = 0; e < VEC; ++e) out.v[e] = from_f32<T>(acc[r % 3][e]);
          *reinterpret_cast<V*>(yrow + (size_t)r * g.Wo * g.C) = out;
        }
      }
    }
    __syncthreads();  // every thread is done with buf before it is refilled
  }
}

// Cuts n into the fewest parts of at most `most`, evenly.
int even(int n, int most) {
  const int parts = (n + most - 1) / most;
  return (n + parts - 1) / parts;
}

int tile_bytes(const TileGeom& t, int s) {
  return ((t.rt - 1) * s + 3) * ((t.tw - 1) * s + 3) * t.cv * 16;
}

// The tile: slabs of at most MAX_SLAB vectors, cut evenly; as many output
// columns as the block has threads for, cut evenly; up to MAX_ROWS rows,
// fewer where the staged tile would pass SMEM_CAP (stride 2), cut evenly.
TileGeom tile_geom(const Geom& g, int vec) {
  TileGeom t{};
  t.B = g.B, t.H = g.H, t.W = g.W, t.C = g.C, t.Ho = g.Ho, t.Wo = g.Wo;
  t.ph = g.ph, t.pw = g.pw;
  const int s = g.sh;
  t.nv = g.C / vec;
  t.cv = even(t.nv, MAX_SLAB);
  t.slabs = (t.nv + t.cv - 1) / t.cv;
  t.tw = even(g.Wo, TL_THREADS / t.cv);
  for (t.rt = g.Ho < MAX_ROWS ? g.Ho : MAX_ROWS;
       t.rt > 1 && tile_bytes(t, s) > SMEM_CAP; --t.rt) {
  }
  t.rt = even(g.Ho, t.rt);
  t.hr = (t.rt - 1) * s + 3;
  t.hc = (t.tw - 1) * s + 3;
  t.tiles_h = (g.Ho + t.rt - 1) / t.rt;
  t.tiles_w = (g.Wo + t.tw - 1) / t.tw;
  t.spatial = g.B * t.tiles_h * t.tiles_w;
  return t;
}

template <typename T, int S>
int launch_tiled(const void* x, const void* w, void* y, const Geom& g,
                 cudaStream_t s) {
  const TileGeom t = tile_geom(g, 16 / sizeof(T));
  const int smem = 2 * tile_bytes(t, S);
  const long long items = (long long)t.spatial * t.slabs;
  if (items > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = depthwise_tiled<T, S>;
  // per device: the SM count, once the shared-memory limit is set
  static int sms[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (sms[dev] == 0) {
    int n = 0;
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               2 * SMEM_CAP);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    sms[dev] = n;
  }
  // two blocks an SM: 256 threads of at most 128 registers, and two
  // staging buffers of at most SMEM_CAP each
  const long long resident = 2LL * sms[dev];
  const unsigned grid = (unsigned)(items < resident ? items : resident);
  kernel<<<grid, TL_THREADS, smem, s>>>(static_cast<const T*>(x),
                                        static_cast<const T*>(w),
                                        static_cast<T*>(y), t);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

int vec_of(int dtype) { return dtype == 1 ? 8 : 4; }

// The shape rule: a 3x3 kernel, one stride (1 or 2) both ways, whole
// 16-byte channel vectors, and x and w on 16-byte boundaries.
bool tiled_ok(int C, int kh, int kw, int sh, int sw, int dtype, const void* x,
              const void* w) {
  return (dtype == 0 || dtype == 1) && kh == 3 && kw == 3 && sh == sw &&
         (sh == 1 || sh == 2) && C % vec_of(dtype) == 0 && aligned16(x) &&
         aligned16(w);
}

}  // namespace

// 1: the tiled kernel runs for these arguments; 0: the per-pixel kernel.
extern "C" int ctt_depthwise_conv2d_variant(int C, int kh, int kw, int sh,
                                            int sw, int dtype, const void* x,
                                            const void* w) {
  return tiled_ok(C, kh, kw, sh, sw, dtype, x, w) ? 1 : 0;
}

// w: the OIHW weight (C, 1, kh, kw) in x's type. dtype: 0 float32, 1
// bfloat16. Returns the cudaError_t of the launch.
extern "C" int ctt_depthwise_conv2d(const void* x, const void* w, void* y,
                                    int B, int H, int W, int C, int Ho, int Wo,
                                    int kh, int kw, int sh, int sw, int ph,
                                    int pw, int dtype, void* stream) {
  if (B <= 0 || Ho <= 0 || Wo <= 0 || C <= 0 || kh <= 0 || kw <= 0 ||
      sh <= 0 || sw <= 0 || ph < 0 || pw < 0 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const Geom g{B, H, W, C, Ho, Wo, kh, kw, sh, sw, ph, pw};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tiled_ok(C, kh, kw, sh, sw, dtype, x, w)) {
    if (!aligned16(y)) return static_cast<int>(cudaErrorMisalignedAddress);
    if (dtype == 0)
      return sh == 1 ? launch_tiled<float, 1>(x, w, y, g, s)
                     : launch_tiled<float, 2>(x, w, y, g, s);
    return sh == 1 ? launch_tiled<__nv_bfloat16, 1>(x, w, y, g, s)
                   : launch_tiled<__nv_bfloat16, 2>(x, w, y, g, s);
  }
  const bool vec = C % vec_of(dtype) == 0 && aligned16(x) && aligned16(y);
  if (dtype == 0) return launch<float>(x, w, y, g, vec, s);
  return launch<__nv_bfloat16>(x, w, y, g, vec, s);
}
