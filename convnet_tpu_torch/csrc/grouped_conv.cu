// Grouped k x k convolution on NHWC for Hopper (sm_90a), cin == cout == C.
//
// Replaces the Pallas TPU kernel `_build_fwd.body` behind `grouped_conv_pallas`
// in convnet_tpu/ops/pallas/grouped.py (pallas_call at line 83). It computes
//
//   y[b, i, j, g*cg + o] = sum over taps (di, dj), then c < cg, of
//       xpad[b, i*sh + di, j*sw + dj, g*cg + c] * w[g*cg + o, c, di, dj]
//
// with x (B, H, W, C) and y (B, Ho, Wo, C) NHWC, the zero padding read as
// zero, w the OIHW grouped weight (C, cg, kh, kw) and t = di*kw + dj. Sums
// are float32 and y is written once in x's type. The TPU kernel's 128-lane
// tiles multiply 128/cg-fold zeros; the tensor-core kernel below keeps its
// block-diagonal idea at the mma's 16x16 size, so at most 8x (cg 2).
//
// What bounds it on an H100: bytes. ResNeXt-50's stride-1 3x3 grouped convs
// do about 1.85 GFLOP each at batch 64 (9*cg products per output), 24 GFLOP
// per forward, against 0.185 ms to move x and y once in bf16. On the CUDA
// cores the products alone take 0.36 ms at the float32 FMA peak; on the
// tensor cores, even with the zeros of the block-diagonal tiles below (4x
// the products at cg 4, 2x at cg 8), about 0.05 ms. So bf16 runs on the
// tensor cores and the design is about bytes.
//
// Two kernels, picked by a stated shape rule (`tensor_core_ok`), never on
// failure:
//
// * Tensor cores (bf16; C % 64 == 0; cg divides 16 or is 32, 64 or 128; x
//   16-byte aligned): every shape that grouped_conv.supported admits. An
//   implicit GEMM per tap on mma.sync m16n8k16 (bf16 in, float32 sums). The
//   channels are cut into blocks of WB = max(16, cg): where cg < 16 the
//   16/cg groups of a block share one block-diagonal 16x16 weight tile per
//   tap (the TPU kernel's block-diagonal idea at the mma's size), where
//   cg >= 16 a block is one group and its tile is dense. The weight comes
//   packed from Python as wp (kh*kw, C/WB, WB out, WB in), built once per
//   weight version. A work item is a tile of at most 224 output pixels
//   (whole rows where the image is narrow, several whole images where they
//   are small) and 64 output channels. A persistent grid of 8-warp blocks,
//   two an SM, walks the items; a block stages an item's haloed input, for
//   the input channels its 64 outputs read, into shared memory once with
//   cp.async (zero-filled in the padding, rows padded by 16 bytes so
//   ldmatrix reads no bank twice), into one of two buffers, so the copies
//   of its next item fly while it computes this one. Each warp walks the
//   taps: its B fragments come from the packed tiles
//   through L1 (a few KB, shared by the block), its A fragments from the
//   staged tile through ldmatrix at the tap's shift, so the im2col matrix
//   never exists. Any stride and padding: a pixel's
//   row address is (r*sh + di, c*sw + dj) in the halo. y is written once:
//   a quad of lanes swaps its accumulators so that each lane stores 16
//   bytes of 8 neighbouring channels.
// * CUDA cores (float32, where tensor cores would round the products to
//   TF32; and bf16 shapes outside the rule, such as cg = 3): the first
//   design, kept. A block is 32 output channels (threadIdx.x) by 8 strips of
//   4 output columns (threadIdx.y); each thread runs scalar fmaf over cg
//   inputs per tap, with the transposed weight wt (kh*kw, cg, C): wt[(t*cg +
//   c)*C + co] = w[co, c, di, dj]. Each tap's sum over c is taken apart in
//   float32 and then added to the output's sum, taps in order.
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
  int B, H, W, C, Ho, Wo, kh, kw, sh, sw, ph, pw, cg;
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

constexpr int LANES = 32;   // output channels per block
constexpr int STRIPS = 8;   // strips of output columns per block
constexpr int P = 4;        // output columns per strip

template <typename T, int VEC>
__global__ void __launch_bounds__(LANES * STRIPS)
    grouped_conv2d_kernel(const T* __restrict__ x, const T* __restrict__ wt,
                          T* __restrict__ y, Geom g, int chunks,
                          int strips_per_row) {
  const int chunk = blockIdx.x % chunks;  // channel chunks run side by side
  const int co = chunk * LANES + threadIdx.x;
  const int strip = (blockIdx.x / chunks) * STRIPS + threadIdx.y;
  if (co >= g.C || strip >= g.B * g.Ho * strips_per_row) return;
  const int ow0 = (strip % strips_per_row) * P;
  const int r = strip / strips_per_row;
  const int oh = r % g.Ho;
  const int b = r / g.Ho;
  const int cin0 = (co / g.cg) * g.cg;  // the first input channel of co's group

  float acc[P];
#pragma unroll
  for (int p = 0; p < P; ++p) acc[p] = 0.0f;

  for (int di = 0; di < g.kh; ++di) {
    const int ih = oh * g.sh - g.ph + di;
    if (ih < 0 || ih >= g.H) continue;  // a padded row adds zero
    const T* xrow = x + (b * g.H + ih) * g.W * g.C + cin0;
    for (int dj = 0; dj < g.kw; ++dj) {
      const T* wtap = wt + (di * g.kw + dj) * g.cg * g.C + co;
      int off[P];  // x offset of each column's tap, or -1 in the padding
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const int iw = (ow0 + p) * g.sw - g.pw + dj;
        off[p] = (ow0 + p < g.Wo && iw >= 0 && iw < g.W) ? iw * g.C : -1;
      }
      float part[P];
#pragma unroll
      for (int p = 0; p < P; ++p) part[p] = 0.0f;
      for (int c = 0; c < g.cg; c += VEC) {
        float wv[VEC];
#pragma unroll
        for (int v = 0; v < VEC; ++v) wv[v] = to_f32(wtap[(c + v) * g.C]);
#pragma unroll
        for (int p = 0; p < P; ++p) {
          if (off[p] < 0) continue;
          const Pack<T, VEC> xv =
              *reinterpret_cast<const Pack<T, VEC>*>(xrow + off[p] + c);
#pragma unroll
          for (int v = 0; v < VEC; ++v)
            part[p] = fmaf(to_f32(xv.v[v]), wv[v], part[p]);
        }
      }
#pragma unroll
      for (int p = 0; p < P; ++p) acc[p] += part[p];
    }
  }
  T* yrow = y + ((b * g.Ho + oh) * g.Wo + ow0) * g.C + co;
#pragma unroll
  for (int p = 0; p < P; ++p)
    if (ow0 + p < g.Wo) yrow[p * g.C] = from_f32<T>(acc[p]);
}

template <typename T>
int launch(const void* x, const void* wt, void* y, Geom g, cudaStream_t s) {
  const int strips_per_row = (g.Wo + P - 1) / P;
  const int chunks = (g.C + LANES - 1) / LANES;
  const long long strips = (long long)g.B * g.Ho * strips_per_row;
  const long long blocks = chunks * ((strips + STRIPS - 1) / STRIPS);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(LANES, STRIPS);
  const auto* xt = static_cast<const T*>(x);
  const auto* wtt = static_cast<const T*>(wt);
  auto* yt = static_cast<T*>(y);
  // 4-channel vectors need whole vectors per group and an aligned x
  const bool vec = g.cg % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(x) % (4 * sizeof(T))) == 0;
  if (vec)
    grouped_conv2d_kernel<T, 4><<<(unsigned)blocks, block, 0, s>>>(
        xt, wtt, yt, g, chunks, strips_per_row);
  else
    grouped_conv2d_kernel<T, 1><<<(unsigned)blocks, block, 0, s>>>(
        xt, wtt, yt, g, chunks, strips_per_row);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------- tensor-core kernel

constexpr int TC_WARPS = 8;
constexpr int TC_THREADS = 32 * TC_WARPS;
constexpr int NB = 64;                 // output channels per block
constexpr int MAX_PIX = 224;           // output pixels per tile: 14 m16 tiles
constexpr int SMEM_CAP = 55 * 1024;    // a staged tile: 2 buffers, 2 blocks an SM
constexpr int SMEM_MAX = 227 * 1024;   // what a block can have at all

struct TcGeom {
  int B, H, W, C, Ho, Wo, kh, kw, sh, sw, ph, pw;
  int th, tw, ti;        // output tile: rows, columns, images
  int hh, hw;            // one image's haloed input: rows, columns
  int tiles_h, tiles_w;  // tiles per image
  int spatial, chunks;   // tiles over all images; channel chunks of NB
};

template <int WB>
struct TcShape {
  static constexpr int CIN = WB > NB ? WB : NB;  // input channels staged
  static constexpr int PS = CIN + 8;              // staged pixel stride
  static constexpr int NW = WB == 16 ? 16 : 32;   // output channels a warp
  static constexpr int NSUB = NB / NW;            // warps across channels
  static constexpr int MQ = TC_WARPS / NSUB;      // warps across pixels
  static constexpr int MT = (MAX_PIX / 16 + MQ - 1) / MQ;  // m16 tiles a warp
  static constexpr int KSTEPS = WB / 16;
};

__device__ __forceinline__ void cp_async16(uint32_t smem, const void* gmem,
                                           bool valid) {
  const int src_bytes = valid ? 16 : 0;  // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// s[i] for a lane-dependent i in 0..3, by selects rather than local memory
__device__ __forceinline__ uint32_t pick(const uint32_t (&s)[4], int i) {
  return i == 0 ? s[0] : i == 1 ? s[1] : i == 2 ? s[2] : s[3];
}

// Starts the cp.async copies of work item u's haloed input into dst: ti
// images of hh x hw pixels x CIN channels, zeros outside the images.
template <int CIN>
__device__ __forceinline__ void stage_tile(const __nv_bfloat16* __restrict__ x,
                                           uint32_t dst, const TcGeom& g,
                                           int u) {
  constexpr int PS = CIN + 8, CHUNKS = CIN / 8;
  int sp = u % g.spatial;
  const int n0 = (u / g.spatial) * NB;
  const int cin0 = n0 / CIN * CIN;
  const int tx = sp % g.tiles_w;
  sp /= g.tiles_w;
  const int ty = sp % g.tiles_h;
  const int b0 = sp / g.tiles_h * g.ti;
  const int ih0 = ty * g.th * g.sh - g.ph, iw0 = tx * g.tw * g.sw - g.pw;
  // each thread copies one 16-byte chunk of every STEP-th pixel, stepping
  // its (image, row, column) forward rather than dividing
  constexpr int STEP = TC_THREADS / CHUNKS;
  const int ch = (threadIdx.x % CHUNKS) * 8;
  const int npix = g.ti * g.hh * g.hw;
  int pix = threadIdx.x / CHUNKS;
  int c = pix % g.hw, r = pix / g.hw % g.hh, img = pix / (g.hh * g.hw);
  for (; pix < npix; pix += STEP) {
    const int ih = ih0 + r, iw = iw0 + c;
    const bool valid = b0 + img < g.B && ih >= 0 && ih < g.H && iw >= 0 &&
                       iw < g.W;
    const __nv_bfloat16* src =
        valid ? x + ((size_t)((b0 + img) * g.H + ih) * g.W + iw) * g.C +
                    cin0 + ch
              : x;
    cp_async16(dst + (pix * PS + ch) * 2, src, valid);
    for (c += STEP; c >= g.hw; c -= g.hw)
      if (++r == g.hh) {
        r = 0;
        ++img;
      }
  }
}

// A persistent grid walks the work items u = chunk * spatial + tile (tiles
// fastest, so the blocks running together share halos and weights in L2);
// each block double-buffers its staged input, so the copies of its next item
// fly while it computes this one.
template <int WB>
__global__ void __launch_bounds__(TC_THREADS, 2)
    grouped_conv2d_tc(const __nv_bfloat16* __restrict__ x,
                      const __nv_bfloat16* __restrict__ wp,
                      __nv_bfloat16* __restrict__ y, TcGeom g) {
  using S = TcShape<WB>;
  extern __shared__ __align__(16) __nv_bfloat16 xs[];  // 2 x (ti*hh*hw, PS)
  const uint32_t xs_base = static_cast<uint32_t>(__cvta_generic_to_shared(xs));
  const uint32_t buf_bytes = g.ti * g.hh * g.hw * S::PS * 2;
  const int items = g.spatial * g.chunks;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane >> 2, tq = lane & 3;    // mma groupID, thread in group
  const int ns = warp % S::NSUB, mq = warp / S::NSUB;
  const int tpix = g.th * g.tw;               // pixels of one image's tile
  const int npix = g.ti * tpix;
  const int mtiles = (npix + 15) / 16;
  const int nwb = g.C / WB;

  // Each lane's ldmatrix row: pixel mi*16 + lane%16 of the tile, at its
  // halo position for tap (0, 0); inputs 0-7 or 8-15 of a k step (lane/16).
  int pbase[S::MT];
#pragma unroll
  for (int q = 0; q < S::MT; ++q) {
    int p = (mq + S::MQ * q) * 16 + (lane & 15);
    if (p >= npix) p = 0;  // a slot past the tile reads pixel 0, never stored
    const int img = p / tpix, r = p % tpix / g.tw, c = p % g.tw;
    pbase[q] = (img * g.hh + r * g.sh) * g.hw + c * g.sw;
  }

  int u = blockIdx.x;
  if (u < items) stage_tile<S::CIN>(x, xs_base, g, u);
  asm volatile("cp.async.commit_group;\n" ::);
  for (int it = 0; u < items; u += gridDim.x, ++it) {
    const uint32_t buf = xs_base + (it & 1) * buf_bytes;
    if (u + (int)gridDim.x < items)
      stage_tile<S::CIN>(x, xs_base + ((it + 1) & 1) * buf_bytes, g,
                         u + gridDim.x);
    asm volatile("cp.async.commit_group;\n" ::);  // possibly empty
    asm volatile("cp.async.wait_group 1;\n" ::);  // item u has landed
    __syncthreads();

    int sp = u % g.spatial;
    const int n0 = (u / g.spatial) * NB;      // the item's first output
    const int cin0 = n0 / S::CIN * S::CIN;    // its first staged input
    const int tx = sp % g.tiles_w;
    sp /= g.tiles_w;
    const int ty = sp % g.tiles_h;
    const int b0 = sp / g.tiles_h * g.ti;
    const int oh0 = ty * g.th, ow0 = tx * g.tw;
    const int nw0 = n0 + ns * S::NW;          // the warp's first output
    const int wb = nw0 / WB;                  // its channel block
    const int o_off = nw0 - wb * WB;          // its first output in the block
    const uint32_t a_lane = buf + (wb * WB - cin0 + (lane >> 4) * 8) * 2;

    float acc[S::MT][S::NW / 8][4];
#pragma unroll
    for (int q = 0; q < S::MT; ++q)
#pragma unroll
      for (int j = 0; j < S::NW / 8; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[q][j][c] = 0.0f;

    for (int di = 0; di < g.kh; ++di) {
      for (int dj = 0; dj < g.kw; ++dj) {
        const int shift = di * g.hw + dj;
        const __nv_bfloat16* wtap =
            wp + ((size_t)((di * g.kw + dj) * nwb + wb) * WB + o_off) * WB;
#pragma unroll
        for (int ks = 0; ks < S::KSTEPS; ++ks) {
          // B (k16 x n8, "col"): outputs 8j + gq, inputs 2tq and 2tq + 8
          uint32_t bf[S::NW / 8][2];
#pragma unroll
          for (int j = 0; j < S::NW / 8; ++j) {
            const auto* p = reinterpret_cast<const unsigned int*>(
                wtap + (j * 8 + gq) * WB + ks * 16 + 2 * tq);
            bf[j][0] = __ldg(p);
            bf[j][1] = __ldg(p + 4);
          }
#pragma unroll
          for (int q = 0; q < S::MT; ++q) {
            if (mq + S::MQ * q < mtiles) {
              uint32_t a[4];
              ldmatrix_x4(a,
                          a_lane + ((pbase[q] + shift) * S::PS + ks * 16) * 2);
#pragma unroll
              for (int j = 0; j < S::NW / 8; ++j)
                mma_16816(acc[q][j], a, bf[j][0], bf[j][1]);
            }
          }
        }
      }
    }

    // Write y once. A quad's lanes hold columns 2tq, 2tq + 1 of each n8
    // tile in rows gq and gq + 8; three xor shuffles give lane tq item tq of
    // a set of four (row gq + 8 (tq >> 1), n8 tile 2s + (tq & 1)) whole: 8
    // channels, one 16-byte store.
#pragma unroll
    for (int q = 0; q < S::MT; ++q) {
      const int mi = mq + S::MQ * q;
      if (mi >= mtiles) break;  // uniform across the warp
#pragma unroll
      for (int s = 0; s < S::NW / 16; ++s) {
        uint32_t v[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int h = i >> 1, j = 2 * s + (i & 1);
          v[i] = pack_bf16(acc[q][j][2 * h], acc[q][j][2 * h + 1]);
        }
        const uint32_t r1 = __shfl_xor_sync(0xffffffffu, pick(v, tq ^ 1), 1);
        const uint32_t r2 = __shfl_xor_sync(0xffffffffu, pick(v, tq ^ 2), 2);
        const uint32_t r3 = __shfl_xor_sync(0xffffffffu, pick(v, tq ^ 3), 3);
        uint32_t o[4];  // o[k]: columns 2k, 2k + 1, from lane k of the quad
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int r = k ^ tq;
          o[k] = r == 0 ? v[k] : r == 1 ? r1 : r == 2 ? r2 : r3;
        }
        const int p = mi * 16 + gq + 8 * (tq >> 1);
        if (p < npix) {
          const int b = b0 + p / tpix;
          const int oh = oh0 + p % tpix / g.tw, ow = ow0 + p % g.tw;
          if (b < g.B && oh < g.Ho && ow < g.Wo) {
            const int j = 2 * s + (tq & 1);
            *reinterpret_cast<uint4*>(
                y + ((size_t)(b * g.Ho + oh) * g.Wo + ow) * g.C + nw0 + 8 * j) =
                make_uint4(o[0], o[1], o[2], o[3]);
          }
        }
      }
    }
    __syncthreads();  // every warp is done with buf before it is refilled
  }
}

// One staging buffer's bytes.
int tc_smem_bytes(const TcGeom& t, int cin) {
  return t.ti * t.hh * t.hw * (cin + 8) * 2;
}

// The output tile: whole rows where Wo <= 64, at most MAX_PIX pixels, cut
// evenly; several whole images where they are that small; shrunk until the
// haloed input fits SMEM_CAP.
TcGeom tc_geom(const Geom& g, int cin) {
  TcGeom t{g.B, g.H, g.W, g.C, g.Ho, g.Wo, g.kh, g.kw, g.sh, g.sw, g.ph, g.pw,
           0, 0, 1, 0, 0, 0, 0, 0, 0};
  auto even = [](int n, int most) {
    const int parts = (n + most - 1) / most;
    return (n + parts - 1) / parts;
  };
  t.tw = even(g.Wo, 64);
  t.th = even(g.Ho, MAX_PIX / t.tw > 1 ? MAX_PIX / t.tw : 1);
  if (t.th == g.Ho && t.tw == g.Wo) {
    const int fit = MAX_PIX / (g.Ho * g.Wo);
    t.ti = fit < 1 ? 1 : fit < g.B ? fit : g.B;
  }
  for (;;) {
    t.hh = (t.th - 1) * g.sh + g.kh;
    t.hw = (t.tw - 1) * g.sw + g.kw;
    if (tc_smem_bytes(t, cin) <= SMEM_CAP || (t.th == 1 && t.tw == 1 &&
                                              t.ti == 1))
      break;
    if (t.ti > 1)
      t.ti = (t.ti + 1) / 2;
    else if (t.th > 1)
      t.th = (t.th + 1) / 2;
    else
      t.tw = (t.tw + 1) / 2;
  }
  t.tiles_h = (g.Ho + t.th - 1) / t.th;
  t.tiles_w = (g.Wo + t.tw - 1) / t.tw;
  t.spatial = (g.B + t.ti - 1) / t.ti * t.tiles_h * t.tiles_w;
  t.chunks = g.C / NB;
  return t;
}

template <int WB>
int launch_tc(const void* x, const void* wp, void* y, const Geom& g,
              cudaStream_t s) {
  using S = TcShape<WB>;
  const TcGeom t = tc_geom(g, S::CIN);
  const int smem = 2 * tc_smem_bytes(t, S::CIN);
  if (smem > SMEM_MAX || (long long)t.spatial * t.chunks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = grouped_conv2d_tc<WB>;
  // per device: the SM count, once the shared-memory limit is set
  static int sms[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (sms[dev] == 0) {
    int n = 0;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    sms[dev] = n;
  }
  // two blocks an SM: 256 threads of at most 128 registers, and two
  // staging buffers of at most SMEM_CAP each
  const long long items = (long long)t.spatial * t.chunks;
  const long long resident = 2LL * sms[dev];
  const unsigned grid = (unsigned)(items < resident ? items : resident);
  kernel<<<grid, TC_THREADS, smem, s>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(wp), static_cast<__nv_bfloat16*>(y),
      t);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// The shape rule: bf16 (tensor cores have no float32 product: TF32 would
// round it), whole 64-channel blocks, a channel block width max(16, cg) that
// is instantiated, and 16-byte rows.
bool tensor_core_ok(int C, int cg, int dtype, const void* x) {
  const bool width = (cg > 0 && 16 % cg == 0) || cg == 32 || cg == 64 ||
                     cg == 128;
  return dtype == 1 && C % NB == 0 && width && aligned16(x);
}

}  // namespace

// 1: the tensor-core kernel runs for these arguments, with wt the packed
// tiles (kh*kw, C/WB, WB, WB), WB = max(16, cg); 0: the CUDA-core kernel,
// with wt (kh*kw, cg, C).
extern "C" int ctt_grouped_conv2d_variant(int C, int cg, int dtype,
                                          const void* x) {
  return tensor_core_ok(C, cg, dtype, x) ? 1 : 0;
}

// dtype: 0 float32, 1 bfloat16. wt in the layout that
// ctt_grouped_conv2d_variant names. Returns the cudaError_t of the launch.
extern "C" int ctt_grouped_conv2d(const void* x, const void* wt, void* y,
                                  int B, int H, int W, int C, int Ho, int Wo,
                                  int kh, int kw, int sh, int sw, int ph,
                                  int pw, int cg, int dtype, void* stream) {
  if (B <= 0 || Ho <= 0 || Wo <= 0 || C <= 0 || cg <= 0 || C % cg != 0 ||
      kh <= 0 || kw <= 0 || sh <= 0 || sw <= 0 || ph < 0 || pw < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Geom g{B, H, W, C, Ho, Wo, kh, kw, sh, sw, ph, pw, cg};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tensor_core_ok(C, cg, dtype, x)) {
    if (!aligned16(y)) return static_cast<int>(cudaErrorMisalignedAddress);
    if (cg <= 16) return launch_tc<16>(x, wt, y, g, s);
    if (cg == 32) return launch_tc<32>(x, wt, y, g, s);
    if (cg == 64) return launch_tc<64>(x, wt, y, g, s);
    return launch_tc<128>(x, wt, y, g, s);
  }
  if (dtype == 0) return launch<float>(x, wt, y, g, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, wt, y, g, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
