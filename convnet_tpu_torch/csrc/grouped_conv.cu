// Grouped k x k convolution on NHWC for Hopper (sm_90a), cin == cout == C.
//
// Replaces the Pallas TPU kernel `_build_fwd.body` behind `grouped_conv_pallas`
// in convnet_tpu/ops/pallas/grouped.py (pallas_call at line 83). It computes
//
//   y[b, i, j, g*cg + o] = sum over taps (di, dj), then c < cg, of
//       xpad[b, i*sh + di, j*sw + dj, g*cg + c] * w[g*cg + o, c, di, dj]
//
// with x (B, H, W, C) and y (B, Ho, Wo, C) NHWC, the zero padding read as
// zero, and the OIHW grouped weight (C, cg, kh, kw) handed over transposed
// to wt (kh*kw, cg, C): wt[(t*cg + c)*C + co] = w[co, c, di, dj], t = di*kw + dj.
// Each tap's sum over c is taken apart in float32 and then added to the
// output's float32 sum, taps in order (di outer, dj inner), which is the
// plain version's order; y is written once in x's type. The TPU kernel's
// 128-lane tiles and block-diagonal dense weights are Mosaic artifacts: this
// kernel computes only the grouped products, none of the 128/cg-fold
// zeros those tiles multiply.
//
// What bounds it on an H100: operations, on the CUDA cores. ResNeXt-50's
// stride-1 3x3 grouped convs do about 1.85 GFLOP each at batch 64 (9*cg
// products per output), 24 GFLOP per forward: 0.36 ms at the 67 TFLOP/s
// float32 FMA peak, against 0.18 ms to move x and y once in bf16. So a
// CUDA-core kernel sits above the bytes bound by construction; tensor cores
// (mma.sync per group, depth 9*cg = 36 to 288) are the later fix.
//
// Design, simple first: a block is 32 output channels (threadIdx.x, so a
// warp writes 32 neighbouring channels and reads their groups' neighbouring
// inputs) by 8 strips of 4 output columns (threadIdx.y). A thread keeps its
// channel's 4 outputs in registers and reuses each weight it loads for the
// 4 columns; weights are read in the transposed layout so a warp's loads
// are coalesced, and x is read through L1 as 4-channel vectors where
// cg % 4 == 0, otherwise one channel at a time. Offsets are 32-bit: the
// wrapper checks that x and y hold fewer than 2^31 elements.
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

}  // namespace

// dtype: 0 float32, 1 bfloat16. Returns the cudaError_t of the launch.
extern "C" int ctt_grouped_conv2d(const void* x, const void* wt, void* y,
                                  int B, int H, int W, int C, int Ho, int Wo,
                                  int kh, int kw, int sh, int sw, int ph,
                                  int pw, int cg, int dtype, void* stream) {
  if (B <= 0 || Ho <= 0 || Wo <= 0 || C <= 0 || cg <= 0 || C % cg != 0 ||
      kh <= 0 || kw <= 0 || sh <= 0 || sw <= 0 || ph < 0 || pw < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Geom g{B, H, W, C, Ho, Wo, kh, kw, sh, sw, ph, pw, cg};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, wt, y, g, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, wt, y, g, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
