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
// zero, and the OIHW weight (C, 1, kh, kw) handed over as wt (kh*kw, C). The
// taps are added in the Pallas body's order, di outer and dj inner, each
// product rounded to float32 and then added (__fmul_rn, __fadd_rn: no fused
// multiply-add), which is what the plain version's multiply-then-add does;
// so in float32 the two agree bit for bit, and in bf16, whose products are
// exact in float32, up to y's final rounding, which is the same too.
//
// What bounds it on an H100: bytes. Each output element takes kh*kw products
// (18 operations at 3x3) against reading its input once and writing itself
// once; at MobileNet v1's nine shapes at batch 64 in bf16 that is about
// 0.19 ms at 3.35 TB/s against 0.02 ms of float32 arithmetic. So each thread
// owns one output pixel and one 16-byte vector of channels (8 bf16 or 4
// float32), neighbouring threads on neighbouring channels and then
// neighbouring pixels, so that every load and store is a full 16 bytes and
// the overlapping windows of neighbouring pixels hit L1 and L2 rather than
// device memory. A channel count that is not a multiple of the vector, or an
// unaligned pointer, takes the same kernel one channel per thread. Offsets
// are 32-bit: the wrapper checks that x and y hold fewer than 2^31 elements.
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

constexpr int THREADS = 256;

template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS)
    depthwise_conv2d_kernel(const T* __restrict__ x, const T* __restrict__ wt,
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
      const Pack<T, VEC> wv = *reinterpret_cast<const Pack<T, VEC>*>(
          wt + (di * g.kw + dj) * g.C + c);
#pragma unroll
      for (int v = 0; v < VEC; ++v)
        acc[v] = __fadd_rn(acc[v],
                           __fmul_rn(to_f32(xv.v[v]), to_f32(wv.v[v])));
    }
  }
  Pack<T, VEC> out;
#pragma unroll
  for (int v = 0; v < VEC; ++v) out.v[v] = from_f32<T>(acc[v]);
  *reinterpret_cast<Pack<T, VEC>*>(y + i * VEC) = out;
}

template <typename T>
int launch(const void* x, const void* wt, void* y, Geom g, cudaStream_t s) {
  constexpr int VEC = 16 / sizeof(T);
  const auto aligned = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
  };
  const bool vec = g.C % VEC == 0 && aligned(x) && aligned(wt) && aligned(y);
  const long long total =
      (long long)g.B * g.Ho * g.Wo * (vec ? g.C / VEC : g.C);
  const unsigned blocks = (unsigned)((total + THREADS - 1) / THREADS);
  const auto* xt = static_cast<const T*>(x);
  const auto* wtt = static_cast<const T*>(wt);
  auto* yt = static_cast<T*>(y);
  if (vec)
    depthwise_conv2d_kernel<T, VEC><<<blocks, THREADS, 0, s>>>(xt, wtt, yt, g);
  else
    depthwise_conv2d_kernel<T, 1><<<blocks, THREADS, 0, s>>>(xt, wtt, yt, g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. Returns the cudaError_t of the launch.
extern "C" int ctt_depthwise_conv2d(const void* x, const void* wt, void* y,
                                    int B, int H, int W, int C, int Ho, int Wo,
                                    int kh, int kw, int sh, int sw, int ph,
                                    int pw, int dtype, void* stream) {
  if (B <= 0 || Ho <= 0 || Wo <= 0 || C <= 0 || kh <= 0 || kw <= 0 ||
      sh <= 0 || sw <= 0 || ph < 0 || pw < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Geom g{B, H, W, C, Ho, Wo, kh, kw, sh, sw, ph, pw};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, wt, y, g, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, wt, y, g, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
