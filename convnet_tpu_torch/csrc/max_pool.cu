// Max pooling on NHWC for Hopper (sm_90a): the forward with its winning-tap
// index, and the backward that routes dy through that index.
//
// Replaces the Pallas TPU kernels of convnet_tpu/ops/pallas/pool.py
// (`fwd_body`, pallas_call at line 169; `bwd_body`, pallas_call at line 272)
// and convnet_tpu/ops/pallas/pool_bwd.py (`_bwd_kernel`, pallas_call at line
// 120), together with the XLA forward they pair with (`_mp_fwd_argmax` in
// convnet_tpu/ops/pool.py). Semantics are `_mp_fwd_argmax`'s:
//
//   * taps are visited in the order t = di * kw + dj; a tap that falls in the
//     padding reads -inf, so padding never wins;
//   * tap 0 initialises the window, a later tap replaces it only if it is
//     strictly greater (comparison in float32): ties go to the first match;
//   * the index is one uint8 per output element (kh * kw <= 255).
//
// The backward is a gather, not a scatter: one thread owns an input pixel
// and a vector of channels, visits the at most ceil(kh/sh) * ceil(kw/sw)
// windows that cover it and adds dy wherever idx equals the tap through which
// that window sees the pixel. The windows covering input row ih are
//   oh in [ceil((ih + ph - kh + 1) / sh), floor((ih + ph) / sh)] ∩ [0, Ho)
// and likewise for columns. Contributions are added in float32 in ascending
// tap order (the order of the plain version, and of `_mp_bwd_padsum` and
// `_bwd_kernel`), and dx is written once in x's type: no atomics, no memset,
// the same bits on every run.
//
// What bounds them on an H100: bytes. The forward reads x and writes y and
// the index; the backward reads dy and the index and writes dx. At the
// ResNet-50 stem at batch 128 in bf16 either moves about 283 MB, 84 us at
// 3.35 TB/s, against a few hundred million compares. So each thread moves 16
// bytes per access (8 bf16 or 4 float32 channels) with neighbouring threads
// on neighbouring channels, and the overlapping window reads of the forward
// hit L1/L2. A channel count that is not a multiple of the vector width (or
// an unaligned pointer) takes the same kernel with one channel per thread.
//
// Plain C interface, no PyTorch headers: built with nvcc into a shared
// library and called through ctypes (convnet_tpu_torch/ops/kernels).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

struct Geom {
  int B, H, W, C, Ho, Wo, kh, kw, sh, sw, ph, pw;
};

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

template <int VEC>
struct alignas(VEC) IdxPack {
  uint8_t v[VEC];
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

// Index: int where every tensor has fewer than 2^30 elements, so that the
// grid-stride step cannot overflow it (64-bit division costs several times
// more), long long otherwise.
template <typename T, int VEC, typename Index>
__global__ void __launch_bounds__(THREADS)
    max_pool2d_fwd_idx_kernel(const T* __restrict__ x, T* __restrict__ y,
                              uint8_t* __restrict__ idx, Geom g) {
  const int cv = g.C / VEC;
  const Index total = (Index)g.B * g.Ho * g.Wo * cv;
  for (Index i = (Index)blockIdx.x * THREADS + threadIdx.x; i < total;
       i += (Index)gridDim.x * THREADS) {
    const int c = (int)(i % cv) * VEC;
    Index r = i / cv;
    const int ow = (int)(r % g.Wo);
    r /= g.Wo;
    const int oh = (int)(r % g.Ho);
    const int b = (int)(r / g.Ho);

    float best[VEC];
    uint8_t arg[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      best[k] = -INFINITY;
      arg[k] = 0;
    }
    for (int di = 0; di < g.kh; ++di) {
      const int ih = oh * g.sh - g.ph + di;
      if (ih < 0 || ih >= g.H) continue;  // padding: -inf never wins
      for (int dj = 0; dj < g.kw; ++dj) {
        const int iw = ow * g.sw - g.pw + dj;
        if (iw < 0 || iw >= g.W) continue;
        const uint8_t t = (uint8_t)(di * g.kw + dj);
        const Pack<T, VEC> p = *reinterpret_cast<const Pack<T, VEC>*>(
            x + (((Index)b * g.H + ih) * g.W + iw) * g.C + c);
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          const float v = to_f32(p.v[k]);
          // tap 0 initialises the window even when it holds -inf or NaN,
          // as `_mp_fwd_argmax` does; a padded tap 0 leaves -inf and 0
          if (t == 0 || v > best[k]) {
            best[k] = v;
            arg[k] = t;
          }
        }
      }
    }
    const Index o = (((Index)b * g.Ho + oh) * g.Wo + ow) * g.C + c;
    Pack<T, VEC> out;
#pragma unroll
    for (int k = 0; k < VEC; ++k) out.v[k] = from_f32<T>(best[k]);
    *reinterpret_cast<Pack<T, VEC>*>(y + o) = out;
    if (idx != nullptr) {
      IdxPack<VEC> ip;
#pragma unroll
      for (int k = 0; k < VEC; ++k) ip.v[k] = arg[k];
      *reinterpret_cast<IdxPack<VEC>*>(idx + o) = ip;
    }
  }
}

template <typename T, int VEC, typename Index>
__global__ void __launch_bounds__(THREADS)
    max_pool2d_bwd_kernel(const T* __restrict__ dy,
                          const uint8_t* __restrict__ idx,
                          T* __restrict__ dx, Geom g) {
  const int cv = g.C / VEC;
  const Index total = (Index)g.B * g.H * g.W * cv;
  for (Index i = (Index)blockIdx.x * THREADS + threadIdx.x; i < total;
       i += (Index)gridDim.x * THREADS) {
    const int c = (int)(i % cv) * VEC;
    Index r = i / cv;
    const int iw = (int)(r % g.W);
    r /= g.W;
    const int ih = (int)(r % g.H);
    const int b = (int)(r / g.H);

    // windows oh with oh*sh - ph <= ih <= oh*sh - ph + kh - 1
    const int nh = ih + g.ph - g.kh + 1;
    const int oh_lo = nh <= 0 ? 0 : (nh + g.sh - 1) / g.sh;
    const int oh_hi = min((ih + g.ph) / g.sh, g.Ho - 1);
    const int nw = iw + g.pw - g.kw + 1;
    const int ow_lo = nw <= 0 ? 0 : (nw + g.sw - 1) / g.sw;
    const int ow_hi = min((iw + g.pw) / g.sw, g.Wo - 1);

    float acc[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[k] = 0.0f;
    // descending oh is ascending di, descending ow ascending dj: taps in
    // ascending t, the plain version's order of addition
    for (int oh = oh_hi; oh >= oh_lo; --oh) {
      const int di = ih + g.ph - oh * g.sh;
      for (int ow = ow_hi; ow >= ow_lo; --ow) {
        const int dj = iw + g.pw - ow * g.sw;
        const uint8_t t = (uint8_t)(di * g.kw + dj);
        const Index o = (((Index)b * g.Ho + oh) * g.Wo + ow) * g.C + c;
        // both loads issue together: a dy load that waited on the index
        // would double the latency each window costs
        const IdxPack<VEC> ip = *reinterpret_cast<const IdxPack<VEC>*>(idx + o);
        const Pack<T, VEC> d = *reinterpret_cast<const Pack<T, VEC>*>(dy + o);
#pragma unroll
        for (int k = 0; k < VEC; ++k)
          if (ip.v[k] == t) acc[k] += to_f32(d.v[k]);
      }
    }
    Pack<T, VEC> out;
#pragma unroll
    for (int k = 0; k < VEC; ++k) out.v[k] = from_f32<T>(acc[k]);
    *reinterpret_cast<Pack<T, VEC>*>(
        dx + (((Index)b * g.H + ih) * g.W + iw) * g.C + c) = out;
  }
}

bool aligned(const void* p, int bytes) {
  return (reinterpret_cast<uintptr_t>(p) % bytes) == 0;
}

int blocks_for(long long threads) {
  const long long n = (threads + THREADS - 1) / THREADS;
  return (int)(n < (1 << 20) ? n : (1 << 20));  // grid-stride beyond this
}

bool valid(const Geom& g) {
  return g.B > 0 && g.H > 0 && g.W > 0 && g.C > 0 && g.kh > 0 && g.kw > 0 &&
         g.kh * g.kw <= 255 && g.sh > 0 && g.sw > 0 && g.sh <= g.kh &&
         g.sw <= g.kw && g.ph >= 0 && g.pw >= 0 && g.ph < g.kh &&
         g.pw < g.kw && g.Ho == (g.H + 2 * g.ph - g.kh) / g.sh + 1 &&
         g.Wo == (g.W + 2 * g.pw - g.kw) / g.sw + 1 && g.Ho > 0 && g.Wo > 0;
}

bool small(const Geom& g) {
  return (long long)g.B * g.H * g.W * g.C < (1LL << 30) &&
         (long long)g.B * g.Ho * g.Wo * g.C < (1LL << 30);
}

template <typename T, int VEC>
void launch_fwd_vec(const void* x, void* y, void* idx, const Geom& g,
                    cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  uint8_t* it = static_cast<uint8_t*>(idx);
  const int blocks = blocks_for((long long)g.B * g.Ho * g.Wo * (g.C / VEC));
  if (small(g))
    max_pool2d_fwd_idx_kernel<T, VEC, int><<<blocks, THREADS, 0, s>>>(
        xt, yt, it, g);
  else
    max_pool2d_fwd_idx_kernel<T, VEC, long long><<<blocks, THREADS, 0, s>>>(
        xt, yt, it, g);
}

template <typename T>
void launch_fwd(const void* x, void* y, void* idx, const Geom& g,
                cudaStream_t s) {
  constexpr int VEC = 16 / sizeof(T);
  if (g.C % VEC == 0 && aligned(x, 16) && aligned(y, 16) &&
      (idx == nullptr || aligned(idx, VEC)))
    launch_fwd_vec<T, VEC>(x, y, idx, g, s);
  else
    launch_fwd_vec<T, 1>(x, y, idx, g, s);
}

template <typename T, int VEC>
void launch_bwd_vec(const void* dy, const void* idx, void* dx, const Geom& g,
                    cudaStream_t s) {
  const T* dyt = static_cast<const T*>(dy);
  const uint8_t* it = static_cast<const uint8_t*>(idx);
  T* dxt = static_cast<T*>(dx);
  const int blocks = blocks_for((long long)g.B * g.H * g.W * (g.C / VEC));
  if (small(g))
    max_pool2d_bwd_kernel<T, VEC, int><<<blocks, THREADS, 0, s>>>(
        dyt, it, dxt, g);
  else
    max_pool2d_bwd_kernel<T, VEC, long long><<<blocks, THREADS, 0, s>>>(
        dyt, it, dxt, g);
}

template <typename T>
void launch_bwd(const void* dy, const void* idx, void* dx, const Geom& g,
                cudaStream_t s) {
  constexpr int VEC = 16 / sizeof(T);
  if (g.C % VEC == 0 && aligned(dy, 16) && aligned(dx, 16) &&
      aligned(idx, VEC))
    launch_bwd_vec<T, VEC>(dy, idx, dx, g, s);
  else
    launch_bwd_vec<T, 1>(dy, idx, dx, g, s);
}

}  // namespace

// Shapes: x and dx (B, H, W, C), y, dy and idx (B, Ho, Wo, C), all
// contiguous NHWC. dtype: 0 float32, 1 bfloat16. Return value: the
// cudaError_t of the launch (cudaErrorInvalidValue for a geometry the kernels
// do not take).

// idx may be null: then only y is written (eval and serving).
extern "C" int ctt_max_pool2d_fwd_idx(const void* x, void* y, void* idx,
                                      int B, int H, int W, int C, int Ho,
                                      int Wo, int kh, int kw, int sh, int sw,
                                      int ph, int pw, int dtype,
                                      void* stream) {
  const Geom g{B, H, W, C, Ho, Wo, kh, kw, sh, sw, ph, pw};
  if (!valid(g)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    launch_fwd<float>(x, y, idx, g, s);
  else if (dtype == 1)
    launch_fwd<__nv_bfloat16>(x, y, idx, g, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ctt_max_pool2d_bwd(const void* dy, const void* idx, void* dx,
                                  int B, int H, int W, int C, int Ho, int Wo,
                                  int kh, int kw, int sh, int sw, int ph,
                                  int pw, int dtype, void* stream) {
  const Geom g{B, H, W, C, Ho, Wo, kh, kw, sh, sw, ph, pw};
  if (!valid(g) || idx == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    launch_bwd<float>(dy, idx, dx, g, s);
  else if (dtype == 1)
    launch_bwd<__nv_bfloat16>(dy, idx, dx, g, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
