// int8 pointwise conv with a quantizing prologue and a dequantizing epilogue,
// for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package computes this product with
// lax.dot outside any kernel (convnet_tpu/nn/quant.py:132-141,
// conv1x1_int8), with the quantize and the dequantize as separate XLA
// passes. It computes
//
//     q[m, k]   = clamp(rne(round_T(x[m, k] * inv)), -127, 127)     (int8)
//     out[m, n] = act(((float)(sum_k q[m, k] * wq[n, k]) * (eff * sw[n]))
//                     * scale[n] + shift[n])
//
// with x (M, K) row-major in T (bf16 or float32: an NHWC activation seen as
// (N*H*W, Cin)), wq (N, Kp) row-major int8 (the 1x1 conv's OIHW weight
// quantized per output channel, zero beyond K, Kp a multiple of 64), sw,
// scale and shift (N,) float32 (scale and shift may be null: 1 and 0), inv
// the static activation scale's inverse as a value of T, eff = 1 / inv, and
// out (M, N) row-major in T, written once. round_T rounds the product to T,
// as the reference multiplies in x's type; rne rounds half to even, as
// jnp.round and torch.round do: so q is the int8 of quantize_act bit for
// bit. The epilogue is float32 with every product and sum rounded on its
// own (no contraction), so a float32 output equals the plain version's; a
// bf16 output skips the plain version's rounding of the dequantized value
// to bf16 before scale and shift. act: 0 none, 1 relu, 2 relu6.
//
// What bounds it on an H100: int8 products run at 1,979 TOPS, twice the
// bf16 rate, so at ResNet-50's shapes (K 64 to 2048) the kernel is bound by
// the bytes of x and out, as the bf16 fused 1x1 is. The unfused chain
// (quantize pass, int8 matmul, dequantize pass) moves x, q (twice), the
// int32 sums (twice) and out; this kernel moves x and out only: it
// quantizes each x tile between its load from device memory and its store
// to shared memory, and the sums never leave registers.
//
// Design (simple first): 128x128 output tiles, one block each, N fastest so
// the blocks that share an x slab run together and read it from L2; 8 warps
// (2 x 4), each a 64x32 sub-tile of mma.sync m16n8k32 s8 x s8 -> s32 (int32
// accumulation: exact for K < 2^31 / 127^2); 64-wide K slices, double
// buffered in shared memory, the next slice's x and wq loaded into
// registers while the tensor cores work on this one. Shared rows are 80
// bytes (64 and 16 of padding), so the fragment loads of a warp hit 32
// different banks. Two instances, picked by a stated shape rule
// (ctt_matmul_int8_variant): "vector" where each row of x is whole 16-byte
// vectors (K * sizeof(T) % 16 == 0) and x is 16-byte aligned, else "scalar",
// which loads x an element at a time. Ragged M, N and K are masked: rows
// beyond M and columns beyond K quantize zeros, wq's rows beyond N load as
// zeros, and only the real outputs are stored.
//
// Plain C interface, no PyTorch headers: built with nvcc into a shared
// library and called through ctypes (convnet_tpu_torch/ops/kernels).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kActNone = 0;
constexpr int kActRelu = 1;
constexpr int kActRelu6 = 2;

constexpr int BM = 128;               // output rows per block
constexpr int BN = 128;               // output columns per block
constexpr int BK = 64;                // K slice per stage (two mma k-steps)
constexpr int LDS = BK + 16;          // shared row stride in bytes
constexpr int THREADS = 256;          // 8 warps: 2 along M, 4 along N
constexpr int CHUNK = 8;              // x elements a thread loads together
constexpr int X_CHUNKS = BM * BK / CHUNK / THREADS;   // 4 a thread
constexpr int W_CHUNKS = BN * BK / 16 / THREADS;      // 2 a thread

__device__ __forceinline__ float apply_act(float v, int act) {
  if (act == kActRelu) return fmaxf(v, 0.0f);
  if (act == kActRelu6) return fminf(fmaxf(v, 0.0f), 6.0f);
  return v;
}

// x * inv rounded to T; a bf16 product of two bf16 values is exact in
// float32, so rounding it once to bf16 is the bf16 multiply
__device__ __forceinline__ float mul_in(float v, float inv, float) {
  return __fmul_rn(v, inv);
}
__device__ __forceinline__ float mul_in(float v, float inv, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16_rn(__fmul_rn(v, inv)));
}

__device__ __forceinline__ uint32_t quant_byte(float p) {
  int q = __float2int_rn(p);                 // half to even
  q = max(-127, min(127, q));
  return static_cast<uint32_t>(q) & 0xffu;
}

// Eight elements of one row of x, as raw bits: bf16 in one uint4, float32 in
// two.
template <typename T>
struct Chunk;

template <>
struct Chunk<__nv_bfloat16> {
  uint4 r;
  __device__ __forceinline__ void load(const __nv_bfloat16* x, long long row,
                                       int gk, int K, bool row_in,
                                       bool vec) {
    if (vec) {
      r = (row_in && gk < K)
              ? __ldg(reinterpret_cast<const uint4*>(x + row * K + gk))
              : make_uint4(0, 0, 0, 0);
      return;
    }
    uint32_t h[CHUNK];
#pragma unroll
    for (int j = 0; j < CHUNK; ++j)
      h[j] = (row_in && gk + j < K)
                 ? static_cast<uint32_t>(__bfloat16_as_ushort(x[row * K + gk + j]))
                 : 0u;
    r = make_uint4(h[0] | (h[1] << 16), h[2] | (h[3] << 16),
                   h[4] | (h[5] << 16), h[6] | (h[7] << 16));
  }
  __device__ __forceinline__ float get(int j) const {
    const uint32_t w = j < 2 ? r.x : j < 4 ? r.y : j < 6 ? r.z : r.w;
    return __uint_as_float((j & 1) ? (w & 0xffff0000u) : (w << 16));
  }
};

template <>
struct Chunk<float> {
  uint4 r[2];
  __device__ __forceinline__ void load(const float* x, long long row, int gk,
                                       int K, bool row_in, bool vec) {
    if (vec) {   // K % 4 == 0: each half is whole or out
#pragma unroll
      for (int h = 0; h < 2; ++h)
        r[h] = (row_in && gk + 4 * h < K)
                   ? __ldg(reinterpret_cast<const uint4*>(x + row * K + gk +
                                                          4 * h))
                   : make_uint4(0, 0, 0, 0);
      return;
    }
    uint32_t f[CHUNK];
#pragma unroll
    for (int j = 0; j < CHUNK; ++j)
      f[j] = (row_in && gk + j < K) ? __float_as_uint(x[row * K + gk + j])
                                    : 0u;
    r[0] = make_uint4(f[0], f[1], f[2], f[3]);
    r[1] = make_uint4(f[4], f[5], f[6], f[7]);
  }
  __device__ __forceinline__ float get(int j) const {
    const uint4& h = r[j >> 2];
    const int i = j & 3;
    return __uint_as_float(i == 0 ? h.x : i == 1 ? h.y : i == 2 ? h.z : h.w);
  }
};

__device__ __forceinline__ void store_out(float* out, long long i, float v) {
  out[i] = v;
}
__device__ __forceinline__ void store_out(__nv_bfloat16* out, long long i,
                                          float v) {
  out[i] = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void store_pair(float* out, long long i, float a,
                                           float b) {
  *reinterpret_cast<float2*>(out + i) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* out, long long i,
                                           float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(out + i) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS)
    matmul_int8_kernel(const T* __restrict__ x, const int8_t* __restrict__ wq,
                       const float* __restrict__ sw,
                       const float* __restrict__ scale,
                       const float* __restrict__ shift, T* __restrict__ out,
                       int M, int K, int Kp, int N, float inv, float eff,
                       int act) {
  __shared__ __align__(16) uint8_t As[2][BM * LDS];
  __shared__ __align__(16) uint8_t Bs[2][BN * LDS];

  const int tiles_n = (N + BN - 1) / BN;
  const long long m0 = static_cast<long long>(blockIdx.x / tiles_n) * BM;
  const int n0 = (blockIdx.x % tiles_n) * BN;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 2, wn = warp & 3;
  const int g = lane >> 2, t = lane & 3;

  Chunk<T> xs[X_CHUNKS];
  uint4 ws[W_CHUNKS];

  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < X_CHUNKS; ++i) {
      const int c = tid + i * THREADS;
      const int row = c / (BK / CHUNK), col = (c % (BK / CHUNK)) * CHUNK;
      const long long gm = m0 + row;
      xs[i].load(x, gm, k0 + col, K, gm < M, VEC);
    }
#pragma unroll
    for (int i = 0; i < W_CHUNKS; ++i) {
      const int c = tid + i * THREADS;
      const int row = c / (BK / 16), col = (c % (BK / 16)) * 16;
      const int gn = n0 + row;
      ws[i] = gn < N ? __ldg(reinterpret_cast<const uint4*>(
                           wq + static_cast<long long>(gn) * Kp + k0 + col))
                     : make_uint4(0, 0, 0, 0);
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int i = 0; i < X_CHUNKS; ++i) {
      const int c = tid + i * THREADS;
      const int row = c / (BK / CHUNK), col = (c % (BK / CHUNK)) * CHUNK;
      uint32_t lo = 0, hi = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        lo |= quant_byte(mul_in(xs[i].get(j), inv, T())) << (8 * j);
        hi |= quant_byte(mul_in(xs[i].get(j + 4), inv, T())) << (8 * j);
      }
      *reinterpret_cast<uint2*>(&As[buf][row * LDS + col]) =
          make_uint2(lo, hi);
    }
#pragma unroll
    for (int i = 0; i < W_CHUNKS; ++i) {
      const int c = tid + i * THREADS;
      const int row = c / (BK / 16), col = (c % (BK / 16)) * 16;
      *reinterpret_cast<uint4*>(&Bs[buf][row * LDS + col]) = ws[i];
    }
  };

  int acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mi][ni][r] = 0;

  const int ktiles = Kp / BK;
  load(0);
  store(0);
  __syncthreads();
  for (int kt = 0; kt < ktiles; ++kt) {
    const int cur = kt & 1;
    const bool more = kt + 1 < ktiles;
    if (more) load((kt + 1) * BK);
#pragma unroll
    for (int ks = 0; ks < BK; ks += 32) {
      uint32_t a[4][4], b[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const uint8_t* p = &As[cur][(wm * 64 + mi * 16 + g) * LDS + ks + t * 4];
        a[mi][0] = *reinterpret_cast<const uint32_t*>(p);
        a[mi][1] = *reinterpret_cast<const uint32_t*>(p + 8 * LDS);
        a[mi][2] = *reinterpret_cast<const uint32_t*>(p + 16);
        a[mi][3] = *reinterpret_cast<const uint32_t*>(p + 8 * LDS + 16);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const uint8_t* p = &Bs[cur][(wn * 32 + ni * 8 + g) * LDS + ks + t * 4];
        b[ni][0] = *reinterpret_cast<const uint32_t*>(p);
        b[ni][1] = *reinterpret_cast<const uint32_t*>(p + 16);
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          mma_s8(acc[mi][ni], a[mi], b[ni][0], b[ni][1]);
    }
    if (more) store(cur ^ 1);
    __syncthreads();
  }

  // epilogue: c0, c1 at (row g, columns 2t, 2t+1); c2, c3 at row g + 8
  const bool pairs = (N % 2) == 0;
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    const int col = n0 + wn * 32 + ni * 8 + 2 * t;
    float deq[2], sc[2], sh[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int cj = min(col + j, N - 1);
      deq[j] = __fmul_rn(eff, sw[cj]);
      sc[j] = scale != nullptr ? scale[cj] : 1.0f;
      sh[j] = shift != nullptr ? shift[cj] : 0.0f;
    }
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long row = m0 + wm * 64 + mi * 16 + g + 8 * h;
        if (row >= M || col >= N) continue;
        float v[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float y = __fmul_rn(__int2float_rn(acc[mi][ni][2 * h + j]), deq[j]);
          if (scale != nullptr) y = __fmul_rn(y, sc[j]);
          if (shift != nullptr) y = __fadd_rn(y, sh[j]);
          v[j] = apply_act(y, act);
        }
        const long long i = row * N + col;
        if (pairs) {
          store_pair(out, i, v[0], v[1]);
        } else {
          store_out(out, i, v[0]);
          if (col + 1 < N) store_out(out, i + 1, v[1]);
        }
      }
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <typename T>
int launch(const void* x, const void* wq, const float* sw, const float* scale,
           const float* shift, void* out, int M, int K, int Kp, int N,
           float inv, float eff, int act, bool vec, cudaStream_t s) {
  const unsigned long long grid =
      static_cast<unsigned long long>((static_cast<long long>(M) + BM - 1) / BM) *
      ((static_cast<long long>(N) + BN - 1) / BN);
  if (grid > 0x7fffffffULL)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const auto* xt = static_cast<const T*>(x);
  const auto* w8 = static_cast<const int8_t*>(wq);
  auto* ot = static_cast<T*>(out);
  if (vec)
    matmul_int8_kernel<T, true><<<static_cast<unsigned>(grid), THREADS, 0, s>>>(
        xt, w8, sw, scale, shift, ot, M, K, Kp, N, inv, eff, act);
  else
    matmul_int8_kernel<T, false><<<static_cast<unsigned>(grid), THREADS, 0, s>>>(
        xt, w8, sw, scale, shift, ot, M, K, Kp, N, inv, eff, act);
  return static_cast<int>(cudaGetLastError());
}

int elem_bytes(int dtype) { return dtype == 1 ? 2 : 4; }

}  // namespace

// 1: the vector instance (each row of x whole 16-byte vectors, x 16-byte
// aligned), 0: the scalar instance, -1: no kernel for this dtype.
extern "C" int ctt_matmul_int8_variant(const void* x, int K, int dtype) {
  if (dtype != 0 && dtype != 1) return -1;
  return (static_cast<long long>(K) * elem_bytes(dtype)) % 16 == 0 &&
                 aligned16(x)
             ? 1
             : 0;
}

// dtype: 0 float32, 1 bfloat16. wq (N, Kp) int8, Kp a multiple of 64 and at
// least K, 16-byte aligned. Returns the cudaError_t of the launch.
extern "C" int ctt_matmul_int8(const void* x, const void* wq, const float* sw,
                               const float* scale, const float* shift,
                               void* out, int M, int K, int Kp, int N,
                               float inv, float eff, int act, int dtype,
                               void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || Kp < K || Kp % BK != 0 ||
      act < kActNone || act > kActRelu6 || !aligned16(wq))
    return static_cast<int>(cudaErrorInvalidValue);
  const int v = ctt_matmul_int8_variant(x, K, dtype);
  if (v < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, wq, sw, scale, shift, out, M, K, Kp, N,
                                 inv, eff, act, v == 1, s);
  return launch<float>(x, wq, sw, scale, shift, out, M, K, Kp, N, inv, eff,
                       act, v == 1, s);
}
