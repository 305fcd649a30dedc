// Fused pointwise conv + folded BatchNorm + activation for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_build.body` behind `matmul_scale_act` /
// `conv1x1_bn_act` in convnet_tpu/ops/pallas/matmul_fused.py (pallas_call at
// line 50). It computes
//
//     out[m, n] = act((sum_k x[m, k] * w[n, k]) * scale[n] + shift[n])
//
// with x (M, K) row-major (an NHWC activation seen as (N*H*W, Cin)), w (N, K)
// row-major (the OIHW weight of a 1x1 conv, already in x's type), scale and
// shift (N,) float32, and out (M, N) row-major in x's type. Products are
// accumulated in float32 and the epilogue runs in float32; the output is
// written once. act: 0 none, 1 relu, 2 relu6.
//
// What bounds it on an H100: the 1x1 convs of ResNet-50 have small K (64 to
// 2048), so most of them are memory-bound. Layer1's cb3 at batch 64 has
// M = 200,704, K = 64, N = 256: about 128 MB moved against 6.6 GFLOP, i.e.
// about 38 us at 3.35 TB/s against 7 us of bf16 tensor-core time. The design
// therefore aims to read x once from device memory and write the output once,
// with the BN scale/shift and the activation applied in registers so no
// intermediate touches device memory:
//   * bf16: 128x128 output tiles, 8 warps each owning 64x32, mma.sync
//     m16n8k16 (bf16 in, f32 accumulate); 32-wide K slices double-buffered in
//     shared memory with cp.async (zero-fill masks the ragged M, N and K
//     edges). Output tiles walk N fastest, so the blocks that share an x tile
//     run together and x is re-read from L2 rather than from device memory.
//   * float32: a plain 64x64 shared-memory tiled FMA kernel (no tensor cores,
//     so the result is true float32 and not TF32).
// wgmma and TMA are later work; this version is simple and exact first.
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

__device__ __forceinline__ float apply_act(float v, int act) {
  if (act == kActRelu) return fmaxf(v, 0.0f);
  if (act == kActRelu6) return fminf(fmaxf(v, 0.0f), 6.0f);
  return v;
}

// ---------------------------------------------------------------- bf16 path

constexpr int BM = 128;          // output rows per block
constexpr int BN = 128;          // output columns per block
constexpr int BK = 32;           // K slice per pipeline stage
constexpr int LDS = BK + 8;      // padded smem row (80 bytes: no bank conflicts)
constexpr int WARPS_M = 2;
constexpr int WARPS_N = 4;
constexpr int THREADS = 32 * WARPS_M * WARPS_N;
constexpr int WM = BM / WARPS_M;  // 64 rows per warp
constexpr int WN = BN / WARPS_N;  // 32 columns per warp
constexpr int MT = WM / 16;       // m16 tiles per warp
constexpr int NT = WN / 8;        // n8 tiles per warp

struct __align__(16) SmemBf16 {
  __nv_bfloat16 a[2][BM][LDS];
  __nv_bfloat16 b[2][BN][LDS];
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int src_bytes = valid ? 16 : 0;  // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// Copies rows [row0, row0 + ROWS) x columns [k0, k0 + BK) of a row-major
// (nrows, K) matrix into dst; out-of-range elements become 0. VEC needs
// K % 8 == 0 and a 16-byte aligned src, so each 8-element chunk is wholly in
// or out of range.
template <int ROWS, bool VEC>
__device__ __forceinline__ void load_tile(__nv_bfloat16 (*dst)[LDS],
                                          const __nv_bfloat16* src, int row0,
                                          int nrows, int k0, int K) {
  if constexpr (VEC) {
    constexpr int CHUNKS_PER_ROW = BK / 8;
    for (int c = threadIdx.x; c < ROWS * CHUNKS_PER_ROW; c += THREADS) {
      const int r = c / CHUNKS_PER_ROW;
      const int kc = (c % CHUNKS_PER_ROW) * 8;
      const int gr = row0 + r;
      const int gk = k0 + kc;
      const bool valid = gr < nrows && gk < K;
      const __nv_bfloat16* g = valid ? src + (size_t)gr * K + gk : src;
      cp_async16(&dst[r][kc], g, valid);
    }
  } else {
    for (int e = threadIdx.x; e < ROWS * BK; e += THREADS) {
      const int r = e / BK;
      const int k = e % BK;
      const int gr = row0 + r;
      const int gk = k0 + k;
      dst[r][k] = (gr < nrows && gk < K) ? src[(size_t)gr * K + gk]
                                         : __float2bfloat16(0.0f);
    }
  }
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_bf16_16816(float (&d)[4],
                                               const uint32_t (&a)[4],
                                               const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
    matmul_scale_act_bf16(const __nv_bfloat16* __restrict__ x,
                          const __nv_bfloat16* __restrict__ w,
                          const float* __restrict__ scale,
                          const float* __restrict__ shift,
                          __nv_bfloat16* __restrict__ out, int M, int K, int N,
                          int act) {
  __shared__ SmemBf16 sm;
  const int ntiles = (N + BN - 1) / BN;
  const int m0 = (blockIdx.x / ntiles) * BM;
  const int n0 = (blockIdx.x % ntiles) * BN;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wm = (warp / WARPS_N) * WM;  // warp's first row in the tile
  const int wn = (warp % WARPS_N) * WN;  // warp's first column in the tile
  const int g = lane >> 2;               // mma "groupID"
  const int t = lane & 3;                // mma "threadID_in_group"

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.0f;

  const int ktiles = (K + BK - 1) / BK;
  load_tile<BM, VEC>(sm.a[0], x, m0, M, 0, K);
  load_tile<BN, VEC>(sm.b[0], w, n0, N, 0, K);
  cp_async_commit();

  for (int kt = 0; kt < ktiles; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < ktiles) {  // the other stage was freed by the last barrier
      load_tile<BM, VEC>(sm.a[cur ^ 1], x, m0, M, (kt + 1) * BK, K);
      load_tile<BN, VEC>(sm.b[cur ^ 1], w, n0, N, (kt + 1) * BK, K);
    }
    cp_async_commit();     // possibly empty: keeps the group count uniform
    cp_async_wait_one();   // stage `cur` has landed
    __syncthreads();

    __nv_bfloat16(*A)[LDS] = sm.a[cur];
    __nv_bfloat16(*B)[LDS] = sm.b[cur];
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t af[MT][4];
      uint32_t bf[NT][2];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int r = wm + i * 16 + g;
        af[i][0] = lds32(&A[r][kk + 2 * t]);
        af[i][1] = lds32(&A[r + 8][kk + 2 * t]);
        af[i][2] = lds32(&A[r][kk + 2 * t + 8]);
        af[i][3] = lds32(&A[r + 8][kk + 2 * t + 8]);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int n = wn + j * 8 + g;
        bf[j][0] = lds32(&B[n][kk + 2 * t]);
        bf[j][1] = lds32(&B[n][kk + 2 * t + 8]);
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_bf16_16816(acc[i][j], af[i], bf[j]);
    }
    __syncthreads();
  }

  // Epilogue: accumulator element c of tile (i, j) sits at row g (+8 for
  // c >= 2) and column 2t + (c & 1).
  const bool pairs = (N % 2) == 0;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int col = n0 + wn + j * 8 + 2 * t;
    if (col >= N) continue;
    const bool has2 = col + 1 < N;
    const float s0 = scale[col], b0 = shift[col];
    const float s1 = has2 ? scale[col + 1] : 0.0f;
    const float b1 = has2 ? shift[col + 1] : 0.0f;
#pragma unroll
    for (int i = 0; i < MT; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm + i * 16 + g + 8 * h;
        if (row >= M) continue;
        const float v0 = apply_act(acc[i][j][2 * h] * s0 + b0, act);
        const float v1 = apply_act(acc[i][j][2 * h + 1] * s1 + b1, act);
        __nv_bfloat16* o = out + (size_t)row * N + col;
        if (pairs && has2) {
          *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(v0, v1);
        } else {
          o[0] = __float2bfloat16(v0);
          if (has2) o[1] = __float2bfloat16(v1);
        }
      }
    }
  }
}

// ------------------------------------------------------------- float32 path

constexpr int FB = 64;        // square output tile
constexpr int FBK = 16;       // K slice
constexpr int FTHREADS = 256; // 16 x 16 threads, each 4 x 4 outputs

__global__ void __launch_bounds__(FTHREADS)
    matmul_scale_act_f32(const float* __restrict__ x,
                         const float* __restrict__ w,
                         const float* __restrict__ scale,
                         const float* __restrict__ shift,
                         float* __restrict__ out, int M, int K, int N,
                         int act) {
  __shared__ float as[FBK][FB + 4];
  __shared__ float bs[FBK][FB + 4];
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int ntiles = (N + FB - 1) / FB;
  const int m0 = (blockIdx.x / ntiles) * FB;
  const int n0 = (blockIdx.x % ntiles) * FB;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += FBK) {
    for (int e = threadIdx.x; e < FB * FBK; e += FTHREADS) {
      const int r = e / FBK;
      const int k = e % FBK;
      const int gk = k0 + k;
      const int gm = m0 + r;
      const int gn = n0 + r;
      as[k][r] = (gm < M && gk < K) ? x[(size_t)gm * K + gk] : 0.0f;
      bs[k][r] = (gn < N && gk < K) ? w[(size_t)gn * K + gk] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < FBK; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = as[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = bs[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty + 16 * i;
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx + 16 * j;
      if (col < N)
        out[(size_t)row * N + col] =
            apply_act(acc[i][j] * scale[col] + shift[col], act);
    }
  }
}

// Output tiles go on gridDim.x alone, N fastest: gridDim.y would cap M at
// 65,535 tiles (8,388,480 rows in bf16).
unsigned tiles(int n, int tile) { return (unsigned)((n + tile - 1) / tile); }

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. Returns the cudaError_t of the launch.
extern "C" int ctt_matmul_scale_act(const void* x, const void* w,
                                    const float* scale, const float* shift,
                                    void* out, int M, int K, int N, int act,
                                    int dtype, void* stream) {
  if (M <= 0 || N <= 0 || K < 0 || act < kActNone || act > kActRelu6)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((unsigned long long)tiles(M, 64) * tiles(N, 64) > 0x7fffffffULL)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    const unsigned grid = tiles(M, BM) * tiles(N, BN);
    const auto* xb = static_cast<const __nv_bfloat16*>(x);
    const auto* wb = static_cast<const __nv_bfloat16*>(w);
    auto* ob = static_cast<__nv_bfloat16*>(out);
    if (K % 8 == 0 && aligned16(x) && aligned16(w))
      matmul_scale_act_bf16<true>
          <<<grid, THREADS, 0, s>>>(xb, wb, scale, shift, ob, M, K, N, act);
    else
      matmul_scale_act_bf16<false>
          <<<grid, THREADS, 0, s>>>(xb, wb, scale, shift, ob, M, K, N, act);
  } else if (dtype == 0) {
    const unsigned grid = tiles(M, FB) * tiles(N, FB);
    matmul_scale_act_f32<<<grid, FTHREADS, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), scale,
        shift, static_cast<float*>(out), M, K, N, act);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
