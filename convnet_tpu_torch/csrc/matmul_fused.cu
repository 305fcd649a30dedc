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
// intermediate touches device memory. Three kernels, picked by a stated
// shape rule and never on failure:
//   * bf16 where TMA can describe the operands (K > 0, K % 8 == 0,
//     N % 8 == 0, x, w and out 16-byte aligned): a persistent grid, two
//     blocks an SM, walks 128x128 output tiles, N fastest, so the tiles that
//     share an x slab run together and read it from L2. In each block one
//     producer thread keeps TMA loads of 64-wide K slices of x and w
//     (128-byte swizzled) in flight through a ring of 2 stages, with
//     mbarriers for "full" and "empty"; its ring runs on across tiles, so
//     the next tile's loads overlap this tile's products and epilogue. Two
//     consumer warpgroups each run wgmma m64n128k16 (bf16 in, float32 sums)
//     on 64 rows of the tile straight from shared memory, one wgmma group
//     in flight, then apply scale, shift and act in float32 registers and
//     write bf16 into two swizzled 64x64 staging boxes, which one TMA store
//     drains while the next tile loads and computes (and while the SM's
//     other block runs). The tensor maps are encoded on the host
//     (cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint, so
//     no driver library is linked) and passed as __grid_constant__
//     parameters. TMA fills the ragged M, N and K edges with zeros on load
//     and clips them on store. Measured on an H100 against the other
//     shapes tried (one block an SM with 4 stages, 128x256 tiles, 64-row
//     tiles, 16-byte stores from registers), this one was fastest per
//     ResNet-50 forward.
//   * bf16 otherwise (K or N not a multiple of 8, or an unaligned pointer):
//     the first design, 128x128 output tiles, 8 warps of mma.sync m16n8k16,
//     32-wide K slices double-buffered with cp.async, zero-filled at the
//     edges (a scalar load path where K % 8 != 0).
//   * float32: a plain 64x64 shared-memory tiled FMA kernel (no tensor cores,
//     so the result is true float32 and not TF32).
//
// The mbarrier, TMA, descriptor and tensor-map helpers are csrc/hopper.cuh's,
// shared with the int8 1x1 (csrc/matmul_int8.cu).
//
// Plain C interface, no PyTorch headers: built with nvcc into a shared
// library and called through ctypes (convnet_tpu_torch/ops/kernels).

#include <cuda_bf16.h>

#include "hopper.cuh"

namespace {

using hopper::aligned16;
using hopper::desc_kmajor;
using hopper::mbar_arrive;
using hopper::mbar_expect_tx;
using hopper::mbar_init;
using hopper::mbar_wait;
using hopper::named_sync;
using hopper::tma_load;
using hopper::tma_store;

constexpr int kActNone = 0;
constexpr int kActRelu = 1;
constexpr int kActRelu6 = 2;

__device__ __forceinline__ float apply_act(float v, int act) {
  if (act == kActRelu) return fmaxf(v, 0.0f);
  if (act == kActRelu6) return fminf(fmaxf(v, 0.0f), 6.0f);
  return v;
}

// ---------------------------------------------- bf16, mma.sync (the rest)

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

// ------------------------------------------------ bf16, TMA + wgmma (most)

constexpr int TBM = 128;                  // output rows per tile
constexpr int TBN = 128;                  // output columns per tile
constexpr int TBK = 64;                   // K slice: 128 bytes, one swizzle row
constexpr int STAGES = 2;
constexpr int CONSUMERS = 2;              // warpgroups, 64 rows of a tile each
constexpr int TTHREADS = 128 * CONSUMERS + 32;   // + the producer warp
constexpr int X_BYTES = TBM * TBK * 2;           // one x slice, 16 KB
constexpr int STAGE_BYTES = X_BYTES + TBN * TBK * 2;  // and one w slice
constexpr int BOX_BYTES = 64 * 64 * 2;           // one staged output box, 8 KB
constexpr int OFF_C = STAGES * STAGE_BYTES;
constexpr int OFF_BAR = OFF_C + CONSUMERS * 2 * BOX_BYTES;
constexpr int TMA_SMEM = OFF_BAR + 2 * STAGES * 8 + 1024;  // + alignment slack

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// d[64] += A (64 x 16, desc a) * B (16 x 128 as 128 K-major rows, desc b);
// scale_d == 0 overwrites d instead.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t a,
                                                 uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

__global__ void __launch_bounds__(TTHREADS, 2)
    matmul_scale_act_tma(const __grid_constant__ CUtensorMap tm_x,
                         const __grid_constant__ CUtensorMap tm_w,
                         const __grid_constant__ CUtensorMap tm_out,
                         const float* __restrict__ scale,
                         const float* __restrict__ shift, int M, int K,
                         int N, int act) {
  extern __shared__ uint8_t smem_raw[];
  // TMA's 128-byte swizzle repeats every 1024 bytes: align the ring to it
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - raw);
  const uint32_t full = base + OFF_BAR, empty = full + STAGES * 8;
  const int ntiles = (N + TBN - 1) / TBN;
  const int tiles = ((M + TBM - 1) / TBM) * ntiles;
  const int ktiles = (K + TBK - 1) / TBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, CONSUMERS * 4);  // lane 0 of each consumer warp
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS * 128) {
    // Producer: one thread walks the block's tiles and K slices, a stage at
    // a time, as soon as the consumers have released it.
    if (threadIdx.x == CONSUMERS * 128) {
      int stage = 0, phase = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = (tile / ntiles) * TBM, n0 = (tile % ntiles) * TBN;
        for (int kt = 0; kt < ktiles; ++kt) {
          const uint32_t at = base + stage * STAGE_BYTES;
          mbar_wait(empty + 8 * stage, phase ^ 1);
          mbar_expect_tx(full + 8 * stage, STAGE_BYTES);
          tma_load(at, &tm_x, kt * TBK, m0, full + 8 * stage);
          tma_load(at + X_BYTES, &tm_w, kt * TBK, n0, full + 8 * stage);
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  // Consumers: warpgroup cw owns rows cw*64 .. cw*64 + 63 of each tile.
  const int cw = threadIdx.x / 128;
  const int wl = (threadIdx.x % 128) / 32;  // warp within the warpgroup
  const int lane = threadIdx.x % 32;
  const int gq = lane >> 2, tq = lane & 3;
  const uint32_t stage_c = base + OFF_C + cw * 2 * BOX_BYTES;
  uint8_t* const gstage_c = gbase + OFF_C + cw * 2 * BOX_BYTES;
  float d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0.0f;
  int stage = 0, phase = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = (tile / ntiles) * TBM, n0 = (tile % ntiles) * TBN;
    // One wgmma group stays in flight: a stage is released once the group
    // after it has been issued and the group reading it has completed.
    int prev = -1;
    for (int kt = 0; kt < ktiles; ++kt) {
      const uint32_t at = base + stage * STAGE_BYTES;
      mbar_wait(full + 8 * stage, phase);
      hopper::wgmma_fence();
      const uint64_t da = desc_kmajor(at + cw * 64 * TBK * 2, 128);
      const uint64_t db = desc_kmajor(at + X_BYTES, 128);
#pragma unroll
      for (int kk = 0; kk < TBK / 16; ++kk)  // 32 bytes of K a step
        wgmma_m64n128k16(d, da + 2 * kk, db + 2 * kk, kt > 0 || kk > 0);
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();
      if (prev >= 0 && lane == 0) mbar_arrive(empty + 8 * prev);
      prev = stage;
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
    hopper::wgmma_wait<0>();
    if (lane == 0) mbar_arrive(empty + 8 * prev);

    // Epilogue: d[4j + 2h + e] sits at row 16 wl + gq + 8h, column 8j +
    // 2tq + e; scale, shift and act in float32, then bf16 into the staging
    // boxes and out through one TMA store, which drains while the next tile
    // loads and computes.
    // The last tile's store must have read the staging boxes. Box j / 8
    // holds columns 64 (j / 8) .. + 63 as 64 rows of 128 bytes whose
    // 16-byte chunks are swizzled by row % 8 (= gq).
    if (threadIdx.x % 128 == 0) hopper::tma_store_wait_read();
    named_sync(1 + cw);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = n0 + 8 * j + 2 * tq;
      const bool in = col < N;  // N % 8 == 0: the pair is whole or out
      const float s0 = in ? __ldg(scale + col) : 0.0f;
      const float s1 = in ? __ldg(scale + col + 1) : 0.0f;
      const float b0 = in ? __ldg(shift + col) : 0.0f;
      const float b1 = in ? __ldg(shift + col + 1) : 0.0f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = 16 * wl + gq + 8 * h;
        *reinterpret_cast<uint32_t*>(gstage_c + (j / 8) * BOX_BYTES +
                                     row * 128 + (((j % 8) ^ gq) << 4) +
                                     4 * tq) =
            pack_bf16(apply_act(d[4 * j + 2 * h] * s0 + b0, act),
                      apply_act(d[4 * j + 2 * h + 1] * s1 + b1, act));
      }
    }
    hopper::fence_proxy_async();
    named_sync(1 + cw);
    if (threadIdx.x % 128 == 0 && m0 + cw * 64 < M) {
      for (int box = 0; box < 2; ++box)
        if (n0 + 64 * box < N)
          tma_store(&tm_out, stage_c + box * BOX_BYTES, n0 + 64 * box,
                    m0 + cw * 64);
      hopper::tma_store_commit();
    }
  }
  if (threadIdx.x % 128 == 0) hopper::tma_store_wait();
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

// The shape rule for the TMA kernel: TMA needs 16-byte aligned rows and
// bases.
bool tma_ok(int K, int N, int dtype, const void* x, const void* w,
            const void* out) {
  return dtype == 1 && K > 0 && K % 8 == 0 && N % 8 == 0 && aligned16(x) &&
         aligned16(w) && aligned16(out);
}

int launch_tma(const void* x, const void* w, const float* scale,
               const float* shift, void* out, int M, int K, int N, int act,
               cudaStream_t s) {
  const PFN_cuTensorMapEncodeTiled fn = hopper::encode_fn();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap tm_x, tm_w, tm_out;
  if (!hopper::encode_bf16(fn, &tm_x, x, M, K, TBM) ||
      !hopper::encode_bf16(fn, &tm_w, w, N, K, TBN) ||
      !hopper::encode_bf16(fn, &tm_out, out, M, N, 64))
    return static_cast<int>(cudaErrorInvalidValue);
  // per device: the SM count, once the shared-memory limit is set
  static int sms[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (sms[dev] == 0) {
    int n = 0;
    err = cudaFuncSetAttribute(matmul_scale_act_tma,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               TMA_SMEM);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    sms[dev] = n;
  }
  // persistent: two blocks an SM (288 threads, about 97 KB each)
  const long long all = (long long)tiles(M, TBM) * tiles(N, TBN);
  const long long resident = 2LL * sms[dev];
  const unsigned grid = (unsigned)(all < resident ? all : resident);
  matmul_scale_act_tma<<<grid, TTHREADS, TMA_SMEM, s>>>(
      tm_x, tm_w, tm_out, scale, shift, M, K, N, act);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Which kernel ctt_matmul_scale_act runs for these arguments: 2 the TMA +
// wgmma kernel, 1 the mma.sync kernel, 0 the float32 FMA kernel, -1 none.
extern "C" int ctt_matmul_scale_act_variant(const void* x, const void* w,
                                            void* out, int K, int N,
                                            int dtype) {
  if (dtype == 1) return tma_ok(K, N, dtype, x, w, out) ? 2 : 1;
  return dtype == 0 ? 0 : -1;
}

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
  if (tma_ok(K, N, dtype, x, w, out))
    return launch_tma(x, w, scale, shift, out, M, K, N, act, s);
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
