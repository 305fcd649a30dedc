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
// bit. The sums are exact int32 (K < 2^31 / 127^2). The epilogue is float32
// with every product and sum rounded on its own (no contraction), so a
// float32 output equals the plain version's; a bf16 output skips the plain
// version's rounding of the dequantized value to bf16 before scale and
// shift. act: 0 none, 1 relu, 2 relu6.
//
// What bounds it on an H100: int8 products run at 1,979 TOPS, twice the
// bf16 rate, so at ResNet-50's and MobileNet-V2's shapes (K 16 to 2048) the
// kernel is bound by the bytes of x and out, as the bf16 fused 1x1 is. The
// unfused chain (quantize pass, int8 matmul, dequantize pass) moves x, q
// (twice), the int32 sums (twice) and out; this kernel moves x and out only:
// it quantizes x on chip and the sums never leave it.
//
// Three instances, picked by a stated shape rule and never on failure
// (ctt_matmul_int8_variant):
//   * "tma": bf16 where TMA can describe x, wq and out (K % 8 == 0,
//     N % 8 == 0, 16-byte aligned pointers): every ResNet-50 and
//     MobileNet-V2 shape. A persistent grid walks work units (an output tile
//     and a range of K), N fastest, so the units that share an x slab run
//     together and read it from L2. In each block one producer thread keeps
//     TMA loads of 64-wide K slices of x (bf16, 128-byte swizzle) and of wq
//     (int8, K-major, 64-byte swizzle) in flight through a ring of 3 stages
//     with "full" and "empty" mbarriers; the ring runs on across units, so
//     the next unit's loads overlap this unit's products and epilogue (the
//     K = 64 shapes are one slice a unit). One or two consumer warpgroups
//     (64 output rows each) read their rows of the x slice from shared
//     memory and quantize them (the bf16 product by bf16x2 multiplies, the
//     clamp in bf16, half-to-even rounding by adding 1.5 * 2^23 in
//     float32) for wgmma.mma_async m64nBNk32 .s32.s8.s8, whose B (wq)
//     comes from a shared-memory descriptor. Where A goes was measured on an
//     H100, each placement at every path tile (PERF.md): straight into
//     wgmma's register fragments (no store, fence or barrier a slice, 3 stages) is
//     faster on every tile but the 128 x 128 one of two warpgroups, where
//     64 accumulators and the fragments pass the 96 registers that two
//     blocks an SM leave a thread, and ptxas spills; there A goes through a
//     second, swizzled int8 shared buffer (two slices, so one wgmma group
//     stays in flight; 2 stages). The epilogue converts the sums to float
//     (by an exact add where K <= 256 keeps them under 2^22, else by the
//     conversion unit), dequantizes and applies scale, shift and act in
//     float32 registers, writes bf16 into swizzled staging boxes (64
//     columns with the 128-byte swizzle, or 16 with the 32-byte one where
//     BN is not a multiple of 64) and one thread drains them with TMA
//     stores while the next unit loads and computes. TMA zero-fills the
//     ragged M, N and K edges on load and clips them on store. The tile
//     shape is the wrapper's (ops/kernels/matmul_int8.py, plan: BN a
//     multiple of 16 up to 128 that splits N into equal tiles; 128-row
//     tiles where K < 256 and they fill the SMs, else 64-row tiles, three
//     blocks an SM, and split K where even those leave SMs idle; K in
//     32-byte steps). Split-K units add their exact int32 sums into a
//     zeroed workspace with atomics, in any order; the last unit of a tile
//     (a per-tile counter) reads the sums, zeroes the workspace and the
//     counter again, and runs the epilogue. Tried on the card and dropped:
//     float2 loads of the epilogue's per-column vectors (more spills in the
//     two-warpgroup tiles) and quantizing A once for all N tiles of a row
//     tile where K is one slice (one block a row tile leaves SMs idle).
//   * "vector" (float32, or bf16 that TMA cannot describe, with rows of
//     whole 16-byte vectors and x 16-byte aligned) and "scalar" (x loaded an
//     element at a time): the first design, 128x128 output tiles,
//     one block each, 8 warps (2 x 4) each a 64x32 sub-tile of mma.sync
//     m16n8k32 s8 x s8 -> s32; 64-wide K slices, double buffered in shared
//     memory, the next slice's x and wq loaded into registers while the
//     tensor cores work on this one, quantized between the two. Shared rows
//     are 80 bytes (64 and 16 of padding), so the fragment loads of a warp
//     hit 32 different banks. Ragged M, N and K are masked: rows beyond M
//     and columns beyond K quantize zeros, wq's rows beyond N load as zeros,
//     and only the real outputs are stored.
//
// The mbarrier, TMA, descriptor and tensor-map helpers are csrc/hopper.cuh's,
// shared with the bf16 fused 1x1 (csrc/matmul_fused.cu). Plain C interface,
// no PyTorch headers: built with nvcc into a shared library and called
// through ctypes (convnet_tpu_torch/ops/kernels).

#include <cuda_bf16.h>

#include "hopper.cuh"

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

// ------------------------------------------------- bf16, TMA + wgmma ("tma")

using hopper::aligned16;
using hopper::desc_kmajor;
using hopper::mbar_arrive;
using hopper::mbar_expect_tx;
using hopper::mbar_init;
using hopper::mbar_wait;
using hopper::named_sync;

constexpr int Q_SLICE = 64;      // K a stage: a 128-byte bf16 row of x

// Shared memory of one block: the ring of (x, wq) slices, the staging boxes
// of each consumer's output rows, the int8 A buffers (A_SMEM only), the
// mbarriers and a flag a consumer. Every part starts on a multiple of the
// 1024 bytes the 128-byte swizzle repeats over. A in registers leaves room
// for 3 stages at two blocks an SM, A in shared memory for 2.
template <int TN, int CONS>
struct Layout {
  // the quantized A in a swizzled int8 shared buffer, else in wgmma's
  // register fragments (the file head says why)
  static constexpr bool A_SMEM = TN == 128 && CONS == 2;
  static constexpr int Q_STAGES = A_SMEM ? 2 : 3;
  static constexpr int BM = 64 * CONS;
  static constexpr int THREADS = 128 * CONS + 32;   // + the producer warp
  static constexpr int X_BYTES = BM * Q_SLICE * 2;
  static constexpr int STAGE_BYTES = X_BYTES + TN * Q_SLICE;
  static constexpr int BOXW = TN % 64 == 0 ? 64 : 16;   // output box columns
  static constexpr int BOX_BYTES = 64 * BOXW * 2;
  static constexpr int OUT_BYTES = 64 * TN * 2;         // a consumer's rows
  static constexpr int A_BYTES = 2 * 64 * Q_SLICE;      // two int8 slices
  static constexpr int OFF_OUT = Q_STAGES * STAGE_BYTES;
  static constexpr int OFF_A = OFF_OUT + CONS * OUT_BYTES;
  static constexpr int OFF_BAR = OFF_A + (A_SMEM ? CONS * A_BYTES : 0);
  static constexpr int SMEM = OFF_BAR + 2 * Q_STAGES * 8 + 8 * CONS + 1024;
};

// What a launch computes, beside the tensor maps. The work units are
// m_tiles x split x n_tiles, N fastest: unit u takes the output tile
// (u / (n_tiles * split), u % n_tiles) over the K steps (32 bytes each)
// [s * per, min((s + 1) * per, ksteps)) of split s = u / n_tiles % split.
struct Int8Args {
  const float* sw;
  const float* scale;   // null: 1
  const float* shift;   // null: 0
  int* ws;              // split > 1: m_tiles * n_tiles * BM * BN int32, zero
  int* counters;        // split > 1: m_tiles * n_tiles * CONS int32, zero
  int M, N, ksteps, m_tiles, n_tiles, split, per;
  float inv, eff;
  int act;
  bool exact_add;   // |sums| < 2^22: converted to float by an exact add
};

// d += A (64 x 32 int8) * B (32 x BN as BN K-major rows) in int32, with A
// from registers (rs: the m16n8k32 fragment of each warp's 16 rows) or, at
// the one tile that keeps A in shared memory, from a descriptor (ss), B from
// a descriptor; scale_d == 0 overwrites d instead.
template <int TN>
struct Wgmma;

template <>
struct Wgmma<16> {
  __device__ __forceinline__ static void rs(int (&d)[8],
                                            const uint32_t (&a)[4],
                                            uint64_t b, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<32> {
  __device__ __forceinline__ static void rs(int (&d)[16],
                                            const uint32_t (&a)[4],
                                            uint64_t b, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15"
      "}, {%16, %17, %18, %19}, %20, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<48> {
  __device__ __forceinline__ static void rs(int (&d)[24],
                                            const uint32_t (&a)[4],
                                            uint64_t b, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23"
      "}, {%24, %25, %26, %27}, %28, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<64> {
  __device__ __forceinline__ static void rs(int (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t b, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<80> {
  __device__ __forceinline__ static void rs(int (&d)[40],
                                            const uint32_t (&a)[4],
                                            uint64_t b, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39"
      "}, {%40, %41, %42, %43}, %44, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<96> {
  __device__ __forceinline__ static void rs(int (&d)[48],
                                            const uint32_t (&a)[4],
                                            uint64_t b, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
      "}, {%48, %49, %50, %51}, %52, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<112> {
  __device__ __forceinline__ static void rs(int (&d)[56],
                                            const uint32_t (&a)[4],
                                            uint64_t b, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %61, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55"
      "}, {%56, %57, %58, %59}, %60, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<128> {
  __device__ __forceinline__ static void rs(int (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t b, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63"
      "}, {%64, %65, %66, %67}, %68, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
  __device__ __forceinline__ static void ss(int (&d)[64], uint64_t a,
                                            uint64_t b, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
  }
};

constexpr float kRound = 12582912.0f;   // 1.5 * 2^23

// Four bf16 of x (two bf16x2 words) to four int8 in one word, the lowest
// first: the product by inv rounded to bf16 (bf16x2 multiplies), clamped to
// +-127 (exact in bf16), then rounded half to even by the float32 add of
// 1.5 * 2^23, whose low byte is then the integer in two's complement.
__device__ __forceinline__ uint32_t quant4(uint32_t lo, uint32_t hi,
                                           __nv_bfloat162 inv2) {
  const __nv_bfloat162 top = __float2bfloat162_rn(127.0f);
  const __nv_bfloat162 bot = __float2bfloat162_rn(-127.0f);
  const uint32_t w[2] = {lo, hi};
  uint32_t e[4];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(&w[i]);
    v = __hmin2(__hmax2(__hmul2_rn(v, inv2), bot), top);
    const uint32_t b = *reinterpret_cast<const uint32_t*>(&v);
    e[2 * i] = __float_as_uint(__fadd_rn(__uint_as_float(b << 16), kRound));
    e[2 * i + 1] =
        __float_as_uint(__fadd_rn(__uint_as_float(b & 0xffff0000u), kRound));
  }
  return __byte_perm(__byte_perm(e[0], e[1], 0x0040),
                     __byte_perm(e[2], e[3], 0x0040), 0x5410);
}

__device__ __forceinline__ uint2 lds64(const uint8_t* p) {
  return *reinterpret_cast<const uint2*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// One slice (nk = 1 or 2 K steps) of a consumer's 64 rows, A from
// registers: each thread quantizes the bytes of its m16n8k32 fragments,
// rows 16 wl + gq and + 8 (both at row % 8 == gq in the 128-byte swizzle),
// into q, which the wgmma of this slice reads until it completes (the
// caller waits for it before the next slice: one set of fragments keeps
// the 128-column tile within two blocks' registers an SM).
template <int TN>
__device__ __forceinline__ void slice_regs(int (&acc)[TN / 2],
                                           uint32_t (&q)[2][4],
                                           const uint8_t* xs, uint64_t db,
                                           int nk, bool first,
                                           __nv_bfloat162 inv2, int wl,
                                           int gq, int tq) {
  const uint8_t* r0 = xs + (16 * wl + gq) * 128 + 8 * (tq & 1);
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    if (kk < nk) {
      const int c = 4 * kk + (tq >> 1);   // 16-byte chunk of k 32 kk + 4 tq
      const uint2 a = lds64(r0 + ((c ^ gq) << 4));
      const uint2 b = lds64(r0 + 1024 + ((c ^ gq) << 4));
      const uint2 e = lds64(r0 + (((c + 2) ^ gq) << 4));
      const uint2 f = lds64(r0 + 1024 + (((c + 2) ^ gq) << 4));
      q[kk][0] = quant4(a.x, a.y, inv2);
      q[kk][1] = quant4(b.x, b.y, inv2);
      q[kk][2] = quant4(e.x, e.y, inv2);
      q[kk][3] = quant4(f.x, f.y, inv2);
    }
  }
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 2; ++kk)
    if (kk < nk)
      Wgmma<TN>::rs(acc, q[kk], db + 2 * kk, !first || kk > 0);
}

// The same slice with A through shared memory: the consumer's 128 threads
// quantize its 64 x 64 bf16 into an int8 buffer (64-byte rows, 64-byte
// swizzle), then both operands come from descriptors.
template <int TN>
__device__ __forceinline__ void slice_smem(int (&acc)[TN / 2],
                                           const uint8_t* xs, uint8_t* ab,
                                           uint32_t ab_s, uint64_t db,
                                           int nk, bool first,
                                           __nv_bfloat162 inv2, int t128,
                                           int cw) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = t128 + 128 * i, row = c >> 3, ch = c & 7;
    const uint4 v = *reinterpret_cast<const uint4*>(
        xs + row * 128 + ((ch ^ (row & 7)) << 4));
    *reinterpret_cast<uint2*>(
        ab + row * 64 + (((ch >> 1) ^ ((row >> 1) & 3)) << 4) +
        8 * (ch & 1)) = make_uint2(quant4(v.x, v.y, inv2),
                                   quant4(v.z, v.w, inv2));
  }
  hopper::fence_proxy_async();
  named_sync(1 + cw);
  hopper::wgmma_fence();
  const uint64_t da = desc_kmajor(ab_s, 64);
#pragma unroll
  for (int kk = 0; kk < 2; ++kk)
    if (kk < nk)
      Wgmma<TN>::ss(acc, da + 2 * kk, db + 2 * kk, !first || kk > 0);
}

// Split K: adds this unit's sums into the tile's workspace. True for the
// unit that completes the tile, which then holds the whole sums in acc and
// leaves the workspace and the counter at zero for the next launch.
template <int TN, int CONS>
__device__ __forceinline__ bool reduce(int (&acc)[TN / 2], const Int8Args& p,
                                       int tile, int cw, int t128,
                                       volatile int* flag) {
  const int slot = tile * CONS + cw;
  int* const w = p.ws + static_cast<long long>(slot) * 64 * TN + t128;
#pragma unroll
  for (int i = 0; i < TN / 2; ++i) atomicAdd(w + 128 * i, acc[i]);
  __threadfence();
  named_sync(1 + cw);
  if (t128 == 0) flag[cw] = atomicAdd(p.counters + slot, 1) == p.split - 1;
  named_sync(1 + cw);
  if (!flag[cw]) return false;
  __threadfence();
#pragma unroll
  for (int i = 0; i < TN / 2; ++i) {
    acc[i] = __ldcg(w + 128 * i);
    __stcg(w + 128 * i, 0);
  }
  if (t128 == 0) p.counters[slot] = 0;
  return true;
}

// (float)acc (exact below 2^24, rounded to nearest above), then the
// epilogue op by op. Below 2^22 the conversion is the float32 add of the
// integer to 1.5 * 2^23's bits and a subtraction, exact and cheaper than
// the conversion unit.
__device__ __forceinline__ float dequant(int acc, float d, float s, float b,
                                         const Int8Args& p) {
  const float a =
      p.exact_add ? __fsub_rn(__int_as_float(acc + 0x4B400000), kRound)
                  : __int2float_rn(acc);
  float y = __fmul_rn(a, d);
  if (p.scale != nullptr) y = __fmul_rn(y, s);
  if (p.shift != nullptr) y = __fadd_rn(y, b);
  return apply_act(y, p.act);
}

struct Unit {
  int mt, nt, k0, k1;   // output tile, K steps [k0, k1)
};

__device__ __forceinline__ Unit unit_of(int u, const Int8Args& p) {
  const int r = u / p.n_tiles;
  const int k0 = (r % p.split) * p.per;
  return {r / p.split, u % p.n_tiles, k0, min(p.ksteps, k0 + p.per)};
}

template <int TN, int CONS>
__global__ void
__launch_bounds__(Layout<TN, CONS>::THREADS, CONS == 2 ? 2 : 3)
    matmul_int8_tma(const __grid_constant__ CUtensorMap tm_x,
                    const __grid_constant__ CUtensorMap tm_w,
                    const __grid_constant__ CUtensorMap tm_out,
                    const Int8Args p) {
  using L = Layout<TN, CONS>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - raw);
  const uint32_t full = base + L::OFF_BAR, empty = full + L::Q_STAGES * 8;
  volatile int* const flag =
      reinterpret_cast<int*>(gbase + L::OFF_BAR + 2 * L::Q_STAGES * 8);
  const int units = p.m_tiles * p.split * p.n_tiles;

  if (threadIdx.x == 0) {
    for (int s = 0; s < L::Q_STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, CONS * 4);  // lane 0 of each consumer warp
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= CONS * 128) {
    // Producer: one thread walks the block's units and their slices, a
    // stage at a time, as soon as the consumers have released it.
    if (threadIdx.x == CONS * 128) {
      int stage = 0, phase = 0;
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        const Unit w = unit_of(u, p);
        for (int st = w.k0; st < w.k1; st += 2) {
          const uint32_t at = base + stage * L::STAGE_BYTES;
          mbar_wait(empty + 8 * stage, phase ^ 1);
          mbar_expect_tx(full + 8 * stage, L::STAGE_BYTES);
          hopper::tma_load(at, &tm_x, 32 * st, w.mt * L::BM, full + 8 * stage);
          hopper::tma_load(at + L::X_BYTES, &tm_w, 32 * st, w.nt * TN,
                           full + 8 * stage);
          if (++stage == L::Q_STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  // Consumers: warpgroup cw owns rows cw * 64 .. cw * 64 + 63 of each tile.
  const int cw = threadIdx.x / 128;
  const int t128 = threadIdx.x % 128;
  const int wl = t128 / 32;  // warp within the warpgroup
  const int lane = threadIdx.x % 32;
  const int gq = lane >> 2, tq = lane & 3;
  const __nv_bfloat162 inv2 = __float2bfloat162_rn(p.inv);
  const uint32_t out_s = base + L::OFF_OUT + cw * L::OUT_BYTES;
  uint8_t* const out_g = gbase + L::OFF_OUT + cw * L::OUT_BYTES;
  int acc[TN / 2];
  uint32_t q[2][4];   // the slice's A fragments (A from registers)
  int stage = 0, phase = 0;
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const Unit w = unit_of(u, p);
    // A from registers: a stage is released once its wgmma group has
    // completed. A from shared memory: one group stays in flight, and a
    // stage is released once the group after it has been issued and the
    // group reading it has completed.
    int prev = -1;
    for (int st = w.k0; st < w.k1; st += 2) {
      const int nk = min(2, w.k1 - st);
      const uint32_t at = base + stage * L::STAGE_BYTES;
      const uint8_t* xs = gbase + (at - base) + cw * 64 * 128;
      const uint64_t db = desc_kmajor(at + L::X_BYTES, 64);
      mbar_wait(full + 8 * stage, phase);
      if constexpr (L::A_SMEM) {
        // the A buffer of the slice's parity in the unit
        const int a = L::OFF_A + cw * L::A_BYTES +
                      ((st - w.k0) >> 1 & 1) * (L::A_BYTES / 2);
        slice_smem<TN>(acc, xs, gbase + a, base + a, db, nk, st == w.k0,
                       inv2, t128, cw);
      } else {
        slice_regs<TN>(acc, q, xs, db, nk, st == w.k0, inv2, wl, gq, tq);
      }
      hopper::wgmma_commit();
      if constexpr (L::A_SMEM) {
        hopper::wgmma_wait<1>();
        if (prev >= 0 && lane == 0) mbar_arrive(empty + 8 * prev);
        prev = stage;
      } else {
        hopper::wgmma_wait<0>();
        if (lane == 0) mbar_arrive(empty + 8 * stage);
      }
      if (++stage == L::Q_STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
    if constexpr (L::A_SMEM) {
      hopper::wgmma_wait<0>();
      if (lane == 0) mbar_arrive(empty + 8 * prev);
    }
    if (p.split > 1 && !reduce<TN, CONS>(acc, p, w.mt * p.n_tiles + w.nt,
                                         cw, t128, flag))
      continue;

    // Epilogue: acc[4j + 2h + e] sits at row 16 wl + gq + 8h, column 8j +
    // 2tq + e. Box 8j / BOXW holds columns BOXW (8j / BOXW) .. + BOXW - 1
    // as 64 rows of 2 BOXW bytes whose 16-byte chunks are swizzled by the
    // row (128-byte swizzle: row % 8; 32-byte: row / 4 % 2). The last
    // unit's store must have read the boxes first.
    if (t128 == 0) hopper::tma_store_wait_read();
    named_sync(1 + cw);
    const int n0 = w.nt * TN;
#pragma unroll
    for (int j = 0; j < TN / 8; ++j) {
      const int col = n0 + 8 * j + 2 * tq;
      float d0 = 0.0f, d1 = 0.0f, s0 = 1.0f, s1 = 1.0f, b0 = 0.0f, b1 = 0.0f;
      if (col < p.N) {  // N % 8 == 0: the pair is whole or out
        d0 = __fmul_rn(p.eff, __ldg(p.sw + col));
        d1 = __fmul_rn(p.eff, __ldg(p.sw + col + 1));
        if (p.scale != nullptr) {
          s0 = __ldg(p.scale + col);
          s1 = __ldg(p.scale + col + 1);
        }
        if (p.shift != nullptr) {
          b0 = __ldg(p.shift + col);
          b1 = __ldg(p.shift + col + 1);
        }
      }
      const int box = 8 * j / L::BOXW, chunk = 8 * j % L::BOXW / 8;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = 16 * wl + gq + 8 * h;
        const int swz =
            L::BOXW == 64 ? chunk ^ (row & 7) : chunk ^ ((row >> 2) & 1);
        *reinterpret_cast<uint32_t*>(out_g + box * L::BOX_BYTES +
                                     row * L::BOXW * 2 + (swz << 4) +
                                     4 * tq) =
            pack_bf16(dequant(acc[4 * j + 2 * h], d0, s0, b0, p),
                      dequant(acc[4 * j + 2 * h + 1], d1, s1, b1, p));
      }
    }
    hopper::fence_proxy_async();
    named_sync(1 + cw);
    const int m0 = w.mt * L::BM + cw * 64;
    if (t128 == 0 && m0 < p.M) {
      for (int b = 0; b < TN / L::BOXW; ++b)
        if (n0 + b * L::BOXW < p.N)
          hopper::tma_store(&tm_out, out_s + b * L::BOX_BYTES,
                            n0 + b * L::BOXW, m0);
      hopper::tma_store_commit();
    }
  }
  if (t128 == 0) hopper::tma_store_wait();
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

template <int TN, int CONS>
int launch_tma(const void* x, const void* wq, void* out, int M, int K, int Kp,
               int N, const Int8Args& p, cudaStream_t s) {
  using L = Layout<TN, CONS>;
  const PFN_cuTensorMapEncodeTiled fn = hopper::encode_fn();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap tm_x, tm_w, tm_out;
  if (!hopper::encode(fn, &tm_x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, M,
                      K, Q_SLICE, L::BM, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !hopper::encode(fn, &tm_w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, wq, N, Kp,
                      Q_SLICE, TN, CU_TENSOR_MAP_SWIZZLE_64B) ||
      !hopper::encode(fn, &tm_out, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, out,
                      M, N, L::BOXW, 64,
                      L::BOXW == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                                    : CU_TENSOR_MAP_SWIZZLE_32B))
    return static_cast<int>(cudaErrorInvalidValue);
  // per device: the blocks the card holds at once, once the shared-memory
  // limit is set (two blocks an SM of 128-row tiles, three of 64-row ones)
  static int resident[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (resident[dev] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaFuncSetAttribute(matmul_int8_tma<TN, CONS>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               L::SMEM);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, matmul_int8_tma<TN, CONS>, L::THREADS, L::SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    resident[dev] = sms * per_sm;
  }
  const long long units = static_cast<long long>(p.m_tiles) * p.split *
                          p.n_tiles;
  const unsigned grid = static_cast<unsigned>(
      units < resident[dev] ? units : resident[dev]);
  matmul_int8_tma<TN, CONS><<<grid, L::THREADS, L::SMEM, s>>>(tm_x, tm_w,
                                                              tm_out, p);
  return static_cast<int>(cudaGetLastError());
}

template <int CONS>
int launch_tma_width(int bn, const void* x, const void* wq, void* out, int M,
                     int K, int Kp, int N, const Int8Args& p,
                     cudaStream_t s) {
  switch (bn) {
    case 16: return launch_tma<16, CONS>(x, wq, out, M, K, Kp, N, p, s);
    case 32: return launch_tma<32, CONS>(x, wq, out, M, K, Kp, N, p, s);
    case 48: return launch_tma<48, CONS>(x, wq, out, M, K, Kp, N, p, s);
    case 64: return launch_tma<64, CONS>(x, wq, out, M, K, Kp, N, p, s);
    case 80: return launch_tma<80, CONS>(x, wq, out, M, K, Kp, N, p, s);
    case 96: return launch_tma<96, CONS>(x, wq, out, M, K, Kp, N, p, s);
    case 112: return launch_tma<112, CONS>(x, wq, out, M, K, Kp, N, p, s);
    case 128: return launch_tma<128, CONS>(x, wq, out, M, K, Kp, N, p, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int elem_bytes(int dtype) { return dtype == 1 ? 2 : 4; }

long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }

}  // namespace

// Which kernel ctt_matmul_int8 runs for these arguments: 2 "tma" (bf16, K
// and N multiples of 8, x and out 16-byte aligned), 1 "vector" (rows of x
// whole 16-byte vectors, x 16-byte aligned), 0 "scalar", -1 no kernel for
// this dtype.
extern "C" int ctt_matmul_int8_variant(const void* x, const void* out, int K,
                                       int N, int dtype) {
  if (dtype != 0 && dtype != 1) return -1;
  if (dtype == 1 && K % 8 == 0 && N % 8 == 0 && aligned16(x) &&
      aligned16(out))
    return 2;
  return (static_cast<long long>(K) * elem_bytes(dtype)) % 16 == 0 &&
                 aligned16(x)
             ? 1
             : 0;
}

// dtype: 0 float32, 1 bfloat16. wq (N, Kp) int8, Kp a multiple of 64 and at
// least K, 16-byte aligned. The "tma" kernel takes the wrapper's tile plan:
// bm (64 or 128) output rows and bn (a multiple of 16 up to 128) columns a
// tile, K cut into split ranges of per (even) 32-byte steps, and for
// split > 1 the zeroed workspace ws (ceil(M / bm) * ceil(N / bn) * bm * bn
// int32) and counters (ceil(M / bm) * ceil(N / bn) * bm / 64 int32), which
// it leaves zero; the other kernels ignore them. Returns the variant
// launched (as ctt_matmul_int8_variant: 2, 1 or 0), or minus the
// cudaError_t where the arguments or the launch fail.
extern "C" int ctt_matmul_int8(const void* x, const void* wq, const float* sw,
                               const float* scale, const float* shift,
                               void* out, int* ws, int* counters, int M,
                               int K, int Kp, int N, float inv, float eff,
                               int act, int dtype, int bm, int bn, int split,
                               int per, void* stream) {
  constexpr int kBadArgs = -static_cast<int>(cudaErrorInvalidValue);
  if (M <= 0 || N <= 0 || K <= 0 || Kp < K || Kp % BK != 0 ||
      act < kActNone || act > kActRelu6 || !aligned16(wq))
    return kBadArgs;
  const int v = ctt_matmul_int8_variant(x, out, K, N, dtype);
  if (v < 0) return kBadArgs;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err;
  if (v == 2) {
    const long long ksteps = ceil_div(K, 32);
    if ((bm != 64 && bm != 128) || bn < 16 || bn > 128 || bn % 16 != 0 ||
        split < 1 || per < 2 || per % 2 != 0 ||
        static_cast<long long>(split - 1) * per >= ksteps ||
        static_cast<long long>(split) * per < ksteps ||
        (split > 1 && (ws == nullptr || counters == nullptr)))
      return kBadArgs;
    const long long m_tiles = ceil_div(M, bm), n_tiles = ceil_div(N, bn);
    if (m_tiles * split * n_tiles > 0x7fffffffLL)
      return -static_cast<int>(cudaErrorInvalidConfiguration);
    const Int8Args p{sw, scale, shift, ws, counters, M, N,
                     static_cast<int>(ksteps), static_cast<int>(m_tiles),
                     static_cast<int>(n_tiles), split, per, inv, eff, act,
                     ksteps * 32 * 127 * 127 < (1LL << 22)};
    err = bm == 128 ? launch_tma_width<2>(bn, x, wq, out, M, K, Kp, N, p, s)
                    : launch_tma_width<1>(bn, x, wq, out, M, K, Kp, N, p, s);
  } else if (dtype == 1) {
    err = launch<__nv_bfloat16>(x, wq, sw, scale, shift, out, M, K, Kp, N,
                                inv, eff, act, v == 1, s);
  } else {
    err = launch<float>(x, wq, sw, scale, shift, out, M, K, Kp, N, inv, eff,
                        act, v == 1, s);
  }
  return err == 0 ? v : -err;
}
