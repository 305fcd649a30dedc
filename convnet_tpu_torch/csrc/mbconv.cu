// The fused inverted residual (MobileNet-V2's stride-1 MBConv block) for
// Hopper (sm_90a): one kernel family, three modes.
//
// Replaces the three Pallas TPU kernels of convnet_tpu/ops/pallas/mbconv.py,
// which share one body (the haloed row block, the expand, the padding mask
// and the 9-tap depthwise, mbconv.py:85-128) and differ after the depthwise:
//
//   Full  (_build_full, pallas_call at line 180; mbconv_infer)
//         y = act_out(project(u2) * s3 + t3 [+ x]) in x's type
//   Stats (_build_stats, pallas_call at line 310; mbconv_train_forward)
//         the per-channel sum and sum of squares of the depthwise output d
//   Raw   (_build_raw, pallas_call at line 246; mbconv_train_forward)
//         h3 = project(u2) in x's type, and the per-channel sum and sum of
//         squares of h3 taken from its float32 values before rounding
//
// where, on NHWC x (B, H, W, Cin):
//   u1 = act_mid(x @ we * s1 + t1), zero outside the image   (hidden, float32;
//        without an expand stage u1 = x, zero outside the image)
//   d  = sum over the 3x3 taps (di outer, dj inner) of u1 * wd   (float32)
//   u2 = act_mid(d * s2 + t2), rounded to x's type
//   project(u2) = u2 @ wp, accumulated in float32.
// we (Cin, Ch) and wp (Ch, Cout) are in x's type, wd (9, Ch) and the
// per-channel s*, t* are float32. The zero outside the image comes after the
// BN and the activation (mbconv.py:26-28, 107): a padded pixel is 0 in the
// hidden tensor, not act(t1). Multiplies and adds of the BN, the depthwise
// and the epilogue are rounded one by one (__fmul_rn, __fadd_rn), as the
// plain version's separate ops are; the two products are float32 sums of
// exact products, in an order of their own.
//
// What bounds it on an H100. At MobileNet-V2's 13 stride-1 blocks, batch 64
// and bf16, the blocks read x and write y, about 143 MB (0.051 ms at 3.35
// TB/s), against about 25.7 GFLOP in the two products (0.026 ms on the bf16
// tensor cores, 0.38 ms at the 67 TFLOP/s float32 rate of the CUDA cores).
// What cannot leave the CUDA cores is the depthwise and the three BNs:
// about 117 M hidden values a forward, each 9 multiplies and 9 adds rounded
// one by one plus the BN and activation steps, some 30 instructions a value
// (about 0.13 ms of issue at the card's FP32 rate).
//
// Two kernels, picked by a stated shape rule (`tc_ok`), never on failure:
//
// * Tensor cores (bf16; Cin and Cout multiples of 8, Cout <= 320, Ch of 4;
//   an expand stage or Cin == Ch; x 16-byte aligned; the staging fits a
//   block): every block of MobileNet-V2. A work item is an output tile of
//   at most 8 x 8 pixels of one image, a slab of the hidden channels (one
//   slab, or several where the tiles alone cannot fill the card: the 7x7
//   blocks), and a part of Cout (one, or two where Cout > 160). A
//   persistent grid of 8-warp blocks, two an SM (three for Stats, whose
//   registers allow it), walks the items. A block stages the tile's haloed
//   x (bf16, zero outside the image and past Cin up to a multiple of 16)
//   with cp.async into one of two buffers, so the copies of its next item
//   fly while it computes this one, and walks its slab in chunks of 32
//   hidden channels:
//     - the expand on mma.sync m16n8k16 (A through ldmatrix from the staged
//       tile, B the chunk of we packed as (Ch, Cin) rows, zeros in the
//       padding), then BN1, the activation and the mask in float32 into u1
//       (shared memory, float32);
//     - the 9 taps on the CUDA cores: a warp per output column, a lane per
//       channel, walking down the rows; each u1 row read feeds the three
//       output rows it belongs to, whose sums stay in registers;
//     - BN2, the activation and the rounding to bf16 into u2 (shared
//       memory), or the chunk's sums of d (Stats);
//     - the project on mma.sync: u2 times the chunk of wp packed as (Cout,
//       Ch) rows, into float32 fragments that stay in registers across the
//       chunks. The kernel is instantiated per Cout class (32, 64, 96,
//       160 channels a part: 2, 4, 6 or 10 n8 fragments a warp), so a
//       narrow block carries no dead accumulators.
//   The chunk's weights and per-channel vectors (s1, t1, s2, t2 and the 9
//   taps, double-buffered) come with cp.async too: the expand's and the
//   vectors for chunk k + 1 while chunk k's taps and project run, the
//   project's for chunk k while its expand and taps run; the next item's x
//   flies over the whole item. Where the hidden channels are split,
//   each slab writes its float32 project sums to a scratch buffer and a
//   second kernel adds the slabs in order and runs the epilogue.
// * CUDA cores (float32, whose products tensor cores would round to TF32;
//   bf16 shapes outside the rule): the first design, kept. A block of 256
//   threads owns a tile of TH x TW output pixels of one image (TH * TW <=
//   64, (TH + 2) * (TW + 2) <= 104), stages its haloed input, all Cin
//   channels, in shared memory once, then walks the hidden channels in
//   chunks of 32 with both products as float32 FMAs (each thread owns 8
//   pixels x up to 10 output channels, so Cout <= 320).
//
// Sums (Stats, Raw) are written per tile and reduced by a third kernel in a
// fixed order, without atomics, so two runs give bit-equal statistics.
//
// Plain C interface, no PyTorch headers: built with nvcc into a shared
// library and called through ctypes (convnet_tpu_torch/ops/kernels).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int CHUNK = 32;            // hidden channels per step
constexpr int MAX_Q = 64;            // output pixels per tile
constexpr int MAX_P = 104;           // haloed pixels per tile
constexpr int NQ = MAX_Q / WARPS;    // output pixels per thread
constexpr int NP = MAX_P / WARPS;    // haloed pixels per thread
constexpr int MAX_NJ = 10;           // output-channel groups of 32 a thread
constexpr int MAX_SMEM = 232448;     // the H100's opt-in limit per block

enum Mode { kFull = 0, kStats = 1, kRaw = 2 };

struct Geom {
  int B, H, W, Cin, Ch, Cout, TH, TW;
  int tiles_h, tiles_w, cin_pad, cout_pad, nj, P, Q;
  int act_mid, act_out;
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

__device__ __forceinline__ float act(float v, int kind) {
  if (kind == 1) return fmaxf(v, 0.0f);
  if (kind == 2) return fminf(fmaxf(v, 0.0f), 6.0f);
  return v;
}

// v * s + t, each step rounded, as the plain version's two ops
__device__ __forceinline__ float affine(float v, float s, float t) {
  return __fadd_rn(__fmul_rn(v, s), t);
}

// Both kernels' arguments. The tensor-core kernel takes we and wp packed:
// we (ceil32(Ch), ceil16(Cin)) holding we[k][c] at [c][k], wp (Cout,
// ceil32(Ch)) holding wp[c][o] at [o][c], zeros in the padding.
struct Args {
  const void* x;
  const void* we;   // (Cin, Ch) in x's type, or null: no expand stage
  const float* s1;
  const float* t1;
  const float* wd;  // (9, Ch)
  const float* s2;
  const float* t2;
  const void* wp;   // (Ch, Cout) in x's type
  const float* s3;
  const float* t3;
  void* out;        // Full: y; Raw: h3 (B, H, W, Cout) in x's type
  float* part;      // tensor cores, split > 1: the slabs' project sums
  float* partials;  // Stats, Raw: (tiles, 2, C), C = Ch or Cout
  float* sums;      // Stats, Raw: (2, C), the partials reduced
};

size_t smem_bytes(const Geom& g, int mode, bool expand) {
  size_t f = (size_t)g.P * g.cin_pad + (size_t)g.P * CHUNK +
             (size_t)MAX_Q * CHUNK;
  if (expand) f += (size_t)g.cin_pad * CHUNK;
  if (mode != kStats) f += (size_t)CHUNK * g.cout_pad;
  return f * sizeof(float);
}

template <typename T, int MODE, bool EXPAND, bool RESIDUAL>
__global__ void __launch_bounds__(THREADS, 1)
    mbconv_kernel(const Args a, const Geom g) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);     // P x cin_pad
  float* hid = xs + g.P * g.cin_pad;               // P x CHUNK
  float* u2s = hid + g.P * CHUNK;                  // MAX_Q x CHUNK
  float* wes = u2s + MAX_Q * CHUNK;                // cin_pad x CHUNK
  float* wps = wes + (EXPAND ? g.cin_pad * CHUNK : 0);  // CHUNK x cout_pad

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int blk = blockIdx.x;
  const int tj = blk % g.tiles_w;
  const int ti = (blk / g.tiles_w) % g.tiles_h;
  const int b = blk / (g.tiles_w * g.tiles_h);
  const int r0 = ti * g.TH;
  const int q0 = tj * g.TW;
  const int PW = g.TW + 2;
  const T* x = static_cast<const T*>(a.x);

  // the haloed input tile, zero outside the image and beyond Cin
  for (int e = tid; e < g.P * g.cin_pad; e += THREADS) {
    const int p = e / g.cin_pad, k = e - p * g.cin_pad;
    const int gr = r0 - 1 + p / PW, gc = q0 - 1 + p % PW;
    float v = 0.0f;
    if (k < g.Cin && gr >= 0 && gr < g.H && gc >= 0 && gc < g.W)
      v = to_f32(x[((size_t)(b * g.H + gr) * g.W + gc) * g.Cin + k]);
    xs[e] = v;
  }

  float acc[NQ][MAX_NJ];  // Full, Raw: the project product
#pragma unroll
  for (int i = 0; i < NQ; ++i)
#pragma unroll
    for (int j = 0; j < MAX_NJ; ++j) acc[i][j] = 0.0f;

  for (int c0 = 0; c0 < g.Ch; c0 += CHUNK) {
    const int ch = c0 + lane;
    const bool cval = ch < g.Ch;
    if (EXPAND) {
      const T* we = static_cast<const T*>(a.we);
      for (int e = tid; e < g.cin_pad * CHUNK; e += THREADS) {
        const int k = e / CHUNK, c = c0 + e % CHUNK;
        wes[e] = (k < g.Cin && c < g.Ch) ? to_f32(we[(size_t)k * g.Ch + c])
                                          : 0.0f;
      }
    }
    if (MODE != kStats) {
      const T* wp = static_cast<const T*>(a.wp);
      for (int e = tid; e < CHUNK * g.cout_pad; e += THREADS) {
        const int k = e / g.cout_pad, o = e - k * g.cout_pad;
        wps[e] = (c0 + k < g.Ch && o < g.Cout)
                     ? to_f32(wp[(size_t)(c0 + k) * g.Cout + o])
                     : 0.0f;
      }
    }
    __syncthreads();

    // u1 on the haloed pixels: expand, BN, activation, then the mask
    if (EXPAND) {
      float h[NP];
#pragma unroll
      for (int i = 0; i < NP; ++i) h[i] = 0.0f;
      for (int k = 0; k < g.cin_pad; k += 4) {
        const float w0 = wes[(k + 0) * CHUNK + lane];
        const float w1 = wes[(k + 1) * CHUNK + lane];
        const float w2 = wes[(k + 2) * CHUNK + lane];
        const float w3 = wes[(k + 3) * CHUNK + lane];
#pragma unroll
        for (int i = 0; i < NP; ++i) {
          const int p = warp + WARPS * i;
          if (p < g.P) {
            const float4 xv =
                *reinterpret_cast<const float4*>(xs + p * g.cin_pad + k);
            h[i] = fmaf(xv.x, w0, h[i]);
            h[i] = fmaf(xv.y, w1, h[i]);
            h[i] = fmaf(xv.z, w2, h[i]);
            h[i] = fmaf(xv.w, w3, h[i]);
          }
        }
      }
      const float s1 = cval ? a.s1[ch] : 0.0f;
      const float t1 = cval ? a.t1[ch] : 0.0f;
#pragma unroll
      for (int i = 0; i < NP; ++i) {
        const int p = warp + WARPS * i;
        if (p < g.P) {
          const int gr = r0 - 1 + p / PW, gc = q0 - 1 + p % PW;
          const bool inside = gr >= 0 && gr < g.H && gc >= 0 && gc < g.W;
          hid[p * CHUNK + lane] =
              (inside && cval) ? act(affine(h[i], s1, t1), g.act_mid) : 0.0f;
        }
      }
    } else {
      for (int p = warp; p < g.P; p += WARPS)  // xs is already 0 outside
        hid[p * CHUNK + lane] = cval ? xs[p * g.cin_pad + ch] : 0.0f;
    }
    __syncthreads();

    // the 9 taps on the output pixels
    float wd[9];
#pragma unroll
    for (int t = 0; t < 9; ++t) wd[t] = cval ? a.wd[t * g.Ch + ch] : 0.0f;
    const float s2 = (MODE != kStats && cval) ? a.s2[ch] : 0.0f;
    const float t2 = (MODE != kStats && cval) ? a.t2[ch] : 0.0f;
    float sum = 0.0f, sq = 0.0f;
#pragma unroll
    for (int i = 0; i < NQ; ++i) {
      const int q = warp + WARPS * i;
      if (q >= g.Q) continue;
      const int qr = q / g.TW, qc = q - qr * g.TW;
      const float* base = hid + (qr * PW + qc) * CHUNK + lane;
      float d = __fmul_rn(base[0], wd[0]);
#pragma unroll
      for (int t = 1; t < 9; ++t)
        d = __fadd_rn(d, __fmul_rn(base[((t / 3) * PW + t % 3) * CHUNK],
                                   wd[t]));
      if (MODE == kStats) {
        if (cval && r0 + qr < g.H && q0 + qc < g.W) {
          sum += d;
          sq = fmaf(d, d, sq);
        }
      } else {
        const float u = to_f32(from_f32<T>(act(affine(d, s2, t2), g.act_mid)));
        u2s[q * CHUNK + lane] = cval ? u : 0.0f;
      }
    }

    if (MODE == kStats) {  // this chunk's sums: warps in a fixed order
      float* red = u2s;    // WARPS x CHUNK sums, then WARPS x CHUNK squares
      red[warp * CHUNK + lane] = sum;
      red[(WARPS + warp) * CHUNK + lane] = sq;
      __syncthreads();
      if (tid < CHUNK && c0 + tid < g.Ch) {
        float s = 0.0f, s2sum = 0.0f;
        for (int w = 0; w < WARPS; ++w) {
          s += red[w * CHUNK + tid];
          s2sum += red[(WARPS + w) * CHUNK + tid];
        }
        a.partials[((size_t)blk * 2) * g.Ch + c0 + tid] = s;
        a.partials[((size_t)blk * 2 + 1) * g.Ch + c0 + tid] = s2sum;
      }
    } else {
      __syncthreads();
      // the chunk's project product into the float32 accumulators
      for (int k = 0; k < CHUNK; k += 4) {
        float4 u[NQ];
#pragma unroll
        for (int i = 0; i < NQ; ++i) {
          const int q = warp + WARPS * i;
          u[i] = q < g.Q ? *reinterpret_cast<const float4*>(u2s + q * CHUNK + k)
                         : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        }
#pragma unroll
        for (int j = 0; j < MAX_NJ; ++j) {
          if (j < g.nj) {
            const float* wrow = wps + k * g.cout_pad + lane + 32 * j;
            const float w0 = wrow[0], w1 = wrow[g.cout_pad],
                        w2 = wrow[2 * g.cout_pad], w3 = wrow[3 * g.cout_pad];
#pragma unroll
            for (int i = 0; i < NQ; ++i) {
              acc[i][j] = fmaf(u[i].x, w0, acc[i][j]);
              acc[i][j] = fmaf(u[i].y, w1, acc[i][j]);
              acc[i][j] = fmaf(u[i].z, w2, acc[i][j]);
              acc[i][j] = fmaf(u[i].w, w3, acc[i][j]);
            }
          }
        }
      }
    }
    __syncthreads();
  }

  if (MODE == kStats) return;

  // epilogue: y (Full) or h3 and its sums (Raw), each in x's type
  T* out = static_cast<T*>(a.out);
  float sum[MAX_NJ], sq[MAX_NJ];
#pragma unroll
  for (int j = 0; j < MAX_NJ; ++j) sum[j] = sq[j] = 0.0f;
#pragma unroll
  for (int i = 0; i < NQ; ++i) {
    const int q = warp + WARPS * i;
    if (q >= g.Q) continue;
    const int qr = q / g.TW, qc = q - qr * g.TW;
    const int gr = r0 + qr, gc = q0 + qc;
    if (gr >= g.H || gc >= g.W) continue;
    T* orow = out + ((size_t)(b * g.H + gr) * g.W + gc) * g.Cout;
    const float* xrow = xs + ((qr + 1) * PW + qc + 1) * g.cin_pad;
#pragma unroll
    for (int j = 0; j < MAX_NJ; ++j) {
      const int o = lane + 32 * j;
      if (j >= g.nj || o >= g.Cout) continue;
      float v = acc[i][j];
      if (MODE == kFull) {
        v = affine(v, a.s3[o], a.t3[o]);
        if (RESIDUAL) v = __fadd_rn(v, xrow[o]);
        v = act(v, g.act_out);
      } else {
        sum[j] += v;
        sq[j] = fmaf(v, v, sq[j]);
      }
      orow[o] = from_f32<T>(v);
    }
  }
  if (MODE == kRaw) {  // the block's sums: warps in a fixed order
    float* red = wps;  // WARPS x cout_pad sums, then WARPS x cout_pad squares
#pragma unroll
    for (int j = 0; j < MAX_NJ; ++j) {
      if (j < g.nj) {
        red[warp * g.cout_pad + lane + 32 * j] = sum[j];
        red[(WARPS + warp) * g.cout_pad + lane + 32 * j] = sq[j];
      }
    }
    __syncthreads();
    for (int o = tid; o < g.Cout; o += THREADS) {
      float s = 0.0f, s2sum = 0.0f;
      for (int w = 0; w < WARPS; ++w) {
        s += red[w * g.cout_pad + o];
        s2sum += red[(WARPS + w) * g.cout_pad + o];
      }
      a.partials[((size_t)blk * 2) * g.Cout + o] = s;
      a.partials[((size_t)blk * 2 + 1) * g.Cout + o] = s2sum;
    }
  }
}

// sums[c] = sum over blocks of partials[block][c], c < cols (= 2 C): each
// thread adds a fixed stride of blocks in order, then 32 rows in order.
__global__ void __launch_bounds__(1024)
    mbconv_reduce_kernel(const float* __restrict__ partials,
                         float* __restrict__ sums, int blocks, int cols) {
  __shared__ float red[32][33];
  const int col = blockIdx.x * 32 + threadIdx.x;
  float s = 0.0f;
  if (col < cols)
    for (int r = threadIdx.y; r < blocks; r += 32)
      s += partials[(size_t)r * cols + col];
  red[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && col < cols) {
    float t = 0.0f;
    for (int r = 0; r < 32; ++r) t += red[r][threadIdx.x];
    sums[col] = t;
  }
}

template <typename T, int MODE, bool EXPAND, bool RESIDUAL>
int launch_main(const Args& a, const Geom& g, cudaStream_t s) {
  const size_t smem = smem_bytes(g, MODE, EXPAND);
  auto kernel = mbconv_kernel<T, MODE, EXPAND, RESIDUAL>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks = (unsigned)(g.B * g.tiles_h * g.tiles_w);
  kernel<<<blocks, THREADS, smem, s>>>(a, g);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int MODE>
int dispatch(const Args& a, const Geom& g, bool residual, cudaStream_t s) {
  const bool expand = a.we != nullptr;
  if constexpr (MODE == kFull) {
    if (residual)
      return expand ? launch_main<T, MODE, true, true>(a, g, s)
                    : launch_main<T, MODE, false, true>(a, g, s);
  }
  return expand ? launch_main<T, MODE, true, false>(a, g, s)
                : launch_main<T, MODE, false, false>(a, g, s);
}

int reduce(const float* partials, float* sums, int rows, int c,
           cudaStream_t s) {
  const int cols = 2 * c;
  mbconv_reduce_kernel<<<(cols + 31) / 32, dim3(32, 32), 0, s>>>(
      partials, sums, rows, cols);
  return static_cast<int>(cudaGetLastError());
}

// Checks the dimensions and fills the derived ones; false if the kernel
// cannot take them.
bool make_geom(Geom* g, int mode, bool expand, bool residual) {
  if (g->B <= 0 || g->H <= 0 || g->W <= 0 || g->Cin <= 0 || g->Ch <= 0 ||
      g->TH <= 0 || g->TW <= 0)
    return false;
  if (mode != kStats && (g->Cout <= 0 || g->Cout > 32 * MAX_NJ)) return false;
  if (!expand && g->Cin != g->Ch) return false;
  if (residual && g->Cin != g->Cout) return false;
  if (g->act_mid < 0 || g->act_mid > 2 || g->act_out < 0 || g->act_out > 2)
    return false;
  g->tiles_h = (g->H + g->TH - 1) / g->TH;
  g->tiles_w = (g->W + g->TW - 1) / g->TW;
  g->cin_pad = (g->Cin + 3) / 4 * 4;
  g->nj = mode == kStats ? 0 : (g->Cout + 31) / 32;
  g->cout_pad = 32 * g->nj;
  g->P = (g->TH + 2) * (g->TW + 2);
  g->Q = g->TH * g->TW;
  if (g->Q > MAX_Q || g->P > MAX_P) return false;
  if ((long long)g->B * g->tiles_h * g->tiles_w > 0x7fffffffLL) return false;
  return smem_bytes(*g, mode, expand) <= (size_t)MAX_SMEM;
}

// ------------------------------------------------------- tensor-core kernel

constexpr int TC_CHUNK = 32;          // hidden channels a step
constexpr int TC_TILE = 8;            // output tile side, at most
constexpr int TC_MAX_P = (TC_TILE + 2) * (TC_TILE + 2);  // haloed pixels
constexpr int TC_MAX_Q = 64;          // output pixels: four m16 tiles
constexpr int HS = TC_CHUNK + 8;      // u1 (float) and u2, wp (bf16) rows
constexpr int TC_MAX_SPLIT = 8;       // hidden slabs, at most
constexpr int NVEC = 13;              // a chunk's vectors: s1, t1, s2, t2, wd

typedef __nv_bfloat16 bf16;

// Output channels a Cout part: 2, 4, 6 or 10 n8 fragments a warp, two warps
// across the part.
int cout_block(int cout) {
  return cout <= 32 ? 32 : cout <= 64 ? 64 : cout <= 96 ? 96 : 160;
}

// n / d for 0 <= n < 2^31 by a multiply and a shift (d >= 1), the magic
// number found once on the host: m = ceil(2^p / d), p = 31 + ceil(log2 d).
struct FastDiv {
  int d;
  uint32_t mul, shr;
};

FastDiv fast_div(int d) {
  FastDiv f{d, 0, 0};
  if (d > 1) {
    int l = 0;
    while ((1u << l) < (unsigned)d) ++l;
    f.mul = (uint32_t)(((1ull << (31 + l)) + d - 1) / d);
    f.shr = l - 1;
  }
  return f;
}

__device__ __forceinline__ int fdiv(int n, const FastDiv& f) {
  return f.d == 1 ? n : (int)(__umulhi((uint32_t)n, f.mul) >> f.shr);
}

struct TcGeom {
  int B, H, W, Cin, Ch, Cout;
  int TH, TW, PW, P, Q, tiles_h, tiles_w, tiles;
  int cin_pad, xs_stride;     // K of the expand (Cin up to 16); staged row
  int ch_pad, chunks;         // Ch up to a whole chunk; chunks
  int split, cps;             // hidden slabs; chunks a slab
  int cout_blk, nparts;       // output channels a part; parts
  int items;                  // tiles x split x nparts
  int expand, residual, act_mid, act_out;
  int xs_bytes, off_we, off_wp, off_u1, off_u2, off_red, off_vec, smem;
  int pieces, step, step_r, step_c;  // 8-channel pieces of a row; THREADS /
                                     // pieces, as halo rows and columns
  FastDiv f_parts, f_split, f_tw, f_th, f_pw, f_pieces, f_tw_tile;
};

int tc_smem(int P, int cin_pad, int cout_blk, int mode, bool expand,
            int* off) {
  const int xs = P * (cin_pad + 8) * 2;
  int o = 2 * xs;
  off[0] = o;                                   // we: a chunk's rows
  o += expand ? TC_CHUNK * (cin_pad + 8) * 2 : 0;
  off[1] = o;                                   // wp: a chunk's columns
  o += mode != kStats ? cout_blk * HS * 2 : 0;
  off[2] = o;                                   // u1
  o += P * HS * 4;
  off[3] = o;                                   // u2
  o += mode != kStats ? TC_MAX_Q * HS * 2 : 0;
  off[4] = o;                                   // red
  o += mode == kStats ? 2 * WARPS * TC_CHUNK * 4
       : mode == kRaw ? 2 * 4 * cout_blk * 4 : 0;
  off[5] = o;                                   // vectors, two chunks'
  o += 2 * NVEC * TC_CHUNK * 4;
  return o;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// The shape rule: bf16 (tensor cores have no float32 product: TF32 would
// round it), 16-byte rows of x, of the output and of the per-channel
// vectors' chunks, Cout within the project's parts, and the staging of any
// tile within a block's shared memory.
bool tc_ok(int mode, int Cin, int Ch, int Cout, bool expand, int dtype,
           const void* x) {
  if (dtype != 1 || Cin <= 0 || Ch <= 0 || Cin % 8 != 0 || Ch % 4 != 0 ||
      !aligned16(x))
    return false;
  if (!expand && Cin != Ch) return false;
  if (mode != kStats && (Cout <= 0 || Cout % 8 != 0 || Cout > 32 * MAX_NJ))
    return false;
  int off[6];
  const int cb = mode != kStats ? cout_block(Cout) : 0;
  return tc_smem(TC_MAX_P, (Cin + 15) / 16 * 16, cb, mode, expand, off) <=
         MAX_SMEM;
}

// Fills the derived dimensions from B..Cout, TH, TW, split and the flags;
// false where the kernel cannot take them.
bool make_tc_geom(TcGeom* g, int mode) {
  if (g->B <= 0 || g->H <= 0 || g->W <= 0 || g->TH <= 0 || g->TW <= 0 ||
      g->TH > TC_TILE || g->TW > TC_TILE || g->split <= 0 ||
      g->split > TC_MAX_SPLIT)
    return false;
  if (g->residual && g->Cin != g->Cout) return false;
  if (g->act_mid < 0 || g->act_mid > 2 || g->act_out < 0 || g->act_out > 2)
    return false;
  g->PW = g->TW + 2;
  g->P = (g->TH + 2) * g->PW;
  g->Q = g->TH * g->TW;
  g->tiles_h = (g->H + g->TH - 1) / g->TH;
  g->tiles_w = (g->W + g->TW - 1) / g->TW;
  const long long tiles = (long long)g->B * g->tiles_h * g->tiles_w;
  g->cin_pad = (g->Cin + 15) / 16 * 16;
  g->xs_stride = g->cin_pad + 8;
  g->ch_pad = (g->Ch + TC_CHUNK - 1) / TC_CHUNK * TC_CHUNK;
  g->chunks = g->ch_pad / TC_CHUNK;
  // slabs of whole chunks, none empty: the caller's split must be the one
  // its chunks-a-slab gives back
  g->cps = (g->chunks + g->split - 1) / g->split;
  if ((g->chunks + g->cps - 1) / g->cps != g->split) return false;
  g->cout_blk = mode != kStats ? cout_block(g->Cout) : 0;
  g->nparts = mode != kStats ? (g->Cout + g->cout_blk - 1) / g->cout_blk : 1;
  const long long items = tiles * g->split * g->nparts;
  if (items > 0x7fffffffLL) return false;
  g->tiles = (int)tiles;
  g->items = (int)items;
  int off[6];
  g->smem = tc_smem(g->P, g->cin_pad, g->cout_blk, mode, g->expand != 0, off);
  g->xs_bytes = g->P * g->xs_stride * 2;
  g->off_we = off[0], g->off_wp = off[1], g->off_u1 = off[2];
  g->off_u2 = off[3], g->off_red = off[4], g->off_vec = off[5];
  g->pieces = g->cin_pad / 8;
  g->step = THREADS / g->pieces;
  g->step_r = g->step / g->PW, g->step_c = g->step % g->PW;
  g->f_parts = fast_div(g->nparts), g->f_split = fast_div(g->split);
  g->f_tw = fast_div(g->tiles_w), g->f_th = fast_div(g->tiles_h);
  g->f_pw = fast_div(g->PW), g->f_pieces = fast_div(g->pieces);
  g->f_tw_tile = fast_div(g->TW);
  return g->smem <= MAX_SMEM;
}

__device__ __forceinline__ void cp_async16(uint32_t smem, const void* gmem,
                                           bool valid) {
  const int src_bytes = valid ? 16 : 0;  // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
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

struct Item {
  int part, slab, tile, b, r0, q0;
};

// Item u: Cout parts fastest, then slabs, then tiles (so the blocks running
// together share a tile's x in L2).
__device__ __forceinline__ Item item_of(const TcGeom& g, int u) {
  Item t;
  int q = fdiv(u, g.f_parts);
  t.part = u - q * g.nparts;
  t.tile = fdiv(q, g.f_split);
  t.slab = q - t.tile * g.split;
  q = fdiv(t.tile, g.f_tw);
  const int tj = t.tile - q * g.tiles_w;
  t.b = fdiv(q, g.f_th);
  t.r0 = (q - t.b * g.tiles_h) * g.TH;
  t.q0 = tj * g.TW;
  return t;
}

// The haloed x of item u: P pixels x cin_pad channels, zeros outside the
// image and past Cin. Each thread copies one 8-channel piece of every
// step-th pixel, stepping its halo (row, column) rather than dividing.
__device__ __forceinline__ void stage_x(const Args& a, const TcGeom& g,
                                        uint32_t dst, int u) {
  const int p0 = fdiv(threadIdx.x, g.f_pieces);
  if (p0 >= g.step) return;
  const Item t = item_of(g, u);
  const bf16* x = static_cast<const bf16*>(a.x);
  const int k = (threadIdx.x - p0 * g.pieces) * 8;
  int r = fdiv(p0, g.f_pw);
  int c = p0 - r * g.PW;
  for (int p = p0; p < g.P; p += g.step) {
    const int gr = t.r0 - 1 + r, gc = t.q0 - 1 + c;
    const bool valid =
        k < g.Cin && gr >= 0 && gr < g.H && gc >= 0 && gc < g.W;
    const bf16* src =
        valid ? x + ((size_t)(t.b * g.H + gr) * g.W + gc) * g.Cin + k : x;
    cp_async16(dst + (p * g.xs_stride + k) * 2, src, valid);
    r += g.step_r;
    c += g.step_c;
    if (c >= g.PW) c -= g.PW, ++r;
  }
}

// Chunk kc of the packed expand weight: 32 rows of cin_pad.
__device__ __forceinline__ void stage_we(const Args& a, const TcGeom& g,
                                         uint32_t dst, int kc) {
  const int n0 = fdiv(threadIdx.x, g.f_pieces);
  const int k = (threadIdx.x - n0 * g.pieces) * 8;
  for (int n = n0; n < TC_CHUNK && n0 < g.step; n += g.step)
    cp_async16(dst + (n * g.xs_stride + k) * 2,
               static_cast<const bf16*>(a.we) +
                   (size_t)(kc * TC_CHUNK + n) * g.cin_pad + k,
               true);
}

// Chunk kc of the packed project weight for Cout part `part`: cout_blk rows
// of 32, zeros past Cout.
__device__ __forceinline__ void stage_wp(const Args& a, const TcGeom& g,
                                         uint32_t dst, int kc, int part) {
  const bf16* wp = static_cast<const bf16*>(a.wp);
  for (int e = threadIdx.x; e < g.cout_blk * 4; e += THREADS) {
    const int n = e >> 2, k = (e & 3) * 8;
    const int o = part * g.cout_blk + n;
    const bool valid = o < g.Cout;
    const bf16* src =
        valid ? wp + (size_t)o * g.ch_pad + kc * TC_CHUNK + k : wp;
    cp_async16(dst + (n * HS + k) * 2, src, valid);
  }
}

// Chunk kc's per-channel vectors: rows s1, t1, s2, t2 and the 9 rows of wd,
// 32 floats each, zeros past Ch and for a vector the mode has not.
__device__ __forceinline__ void stage_vec(const Args& a, const TcGeom& g,
                                          uint32_t dst, int kc) {
  for (int e = threadIdx.x; e < NVEC * TC_CHUNK / 4; e += THREADS) {
    const int row = e / (TC_CHUNK / 4), k = (e % (TC_CHUNK / 4)) * 4;
    const float* v = row == 0 ? a.s1 : row == 1 ? a.t1 : row == 2 ? a.s2
                   : row == 3 ? a.t2 : a.wd + (size_t)(row - 4) * g.Ch;
    const int c = kc * TC_CHUNK + k;
    const bool valid = v != nullptr && c < g.Ch;
    cp_async16(dst + (row * TC_CHUNK + k) * 4, valid ? v + c : a.wd, valid);
  }
}

// Blocks an SM the compiler keeps registers for: three (80 registers) for
// Stats, which has no project fragments; two (128) for Full and Raw, which
// spill at 80.
template <int MODE, int NW8>
__global__ void __launch_bounds__(THREADS, MODE == kStats ? 3 : 2)
    mbconv_tc(const Args a, const TcGeom g) {
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t sbase = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  float* u1 = reinterpret_cast<float*>(smem + g.off_u1);
  bf16* u2 = reinterpret_cast<bf16*>(smem + g.off_u2);
  float* red = reinterpret_cast<float*>(smem + g.off_red);
  const bf16* wes = reinterpret_cast<const bf16*>(smem + g.off_we);
  const bf16* wps = reinterpret_cast<const bf16*>(smem + g.off_wp);
  const float* vecs = reinterpret_cast<const float*>(smem + g.off_vec);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;  // mma groupID, thread in group
  const int mi = warp & 3, nh = warp >> 2;  // project: m16 tile, Cout half

  // cp.async groups, per chunk: A the project weights (at its first
  // barrier), B the next chunk's expand weights and vectors, C the next
  // item's x (at its second; C empty but at an item's first chunk)
  int u = blockIdx.x;
  if (u < g.items) {
    const int kc = item_of(g, u).slab * g.cps;
    stage_x(a, g, sbase, u);
    if (g.expand) stage_we(a, g, sbase + g.off_we, kc);
    stage_vec(a, g, sbase + g.off_vec, kc);
  }
  cp_async_commit();
  int step = 0;  // chunks walked so far: the vectors' buffer is step & 1
  for (int it = 0; u < g.items; u += gridDim.x, ++it) {
    const Item t = item_of(g, u);
    const int xoff = (it & 1) * g.xs_bytes;
    const bf16* xs = reinterpret_cast<const bf16*>(smem + xoff);
    const int k0 = t.slab * g.cps;
    const int k1 = min(k0 + g.cps, g.chunks);
    const int o_w = t.part * g.cout_blk + nh * NW8 * 8;  // warp's first output

    float acc[NW8 > 0 ? NW8 : 1][4];
#pragma unroll
    for (int j = 0; j < (NW8 > 0 ? NW8 : 1); ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[j][c] = 0.0f;

    for (int kc = k0; kc < k1; ++kc, ++step) {
      const int c0 = kc * TC_CHUNK;
      const float* vb = vecs + (step & 1) * NVEC * TC_CHUNK;
      // this chunk's we and vectors (B); at an item's first chunk also its
      // x (C of the item before)
      if (kc == k0)
        cp_async_wait<0>();
      else
        cp_async_wait<1>();
      __syncthreads();  // ... and every warp is past the last project
      if (MODE != kStats) stage_wp(a, g, sbase + g.off_wp, kc, t.part);
      cp_async_commit();  // A

      // u1 on the haloed pixels: expand, BN, activation, then the mask
      if (g.expand) {
        if (warp * 16 < g.P) {
          float e[4][4];
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int c = 0; c < 4; ++c) e[j][c] = 0.0f;
          int row = warp * 16 + (lane & 15);
          if (row >= g.P) row = 0;  // a slot past the tile, never stored
          const uint32_t a_addr =
              sbase + xoff + (row * g.xs_stride + (lane >> 4) * 8) * 2;
          for (int ks = 0; ks < g.cin_pad / 16; ++ks) {
            uint32_t af[4];
            ldmatrix_x4(af, a_addr + ks * 32);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const uint32_t* bp = reinterpret_cast<const uint32_t*>(
                  wes + (j * 8 + gq) * g.xs_stride + ks * 16 + 2 * tq);
              mma_16816(e[j], af, bp[0], bp[4]);
            }
          }
          bool in_img[2];  // rows gq and gq + 8: a pixel of the image
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int p = warp * 16 + gq + 8 * h;
            const int pr = fdiv(p, g.f_pw);
            const int gr = t.r0 - 1 + pr, gc = t.q0 - 1 + p - pr * g.PW;
            in_img[h] = gr >= 0 && gr < g.H && gc >= 0 && gc < g.W;
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int c = j * 8 + 2 * tq, ch = c0 + c;
            const bool v0 = ch < g.Ch, v1 = ch + 1 < g.Ch;
            const float2 s1v = *reinterpret_cast<const float2*>(vb + c);
            const float2 t1v =
                *reinterpret_cast<const float2*>(vb + TC_CHUNK + c);
            const float s1a = s1v.x, t1a = t1v.x, s1b = s1v.y, t1b = t1v.y;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int p = warp * 16 + gq + 8 * h;
              if (p >= g.P) continue;
              const bool inside = in_img[h];
              float2 v;
              v.x = (inside && v0)
                        ? act(affine(e[j][2 * h], s1a, t1a), g.act_mid)
                        : 0.0f;
              v.y = (inside && v1)
                        ? act(affine(e[j][2 * h + 1], s1b, t1b), g.act_mid)
                        : 0.0f;
              *reinterpret_cast<float2*>(u1 + p * HS + c) = v;
            }
          }
        }
      } else {  // u1 = x; the staged tile is already 0 outside the image
        for (int e = tid; e < g.P * TC_CHUNK; e += THREADS) {
          const int p = e / TC_CHUNK, c = e % TC_CHUNK;
          u1[p * HS + c] =
              c0 + c < g.Ch ? __bfloat162float(xs[p * g.xs_stride + c0 + c])
                            : 0.0f;
        }
      }
      __syncthreads();
      {  // the next chunk's expand weights and vectors, under the taps
        const uint32_t vdst =
            sbase + g.off_vec + ((step + 1) & 1) * NVEC * TC_CHUNK * 4;
        int next = -1;
        if (kc + 1 < k1)
          next = kc + 1;
        else if (u + (int)gridDim.x < g.items)
          next = item_of(g, u + gridDim.x).slab * g.cps;
        if (next >= 0) {
          if (g.expand) stage_we(a, g, sbase + g.off_we, next);
          stage_vec(a, g, vdst, next);
        }
      }
      cp_async_commit();  // B
      if (kc == k0 && u + (int)gridDim.x < g.items)
        stage_x(a, g, sbase + ((it + 1) & 1) * g.xs_bytes, u + gridDim.x);
      cp_async_commit();  // C

      // the 9 taps: warp = output column, lane = channel, down the rows
      const int ch = c0 + lane;
      const bool cval = ch < g.Ch;
      float sum = 0.0f, sq = 0.0f;
      if (warp < g.TW) {
        float wd[9];
#pragma unroll
        for (int k = 0; k < 9; ++k) wd[k] = vb[(4 + k) * TC_CHUNK + lane];
        const float s2 = vb[2 * TC_CHUNK + lane];
        const float t2 = vb[3 * TC_CHUNK + lane];
        const int qc = warp;
        const bool col_in = t.q0 + qc < g.W;
        const float* src = u1 + qc * HS + lane;
        float d3[3];  // output row r's sum in d3[r % 3], rows r .. r + 2 in
#pragma unroll
        for (int k = 0; k < TC_TILE + 2; ++k) {
          if (k >= g.TH + 2) break;
          float xv[3];
#pragma unroll
          for (int dj = 0; dj < 3; ++dj) xv[dj] = src[(k * g.PW + dj) * HS];
#pragma unroll
          for (int di = 0; di < 3; ++di) {
            const int r = k - di;
            if (r < 0 || r >= g.TH) continue;
            float& d = d3[r % 3];
#pragma unroll
            for (int dj = 0; dj < 3; ++dj)
              d = (di == 0 && dj == 0)
                      ? __fmul_rn(xv[0], wd[0])
                      : __fadd_rn(d, __fmul_rn(xv[dj], wd[di * 3 + dj]));
            if (di != 2) continue;
            const bool inside = cval && col_in && t.r0 + r < g.H;
            if (MODE == kStats) {
              if (inside) {
                sum += d;
                sq = fmaf(d, d, sq);
              }
            } else {
              u2[(r * g.TW + qc) * HS + lane] = __float2bfloat16_rn(
                  inside ? act(affine(d, s2, t2), g.act_mid) : 0.0f);
            }
          }
        }
      }

      if (MODE == kStats) {  // the chunk's sums: warps in a fixed order
        red[warp * TC_CHUNK + lane] = sum;
        red[(WARPS + warp) * TC_CHUNK + lane] = sq;
        __syncthreads();
        if (tid < TC_CHUNK && c0 + tid < g.Ch) {
          float s = 0.0f, s2sum = 0.0f;
          for (int w = 0; w < WARPS; ++w) {
            s += red[w * TC_CHUNK + tid];
            s2sum += red[(WARPS + w) * TC_CHUNK + tid];
          }
          a.partials[((size_t)t.tile * 2) * g.Ch + c0 + tid] = s;
          a.partials[((size_t)t.tile * 2 + 1) * g.Ch + c0 + tid] = s2sum;
        }
      } else {
        cp_async_wait<2>();  // the project weights (A; B and C may fly on)
        __syncthreads();
        // the chunk's project product into the float32 fragments
        if (mi * 16 < g.Q) {
          int row = mi * 16 + (lane & 15);
          if (row >= g.Q) row = 0;  // a slot past the tile, never stored
          const uint32_t a_addr =
              sbase + g.off_u2 + (row * HS + (lane >> 4) * 8) * 2;
#pragma unroll
          for (int ks = 0; ks < TC_CHUNK / 16; ++ks) {
            uint32_t af[4];
            ldmatrix_x4(af, a_addr + ks * 32);
#pragma unroll
            for (int j = 0; j < NW8; ++j) {
              if (o_w + j * 8 >= g.Cout) break;  // uniform across the warp
              const uint32_t* bp = reinterpret_cast<const uint32_t*>(
                  wps + ((nh * NW8 + j) * 8 + gq) * HS + ks * 16 + 2 * tq);
              mma_16816(acc[j], af, bp[0], bp[4]);
            }
          }
        }
      }
    }

    if (MODE != kStats) {
      // epilogue. Lane (gq, tq) holds rows gq and gq + 8 of its m16 tile,
      // columns 2tq and 2tq + 1 of each n8 fragment.
      float ssum[NW8 > 0 ? NW8 : 1][2], ssq[NW8 > 0 ? NW8 : 1][2];
#pragma unroll
      for (int j = 0; j < (NW8 > 0 ? NW8 : 1); ++j)
        ssum[j][0] = ssum[j][1] = ssq[j][0] = ssq[j][1] = 0.0f;
      const size_t npix = (size_t)g.B * g.H * g.W;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int q = mi * 16 + gq + 8 * h;
        const int qr = fdiv(q, g.f_tw_tile), qc = q - qr * g.TW;
        const int gr = t.r0 + qr, gc = t.q0 + qc;
        if (mi * 16 >= g.Q || q >= g.Q || gr >= g.H || gc >= g.W) continue;
        const size_t pix = (size_t)(t.b * g.H + gr) * g.W + gc;
#pragma unroll
        for (int j = 0; j < NW8; ++j) {
          const int o = o_w + j * 8 + 2 * tq;
          if (o >= g.Cout) break;
          float v0 = acc[j][2 * h], v1 = acc[j][2 * h + 1];
          if (g.split > 1) {  // the slab's sums; a second kernel adds them
            *reinterpret_cast<float2*>(
                a.part + ((size_t)t.slab * npix + pix) * g.Cout + o) =
                make_float2(v0, v1);
            continue;
          }
          if (MODE == kFull) {
            v0 = affine(v0, a.s3[o], a.t3[o]);
            v1 = affine(v1, a.s3[o + 1], a.t3[o + 1]);
            if (g.residual) {
              const bf16* xr = xs + ((qr + 1) * g.PW + qc + 1) * g.xs_stride;
              v0 = __fadd_rn(v0, __bfloat162float(xr[o]));
              v1 = __fadd_rn(v1, __bfloat162float(xr[o + 1]));
            }
            v0 = act(v0, g.act_out);
            v1 = act(v1, g.act_out);
          } else {
            ssum[j][0] += v0;
            ssq[j][0] = fmaf(v0, v0, ssq[j][0]);
            ssum[j][1] += v1;
            ssq[j][1] = fmaf(v1, v1, ssq[j][1]);
          }
          *reinterpret_cast<uint32_t*>(static_cast<bf16*>(a.out) +
                                       pix * g.Cout + o) = pack_bf16(v0, v1);
        }
      }
      if (MODE == kRaw && g.split == 1) {
        // the tile's sums: the 8 rows of a quad column by xor shuffles, then
        // the four m16 tiles in order
#pragma unroll
        for (int j = 0; j < NW8; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float s = ssum[j][e], q2 = ssq[j][e];
#pragma unroll
            for (int m = 4; m < 32; m <<= 1) {
              s += __shfl_xor_sync(0xffffffffu, s, m);
              q2 += __shfl_xor_sync(0xffffffffu, q2, m);
            }
            if (gq == 0) {
              const int n = (nh * NW8 + j) * 8 + 2 * tq + e;
              red[mi * g.cout_blk + n] = s;
              red[(4 + mi) * g.cout_blk + n] = q2;
            }
          }
        }
        __syncthreads();
        for (int n = tid; n < g.cout_blk; n += THREADS) {
          const int o = t.part * g.cout_blk + n;
          if (o >= g.Cout) continue;
          float s = 0.0f, q2 = 0.0f;
          for (int m = 0; m < 4; ++m) {
            s += red[m * g.cout_blk + n];
            q2 += red[(4 + m) * g.cout_blk + n];
          }
          a.partials[((size_t)t.tile * 2) * g.Cout + o] = s;
          a.partials[((size_t)t.tile * 2 + 1) * g.Cout + o] = q2;
        }
      }
    }
  }
  cp_async_wait<0>();
}

// Where the hidden channels are split: per tile, the slabs' project sums
// added in slab order, then Full's epilogue or Raw's h3 and its sums (the
// tile's pixels in order).
template <int MODE>
__global__ void __launch_bounds__(THREADS)
    mbconv_split_epilogue(const Args a, const TcGeom g) {
  const int tile = blockIdx.x;
  const int tj = tile % g.tiles_w, ti = (tile / g.tiles_w) % g.tiles_h;
  const int b = tile / (g.tiles_w * g.tiles_h);
  const size_t npix = (size_t)g.B * g.H * g.W;
  for (int o = threadIdx.x; o < g.Cout; o += THREADS) {
    float sum = 0.0f, sq = 0.0f;
    for (int q = 0; q < g.Q; ++q) {
      const int gr = ti * g.TH + q / g.TW, gc = tj * g.TW + q % g.TW;
      if (gr >= g.H || gc >= g.W) continue;
      const size_t pix = (size_t)(b * g.H + gr) * g.W + gc;
      float v = a.part[pix * g.Cout + o];
      for (int s = 1; s < g.split; ++s)
        v += a.part[(s * npix + pix) * g.Cout + o];
      if (MODE == kFull) {
        v = affine(v, a.s3[o], a.t3[o]);
        if (g.residual)
          v = __fadd_rn(v, __bfloat162float(
                               static_cast<const bf16*>(a.x)[pix * g.Cin + o]));
        v = act(v, g.act_out);
      } else {
        sum += v;
        sq = fmaf(v, v, sq);
      }
      static_cast<bf16*>(a.out)[pix * g.Cout + o] = __float2bfloat16_rn(v);
    }
    if (MODE == kRaw) {
      a.partials[((size_t)tile * 2) * g.Cout + o] = sum;
      a.partials[((size_t)tile * 2 + 1) * g.Cout + o] = sq;
    }
  }
}

template <int MODE, int NW8>
int launch_tc(const Args& a, const TcGeom& g, cudaStream_t s) {
  auto kernel = mbconv_tc<MODE, NW8>;
  // per device: the SM count, once the shared-memory limit is set
  static int sms[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (sms[dev] == 0) {
    int n = 0;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    sms[dev] = n;
  }
  // as many blocks an SM as the registers and the staging allow
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS,
                                                      g.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long resident = (long long)sms[dev] * (per_sm > 0 ? per_sm : 1);
  const unsigned grid =
      (unsigned)(g.items < resident ? (long long)g.items : resident);
  kernel<<<grid, THREADS, g.smem, s>>>(a, g);
  err = cudaGetLastError();
  if constexpr (MODE != kStats) {
    if (err == cudaSuccess && g.split > 1) {
      mbconv_split_epilogue<MODE><<<g.tiles, THREADS, 0, s>>>(a, g);
      err = cudaGetLastError();
    }
  }
  return static_cast<int>(err);
}

template <int MODE>
int dispatch_tc(const Args& a, const TcGeom& g, cudaStream_t s) {
  if constexpr (MODE == kStats) {
    return launch_tc<MODE, 0>(a, g, s);
  } else {
    switch (g.cout_blk) {
      case 32: return launch_tc<MODE, 2>(a, g, s);
      case 64: return launch_tc<MODE, 4>(a, g, s);
      case 96: return launch_tc<MODE, 6>(a, g, s);
      default: return launch_tc<MODE, 10>(a, g, s);
    }
  }
}

template <int MODE>
int run(const Args& a, Geom g, int split, bool residual, int dtype,
        cudaStream_t s) {
  const bool expand = a.we != nullptr;
  const int c = MODE == kStats ? g.Ch : g.Cout;
  if (tc_ok(MODE, g.Cin, g.Ch, g.Cout, expand, dtype, a.x)) {
    TcGeom t{};
    t.B = g.B, t.H = g.H, t.W = g.W, t.Cin = g.Cin, t.Ch = g.Ch;
    t.Cout = g.Cout, t.TH = g.TH, t.TW = g.TW, t.split = split;
    t.expand = expand, t.residual = residual;
    t.act_mid = g.act_mid, t.act_out = g.act_out;
    if (!make_tc_geom(&t, MODE))
      return static_cast<int>(cudaErrorInvalidValue);
    if (!aligned16(a.out) || !aligned16(a.we) || !aligned16(a.wp) ||
        !aligned16(a.s1) || !aligned16(a.t1) || !aligned16(a.s2) ||
        !aligned16(a.t2) || !aligned16(a.wd) ||
        (split > 1 && MODE != kStats && a.part == nullptr))
      return static_cast<int>(cudaErrorMisalignedAddress);
    const int err = dispatch_tc<MODE>(a, t, s);
    if (err != 0 || MODE == kFull) return err;
    return reduce(a.partials, a.sums, t.tiles, c, s);
  }
  if (split != 1 || !make_geom(&g, MODE, expand, residual))
    return static_cast<int>(cudaErrorInvalidValue);
  int err;
  if (dtype == 0)
    err = dispatch<float, MODE>(a, g, residual, s);
  else if (dtype == 1)
    err = dispatch<__nv_bfloat16, MODE>(a, g, residual, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  if (err != 0 || MODE == kFull) return err;
  return reduce(a.partials, a.sums, g.B * g.tiles_h * g.tiles_w, c, s);
}

}  // namespace

// The kernel that runs (mode: 0 Full, 1 Stats, 2 Raw; expand 0 or 1; dtype:
// 0 float32, 1 bfloat16): 1 the tensor-core kernel, which takes we and wp
// packed as (ceil32(Ch), ceil16(Cin)) and (Cout, ceil32(Ch)) with zeros in
// the padding, an output tile of at most 8 x 8 and a split of the hidden
// chunks; 0 the CUDA-core kernel, which takes we (Cin, Ch), wp (Ch, Cout),
// a tile of at most 64 output and 104 haloed pixels and split 1.
extern "C" int ctt_mbconv_variant(int mode, int Cin, int Ch, int Cout,
                                  int expand, int dtype, const void* x) {
  return tc_ok(mode, Cin, Ch, Cout, expand != 0, dtype, x) ? 1 : 0;
}

// The three entry points. x, we, wp and the output in x's type (dtype: 0
// float32, 1 bfloat16), we and wp in the layouts ctt_mbconv_variant names;
// s*, t*, wd float32; we null means no expand stage. act_*: 0 none, 1 relu,
// 2 relu6. part: the float32 scratch (split, B*H*W, Cout) where split > 1.
// partials: (tiles, 2, C) float32 scratch. Each returns the cudaError_t of
// its launches (cudaErrorInvalidValue for dimensions the kernel cannot
// take).

extern "C" int ctt_mbconv_full(const void* x, const void* we, const float* s1,
                               const float* t1, const float* wd,
                               const float* s2, const float* t2,
                               const void* wp, const float* s3,
                               const float* t3, void* y, float* part, int B,
                               int H, int W, int Cin, int Ch, int Cout, int TH,
                               int TW, int split, int residual, int act_mid,
                               int act_out, int dtype, void* stream) {
  const Args a{x, we, s1, t1, wd, s2, t2, wp, s3, t3, y, part, nullptr,
               nullptr};
  Geom g{};
  g.B = B, g.H = H, g.W = W, g.Cin = Cin, g.Ch = Ch, g.Cout = Cout;
  g.TH = TH, g.TW = TW, g.act_mid = act_mid, g.act_out = act_out;
  return run<kFull>(a, g, split, residual != 0, dtype,
                    static_cast<cudaStream_t>(stream));
}

extern "C" int ctt_mbconv_stats(const void* x, const void* we, const float* s1,
                                const float* t1, const float* wd,
                                float* partials, float* sums, int B, int H,
                                int W, int Cin, int Ch, int TH, int TW,
                                int split, int act_mid, int dtype,
                                void* stream) {
  const Args a{x,       we,      s1,      t1,      wd,      nullptr,  nullptr,
               nullptr, nullptr, nullptr, nullptr, nullptr, partials, sums};
  Geom g{};
  g.B = B, g.H = H, g.W = W, g.Cin = Cin, g.Ch = Ch, g.Cout = 0;
  g.TH = TH, g.TW = TW, g.act_mid = act_mid, g.act_out = 0;
  return run<kStats>(a, g, split, false, dtype,
                     static_cast<cudaStream_t>(stream));
}

extern "C" int ctt_mbconv_raw(const void* x, const void* we, const float* s1,
                              const float* t1, const float* wd,
                              const float* s2, const float* t2, const void* wp,
                              void* h3, float* part, float* partials,
                              float* sums, int B, int H, int W, int Cin,
                              int Ch, int Cout, int TH, int TW, int split,
                              int act_mid, int dtype, void* stream) {
  const Args a{x,  we,      s1,      t1, wd,   s2,       t2,
               wp, nullptr, nullptr, h3, part, partials, sums};
  Geom g{};
  g.B = B, g.H = H, g.W = W, g.Cin = Cin, g.Ch = Ch, g.Cout = Cout;
  g.TH = TH, g.TW = TW, g.act_mid = act_mid, g.act_out = 0;
  return run<kRaw>(a, g, split, false, dtype,
                   static_cast<cudaStream_t>(stream));
}
