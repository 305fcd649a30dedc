// The fused inverted residual (MobileNet-V2's stride-1 MBConv block) for
// Hopper (sm_90a): one kernel template, three modes.
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
// plain version's separate ops are; the two products are float32 FMA sums.
//
// Design. A block of 256 threads owns a tile of TH x TW output pixels of one
// image (TH * TW <= 64, (TH + 2) * (TW + 2) <= 104; the wrapper picks the
// tile). It stages the haloed input tile, all Cin channels, in shared memory
// once, then walks the hidden channels in chunks of 32: it loads the chunk's
// expand and project weights, computes the expand for the haloed pixels
// (BN, activation, mask) into shared memory, the 9 taps for the output
// pixels, and then either adds the chunk's project product into float32
// registers (each thread owns 8 pixels x up to 10 output channels, so
// Cout <= 320) or adds the chunk's sums (Stats). No block holds all hidden
// channels, and device memory sees only x, the weights and the outputs.
// Sums are written per block and reduced by a second kernel in a fixed
// order, without atomics, so two runs give bit-equal statistics.
//
// What bounds it on an H100: operations. At MobileNet-V2's 13 stride-1
// blocks, batch 64 and bf16, the blocks read x and write y, about 140 MB
// (42 us at 3.35 TB/s), against about 25.7 GFLOP, 0.38 ms at the 67 TFLOP/s
// float32 rate of the CUDA cores that this version uses for both products
// (26 us on bf16 tensor cores: mma.sync or wgmma is later work). The halo
// recomputes the expand on up to 1.7x the tile's pixels.
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
  float* partials;  // Stats, Raw: (blocks, 2, C), C = Ch or Cout
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

int reduce(const float* partials, float* sums, const Geom& g, int c,
           cudaStream_t s) {
  const int blocks = g.B * g.tiles_h * g.tiles_w;
  const int cols = 2 * c;
  mbconv_reduce_kernel<<<(cols + 31) / 32, dim3(32, 32), 0, s>>>(
      partials, sums, blocks, cols);
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

template <int MODE>
int run(const Args& a, Geom g, bool residual, int dtype, cudaStream_t s) {
  if (!make_geom(&g, MODE, a.we != nullptr, residual))
    return static_cast<int>(cudaErrorInvalidValue);
  int err;
  if (dtype == 0)
    err = dispatch<float, MODE>(a, g, residual, s);
  else if (dtype == 1)
    err = dispatch<__nv_bfloat16, MODE>(a, g, residual, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  if (err != 0 || MODE == kFull) return err;
  return reduce(a.partials, a.sums, g, MODE == kStats ? g.Ch : g.Cout, s);
}

}  // namespace

// The three entry points. x, we, wp and the output in x's type (dtype: 0
// float32, 1 bfloat16); s*, t*, wd float32; we null means no expand stage.
// act_*: 0 none, 1 relu, 2 relu6. Each returns the cudaError_t of its
// launches (cudaErrorInvalidValue for dimensions the kernel cannot take:
// tile above 64 output or 104 haloed pixels, Cout above 320, or more than
// 227 KB of shared memory).

extern "C" int ctt_mbconv_full(const void* x, const void* we, const float* s1,
                               const float* t1, const float* wd,
                               const float* s2, const float* t2,
                               const void* wp, const float* s3,
                               const float* t3, void* y, int B, int H, int W,
                               int Cin, int Ch, int Cout, int TH, int TW,
                               int residual, int act_mid, int act_out,
                               int dtype, void* stream) {
  const Args a{x, we, s1, t1, wd, s2, t2, wp, s3, t3, y, nullptr, nullptr};
  Geom g{};
  g.B = B, g.H = H, g.W = W, g.Cin = Cin, g.Ch = Ch, g.Cout = Cout;
  g.TH = TH, g.TW = TW, g.act_mid = act_mid, g.act_out = act_out;
  return run<kFull>(a, g, residual != 0, dtype,
                    static_cast<cudaStream_t>(stream));
}

extern "C" int ctt_mbconv_stats(const void* x, const void* we, const float* s1,
                                const float* t1, const float* wd,
                                float* partials, float* sums, int B, int H,
                                int W, int Cin, int Ch, int TH, int TW,
                                int act_mid, int dtype, void* stream) {
  const Args a{x,       we,      s1,      t1,      wd,       nullptr, nullptr,
               nullptr, nullptr, nullptr, nullptr, partials, sums};
  Geom g{};
  g.B = B, g.H = H, g.W = W, g.Cin = Cin, g.Ch = Ch, g.Cout = 0;
  g.TH = TH, g.TW = TW, g.act_mid = act_mid, g.act_out = 0;
  return run<kStats>(a, g, false, dtype, static_cast<cudaStream_t>(stream));
}

extern "C" int ctt_mbconv_raw(const void* x, const void* we, const float* s1,
                              const float* t1, const float* wd,
                              const float* s2, const float* t2, const void* wp,
                              void* h3, float* partials, float* sums, int B,
                              int H, int W, int Cin, int Ch, int Cout, int TH,
                              int TW, int act_mid, int dtype, void* stream) {
  const Args a{x,  we,      s1,      t1, wd,       s2,  t2,
               wp, nullptr, nullptr, h3, partials, sums};
  Geom g{};
  g.B = B, g.H = H, g.W = W, g.Cin = Cin, g.Ch = Ch, g.Cout = Cout;
  g.TH = TH, g.TW = TW, g.act_mid = act_mid, g.act_out = 0;
  return run<kRaw>(a, g, false, dtype, static_cast<cudaStream_t>(stream));
}
