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
// The backward is a gather, not a scatter: every dx pixel is written once,
// in x's type, from float32 sums of the dy its index routes to it, added in
// ascending tap order t = di * kw + dj (the order of the plain version, and
// of `_mp_bwd_padsum` and `_bwd_kernel`): no atomics, no memset, the same
// bits on every run. It replaces `bwd_body` (pallas_call at pool.py:272) and
// `_bwd_kernel` (pallas_call at pool_bwd.py:120). Two kernels, picked by a
// stated shape rule (`bwd_tiled_ok`, exported as
// `ctt_max_pool2d_bwd_variant`), never on failure:
//
// * Tiled, a staged residue-class gather in output geometry (3x3, stride 2,
//   padding 1: the stems of the ResNets; C a multiple of the 16-byte
//   vector; dy, dx 16-byte and the index vector aligned). Write an input
//   row as i = s*a + r, r its residue. Pixel i is fed only by the taps
//   d = r + p (mod s), each through window a + u, u = (r + p - d) / s: at
//   3x3/s2/p1 residue 0 takes tap 1 of window a, residue 1 tap 0 of window
//   a + 1 and tap 2 of window a; so window position (a, b) owns the s x s
//   pixels (s*a + r_h, s*b + r_w) and reads windows a .. a + 1 and b .. b +
//   1. A block owns a tile of up to 8 window rows x up to 256/cv window
//   columns x a slab of cv <= 32 channel vectors; a persistent grid of one
//   block an SM walks the tiles. A block stages the dy and the index of
//   the windows its tile reads (one more row and column than the tile)
//   into shared memory with cp.async, into one of two buffers, so the next
//   tile's copies fly while this one is added; a window past Ho - 1 or
//   Wo - 1 is staged as dy 0 and index 255, which no tap matches. Each
//   thread takes one window column and one channel vector and walks down
//   the tile's rows, keeping the row below in registers for the next step,
//   so it reads each staged window once or twice; it writes the s x s
//   pixels of each window position with 16-byte stores, masking a pixel
//   past H - 1 or W - 1. Taps and shifts are constants of the template
//   instance: no integer division is left in the loop over windows.
// * Per pixel (any other pool, ragged C, unaligned pointers): the first
//   design, kept. One thread owns an input pixel and a vector of channels
//   (or one channel), and visits the at most ceil(kh/sh) * ceil(kw/sw)
//   windows that cover it, reading each from device memory. The windows
//   covering input row ih are
//     oh in [ceil((ih + ph - kh + 1) / sh), floor((ih + ph) / sh)] ∩ [0, Ho)
//   and likewise for columns.
//
// What bounds them on an H100: bytes. The forward reads x and writes y and
// the index; the backward reads dy and the index once and writes dx once.
// At the ResNet-50 stem at batch 128 in bf16 either moves about 283 MB, 84
// us at 3.35 TB/s, against a few hundred million compares. So each thread
// moves 16 bytes per access (8 bf16 or 4 float32 channels) with
// neighbouring threads on neighbouring channels. The forward's overlapping
// window reads hit L1/L2; the per-pixel backward reads each dy and index
// vector 2.25 times on average at 3x3/s2, through L2, where the tiled one's
// staging brings it from device memory once (a tile's extra row and column
// are its neighbours' first, read again from L2) and serves the rereads
// from shared memory. A channel count that is not a multiple of the vector
// width (or an unaligned pointer) takes the per-element forward and the
// per-pixel backward with one channel per thread.
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

// ------------------------------------------------------ tiled backward

constexpr int BT_THREADS = 256;
constexpr int BT_MAX_SLAB = 32;          // channel vectors a slab
constexpr int BT_MAX_ROWS = 8;           // window rows a tile
constexpr int BT_SMEM_CAP = 52 * 1024;   // a staging buffer (2 a block)
constexpr uint8_t NO_TAP = 255;          // the index of "no window"

struct BwdTile {
  int H, W, C, Ho, Wo;
  int na, nb;                     // window positions: ceil(H/s), ceil(W/s)
  int nv, cv, slabs;              // channel vectors; vectors a slab; slabs
  int rt, tw;                     // window rows, columns a tile
  int tiles_h, tiles_w, spatial;  // tiles an image (rows, columns); all
  int sr, sc;                     // staged windows: rt + U rows, tw + U cols
  int idx_off, buf_bytes;         // the index's offset in a buffer; a buffer
};

__device__ __forceinline__ void cp_async16(uint32_t smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem),
               "l"(gmem));
}

// BYTES: 4 or 8, the index vector of VEC channels
template <int BYTES>
__device__ __forceinline__ void cp_async_small(uint32_t smem,
                                               const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(smem),
               "l"(gmem), "n"(BYTES));
}

// Item u: slab-major, then image, window-row tile, window-column tile (the
// column tiles fastest, so the blocks running together share their staged
// rows and columns in L2).
struct Item {
  int slab, b, a0, b0;
};

__device__ __forceinline__ Item decode(const BwdTile& g, int u) {
  Item it;
  it.slab = u / g.spatial;
  int sp = u - it.slab * g.spatial;
  const int tx = sp % g.tiles_w;
  sp /= g.tiles_w;
  const int ty = sp % g.tiles_h;
  it.b = sp / g.tiles_h;
  it.a0 = ty * g.rt;
  it.b0 = tx * g.tw;
  return it;
}

// Starts the copies of item u's windows (sr x sc, cv vectors each) into the
// buffer at shared address dst (generic pointer dst_p): dy vectors first,
// the index vectors at idx_off. A window past the output is written here
// as dy 0 and index NO_TAP; vectors past the last channel are left alone
// (no thread reads them).
template <typename T, int VEC>
__device__ __forceinline__ void stage_windows(const T* __restrict__ dy,
                                              const uint8_t* __restrict__ idx,
                                              uint32_t dst,
                                              unsigned char* dst_p,
                                              const BwdTile& g, int u) {
  const Item it = decode(g, u);
  const int step = BT_THREADS / g.cv;  // windows copied at once
  int win = threadIdx.x / g.cv;
  if (win >= step) return;
  const int vec = threadIdx.x - win * g.cv;
  const int cvec = it.slab * g.cv + vec;
  if (cvec >= g.nv) return;
  const size_t img = (size_t)it.b * g.Ho * g.Wo * g.C + (size_t)cvec * VEC;
  const int n = g.sr * g.sc;
  int c = win % g.sc, r = win / g.sc;
  for (; win < n; win += step) {
    const int a = it.a0 + r, b = it.b0 + c;
    const int slot = win * g.cv + vec;
    if (a < g.Ho && b < g.Wo) {
      const size_t o = img + ((size_t)a * g.Wo + b) * g.C;
      cp_async16(dst + slot * 16, dy + o);
      cp_async_small<VEC>(dst + g.idx_off + slot * VEC, idx + o);
    } else {
      *reinterpret_cast<uint4*>(dst_p + slot * 16) = make_uint4(0, 0, 0, 0);
      IdxPack<VEC> none;
#pragma unroll
      for (int e = 0; e < VEC; ++e) none.v[e] = NO_TAP;
      *reinterpret_cast<IdxPack<VEC>*>(dst_p + g.idx_off + slot * VEC) = none;
    }
    for (c += step; c >= g.sc; c -= g.sc) ++r;  // no division per window
  }
}

template <typename T, int VEC>
struct Window {
  Pack<T, VEC> dy;
  IdxPack<VEC> idx;
};

// The kernel for (K, S, P): window position a owns the input rows S*a + r,
// r in [0, S); pixel S*a + r takes tap d where d = r + P (mod S), through
// window a + u, u = (r + P - d) / S in [0, U]. P + S >= K makes every such
// u >= 0 (a tap d > r + P would need d >= r + P + S >= K).
template <typename T, int K, int S, int P>
__global__ void __launch_bounds__(BT_THREADS, 1)
    max_pool2d_bwd_tiled(const T* __restrict__ dy,
                         const uint8_t* __restrict__ idx, T* __restrict__ dx,
                         BwdTile g) {
  static_assert(P + S >= K && P < K && S <= K, "a tap with a negative shift");
  constexpr int VEC = 16 / sizeof(T);
  constexpr int U = (S - 1 + P) / S;  // the largest window shift
  using V = Pack<T, VEC>;
  using Win = Window<T, VEC>;
  extern __shared__ __align__(16) unsigned char smem[];  // 2 buffers
  const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int items = g.spatial * g.slabs;
  const int col = threadIdx.x / g.cv, v = threadIdx.x - col * g.cv;

  int u = blockIdx.x;
  if (u < items) stage_windows<T, VEC>(dy, idx, base, smem, g, u);
  asm volatile("cp.async.commit_group;\n" ::);
  for (int it = 0; u < items; u += gridDim.x, ++it) {
    const int cur = (it & 1) * g.buf_bytes, next = g.buf_bytes - cur;
    if (u + (int)gridDim.x < items)
      stage_windows<T, VEC>(dy, idx, base + next, smem + next, g,
                            u + gridDim.x);
    asm volatile("cp.async.commit_group;\n" ::);  // possibly empty
    asm volatile("cp.async.wait_group 1;\n" ::);  // item u has landed
    __syncthreads();

    const Item item = decode(g, u);
    const int cvec = item.slab * g.cv + v;
    const int b = item.b0 + col;  // this thread's window column
    if (col < g.tw && cvec < g.nv && b < g.nb) {
      const V* sdy = reinterpret_cast<const V*>(smem + cur);
      const IdxPack<VEC>* sid =
          reinterpret_cast<const IdxPack<VEC>*>(smem + cur + g.idx_off);
      const int rows = min(g.rt, g.na - item.a0);
      // staged window (r, col + vv) of this thread's vector
      auto load = [&](Win& w, int r, int vv) {
        const int slot = (r * g.sc + col + vv) * g.cv + v;
        w.dy = sdy[slot];
        w.idx = sid[slot];
      };
      // w[uu][vv]: window (a + uu, b + vv); rows a + 1 .. a + U carry over
      Win w[U + 1][U + 1];
#pragma unroll
      for (int uu = 1; uu <= U; ++uu)
#pragma unroll
        for (int vv = 0; vv <= U; ++vv) load(w[uu][vv], uu - 1, vv);
      const int iw0 = S * b;
      T* dxb = dx + (size_t)item.b * g.H * g.W * g.C + (size_t)cvec * VEC;
      for (int r = 0; r < rows; ++r) {
#pragma unroll
        for (int uu = 0; uu < U; ++uu)
#pragma unroll
          for (int vv = 0; vv <= U; ++vv) w[uu][vv] = w[uu + 1][vv];
#pragma unroll
        for (int vv = 0; vv <= U; ++vv) load(w[U][vv], r + U, vv);

        const int ih0 = S * (item.a0 + r);
#pragma unroll
        for (int rh = 0; rh < S; ++rh) {
          if (ih0 + rh >= g.H) break;  // H odd: no last residue row
          T* dxrow = dxb + ((size_t)(ih0 + rh) * g.W + iw0) * g.C;
#pragma unroll
          for (int rw = 0; rw < S; ++rw) {
            if (iw0 + rw >= g.W) break;
            float acc[VEC];
#pragma unroll
            for (int e = 0; e < VEC; ++e) acc[e] = 0.0f;
            // the class's taps in ascending t: di outer, dj inner
#pragma unroll
            for (int di = 0; di < K; ++di) {
              const int nh = rh + P - di;
              if (nh < 0 || nh % S != 0) continue;
#pragma unroll
              for (int dj = 0; dj < K; ++dj) {
                const int nw = rw + P - dj;
                if (nw < 0 || nw % S != 0) continue;
                const Win& win = w[nh / S][nw / S];
                const uint8_t t = (uint8_t)(di * K + dj);
#pragma unroll
                for (int e = 0; e < VEC; ++e)
                  if (win.idx.v[e] == t) acc[e] += to_f32(win.dy.v[e]);
              }
            }
            V out;
#pragma unroll
            for (int e = 0; e < VEC; ++e) out.v[e] = from_f32<T>(acc[e]);
            *reinterpret_cast<V*>(dxrow + (size_t)rw * g.C) = out;
          }
        }
      }
    }
    __syncthreads();  // every thread is done with this buffer
  }
}

// Cuts n into the fewest parts of at most `most`, evenly.
int even(int n, int most) {
  const int parts = (n + most - 1) / most;
  return (n + parts - 1) / parts;
}

int staged_bytes(const BwdTile& t, int u, int vec) {
  const int slots = (t.rt + u) * (t.tw + u) * t.cv;
  return slots * 16 + ((slots * vec + 15) / 16) * 16;
}

// The tile: slabs of at most BT_MAX_SLAB vectors, cut evenly; as many
// window columns as the block has threads for, cut evenly; up to
// BT_MAX_ROWS window rows, fewer where a buffer would pass BT_SMEM_CAP,
// cut evenly.
BwdTile bwd_tile(const Geom& g, int s, int u, int vec) {
  BwdTile t{};
  t.H = g.H, t.W = g.W, t.C = g.C, t.Ho = g.Ho, t.Wo = g.Wo;
  t.na = (g.H + s - 1) / s;
  t.nb = (g.W + s - 1) / s;
  t.nv = g.C / vec;
  t.cv = even(t.nv, BT_MAX_SLAB);
  t.slabs = (t.nv + t.cv - 1) / t.cv;
  t.tw = even(t.nb, BT_THREADS / t.cv);
  for (t.rt = t.na < BT_MAX_ROWS ? t.na : BT_MAX_ROWS;
       t.rt > 1 && staged_bytes(t, u, vec) > BT_SMEM_CAP; --t.rt) {
  }
  t.rt = even(t.na, t.rt);
  t.sr = t.rt + u;
  t.sc = t.tw + u;
  t.tiles_h = (t.na + t.rt - 1) / t.rt;
  t.tiles_w = (t.nb + t.tw - 1) / t.tw;
  t.spatial = g.B * t.tiles_h * t.tiles_w;
  t.idx_off = t.sr * t.sc * t.cv * 16;
  t.buf_bytes = staged_bytes(t, u, vec);
  return t;
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

template <typename T, int K, int S, int P>
int launch_bwd_tiled(const void* dy, const void* idx, void* dx,
                     const Geom& g, cudaStream_t s) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int U = (S - 1 + P) / S;
  const BwdTile t = bwd_tile(g, S, U, VEC);
  const long long items = (long long)t.spatial * t.slabs;
  if (items > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = max_pool2d_bwd_tiled<T, K, S, P>;
  // per device: the SM count, once the shared-memory limit is set
  static int sms[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (sms[dev] == 0) {
    int n = 0;
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               2 * BT_SMEM_CAP);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    sms[dev] = n;
  }
  // one block an SM (on the card, one was faster than two, by a few
  // percent at the stems, as were 8-row tiles than 4, 6, 12 or 16)
  const long long resident = sms[dev];
  const unsigned grid = (unsigned)(items < resident ? items : resident);
  kernel<<<grid, BT_THREADS, 2 * t.buf_bytes, s>>>(
      static_cast<const T*>(dy), static_cast<const uint8_t*>(idx),
      static_cast<T*>(dx), t);
  return static_cast<int>(cudaGetLastError());
}

int vec_of(int dtype) { return dtype == 1 ? 8 : 4; }

// The backward's shape rule: a 3x3 pool at stride 2 and padding 1 both
// ways, whole 16-byte channel vectors, dy on a 16-byte and the index on a
// vector boundary. Other pools keep the per-pixel kernel until a model
// needs their instance.
bool bwd_tiled_ok(int C, int kh, int kw, int sh, int sw, int ph, int pw,
                  int dtype, const void* dy, const void* idx) {
  return (dtype == 0 || dtype == 1) && kh == 3 && kw == 3 && sh == 2 &&
         sw == 2 && ph == 1 && pw == 1 && C % vec_of(dtype) == 0 &&
         aligned(dy, 16) && aligned(idx, vec_of(dtype));
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

// 1: the tiled backward runs for these arguments; 0: the per-pixel one.
extern "C" int ctt_max_pool2d_bwd_variant(int C, int kh, int kw, int sh,
                                          int sw, int ph, int pw, int dtype,
                                          const void* dy, const void* idx) {
  return bwd_tiled_ok(C, kh, kw, sh, sw, ph, pw, dtype, dy, idx) ? 1 : 0;
}

extern "C" int ctt_max_pool2d_bwd(const void* dy, const void* idx, void* dx,
                                  int B, int H, int W, int C, int Ho, int Wo,
                                  int kh, int kw, int sh, int sw, int ph,
                                  int pw, int dtype, void* stream) {
  const Geom g{B, H, W, C, Ho, Wo, kh, kw, sh, sw, ph, pw};
  if (!valid(g) || idx == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bwd_tiled_ok(C, kh, kw, sh, sw, ph, pw, dtype, dy, idx)) {
    if (!aligned(dx, 16)) return static_cast<int>(cudaErrorMisalignedAddress);
    return dtype == 0
               ? launch_bwd_tiled<float, 3, 2, 1>(dy, idx, dx, g, s)
               : launch_bwd_tiled<__nv_bfloat16, 3, 2, 1>(dy, idx, dx, g, s);
  }
  if (dtype == 0)
    launch_bwd<float>(dy, idx, dx, g, s);
  else if (dtype == 1)
    launch_bwd<__nv_bfloat16>(dy, idx, dx, g, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
