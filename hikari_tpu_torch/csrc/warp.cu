// Kernels 11 and 12: the history warps of TAA and SMAA.
//
// Kernel 11 (hk_warp_band) replaces hikari_tpu/ops/warp_band.py:_make_kernel
// (launched by _warp_impl): every source of the call, each [hs, w, F]
// (pixel stride P), resampled at per-pixel coords (sy, sx) clamped to the
// source, by nearest (round half to even, as the TPU kernel's jnp.round),
// bilinear or the full 4x4 Catmull-Rom filter, taps clamped to the edge.
//
// Kernel 12 (hk_warp_multi) replaces hikari_tpu/ops/warp2.py:_make_kernel
// (launched by _warp_core): one [H, W, F] source (pixel stride P), up to four
// reduces, each a filter at the clamped coords plus a static offset over a
// channel range; with bf16 on, source values and filter weights are rounded
// to bf16 (nearest even) before the f32 sums, as the TPU kernel's bf16
// window and weights are. Its nearest rounds half down (warp2's
// |d| <= 0.5 & d > -0.5 rule).
//
// Contract: the exact per-pixel filter. The TPU kernels' banded or 32-row
// group windows, lane rolls, scalar-prefetch packs and lane-packed panels
// exist because the TPU has no per-lane gather; within the TPU kernels'
// band / window the results agree, outside it the TPU clamps local coords
// to the window edge (an approximation every caller rejects), the port does
// not. The sums run in the plain versions' order (rows of x-taps, then over
// y; warp_multi: y-taps per column, then over x), channel by channel, and
// are compiled with --fmad=false, so a kernel rounds like its plain version.
//
// Design for Hopper. Bound: bytes (per pixel 8 B of coords, the texels its
// taps read and the outputs; a Catmull-Rom channel adds ~40 flops).
// - 2-D tiles: a block is 32x8 output pixels, one thread each, so the taps
//   of a block fall in a compact box that L1 or shared memory serves.
// - One load per texel: a texel's channels come in float4 / float2 loads
//   where the pixel stride, the channel offset and the alignment allow it,
//   scalar otherwise; a pixel's outputs leave in vector stores likewise. A
//   vector load may read past a texel's channels but not past its stride,
//   and so never past the tensor's storage, except at the last texel of
//   the source, which is read a float at a time.
// - The exact counterpart of the TPU's band / window: in the instance whose
//   first source is filtered (TAA's Catmull-Rom), a block reduces the texel
//   box its pixels' taps need; when it fits STAGE_FLOATS, that source is
//   copied into shared memory with coalesced cp.async and gathered there,
//   else read from global memory. The same floats meet the same arithmetic
//   in both branches, so there is no out-of-band approximation; `blocks`
//   (optional) counts the blocks of each branch. Nearest sources are read
//   from global memory: a staged one measured 2x slower.
// - Template instances for the filter-kind tuples of the paths: 11
//   (catmull, nearest) (TAA) and (nearest) (SMAA's tone), 12 all-nearest
//   (SMAA's G-buffer, bf16); a generic instance (runtime kinds, scalar
//   loads, no staging) serves the rest.
// - The host passes one packed table per call (BandCall / MultiCall), which
//   the entry point copies into the kernel's by-value argument.

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#define HK_MAX_WARP 4
#define HK_NONE -1
#define HK_NEAREST 0
#define HK_BILINEAR 1
#define HK_CATMULL 2
#define TILE_W 32
#define TILE_H 8
// the staged box's budget: 24 KB of shared memory a block
#define STAGE_FLOATS 6144

// ---- the host's tables (ops/warp_band.py BAND_TABLE, ops/warp2.py
// MULTI_TABLE): 64-bit fields first, no padding

struct BandCall {
  const float* src[HK_MAX_WARP];
  float* dst[HK_MAX_WARP];
  const float* sy;
  const float* sx;
  int* blocks;               // null, or {staged, direct} block counts
  int kind[HK_MAX_WARP];
  int f[HK_MAX_WARP];        // channels
  int stride[HK_MAX_WARP];   // pixel stride, floats
  int n_src, h, w, hs;
};
static_assert(sizeof(BandCall) == 152, "BandCall: ops/warp_band.py");

struct MultiCall {
  const float* src;
  float* dst[HK_MAX_WARP];
  const float* sy;
  const float* sx;
  int kind[HK_MAX_WARP];
  int lo[HK_MAX_WARP];
  int hi[HK_MAX_WARP];
  float offy[HK_MAX_WARP];
  float offx[HK_MAX_WARP];
  int n_red, hs, ws, p;
  int h, w, bf16;
  int unused;
};
static_assert(sizeof(MultiCall) == 168, "MultiCall: ops/warp2.py");

// the kernels' arguments: the table and the vector widths (floats per
// load of a texel / per store of a pixel) the entry point chose
struct BandArgs {
  BandCall t;
  int vin[HK_MAX_WARP];
  int vout[HK_MAX_WARP];
};

struct MultiArgs {
  MultiCall t;
  int vin[HK_MAX_WARP];
  int vout[HK_MAX_WARP];
};

// 1-D filter weight at signed distance d (warp_band._w1d)
__device__ __forceinline__ float w1d(float d, int kind) {
  float a = fabsf(d);
  if (kind == HK_BILINEAR) return fmaxf(0.0f, 1.0f - a);
  if (a < 1.0f) return 1.5f * (a * a * a) - 2.5f * (a * a) + 1.0f;
  if (a < 2.0f)
    return -0.5f * (a * a * a) + 2.5f * (a * a) - 4.0f * a + 2.0f;
  return 0.0f;
}

__device__ __forceinline__ int clampi(int v, int hi) {
  return v < 0 ? 0 : (v > hi ? hi : v);
}

__device__ __forceinline__ float clampf(float v, float hi) {
  return fminf(fmaxf(v, 0.0f), hi);
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The four taps floor(c)-1 .. floor(c)+2 of coord c along an axis of n
// texels: weights and clamped indices.
__device__ __forceinline__ void taps(float c, int n, int kind, bool bf16,
                                     float* wt, int* idx) {
  float f = floorf(c);
  float t = c - f;
  int i0 = (int)f;
#pragma unroll
  for (int k = 0; k < 4; k++) {
    float wk = w1d(t - (float)(k - 1), kind);
    wt[k] = bf16 ? bf16_round(wk) : wk;
    idx[k] = clampi(i0 + k - 1, n - 1);
  }
}

// ---- vector access of one texel / one output pixel

// Channels [0, f) of the texel at p into v (f <= N, N a multiple of 4),
// vw floats a load; GLOBAL: p is global memory (read-only path), else
// shared memory.
template <int N, bool GLOBAL>
__device__ __forceinline__ void load_texel(const float* p, int f, int vw,
                                           float (&v)[N]) {
  if (vw == 4) {
#pragma unroll
    for (int c = 0; c < N; c += 4)
      if (c < f) {
        const float4* q4 = reinterpret_cast<const float4*>(p + c);
        float4 q = GLOBAL ? __ldg(q4) : *q4;
        v[c] = q.x;
        v[c + 1] = q.y;
        v[c + 2] = q.z;
        v[c + 3] = q.w;
      }
  } else if (vw == 2) {
#pragma unroll
    for (int c = 0; c < N; c += 2)
      if (c < f) {
        const float2* q2 = reinterpret_cast<const float2*>(p + c);
        float2 q = GLOBAL ? __ldg(q2) : *q2;
        v[c] = q.x;
        v[c + 1] = q.y;
      }
  } else {
#pragma unroll
    for (int c = 0; c < N; c++)
      if (c < f) v[c] = GLOBAL ? __ldg(p + c) : p[c];
  }
}

// Channels [0, f) of v to the output pixel at p, vw floats a store (vw
// divides f).
template <int N>
__device__ __forceinline__ void store_px(float* p, int f, int vw,
                                         const float (&v)[N]) {
  if (vw == 4) {
#pragma unroll
    for (int c = 0; c < N; c += 4)
      if (c < f)
        *reinterpret_cast<float4*>(p + c) =
            make_float4(v[c], v[c + 1], v[c + 2], v[c + 3]);
  } else if (vw == 2) {
#pragma unroll
    for (int c = 0; c < N; c += 2)
      if (c < f)
        *reinterpret_cast<float2*>(p + c) = make_float2(v[c], v[c + 1]);
  } else {
#pragma unroll
    for (int c = 0; c < N; c++)
      if (c < f) p[c] = v[c];
  }
}

// ---- kernel 11, tiled instances

// One source at one pixel (y, x clamped). Texel (iy, ix) lies at
// base + (iy - y0) * row + (ix - x0) * tex: the source in global memory
// (y0 = x0 = 0; its last texel (hs-1, w-1) read a float at a time) or its
// staged box in shared memory.
template <int KIND, int N, bool GLOBAL>
__device__ __forceinline__ void sample(const float* base, long long row,
                                       int tex, int y0, int x0, int f,
                                       int vw, float y, float x, int hs,
                                       int w, float (&out)[N]) {
  if (KIND == HK_NEAREST) {
    int iy = (int)rintf(y), ix = (int)rintf(x);
    bool last = GLOBAL && iy == hs - 1 && ix == w - 1;
    load_texel<N, GLOBAL>(
        base + (iy - y0) * row + (long long)(ix - x0) * tex, f,
        last ? 1 : vw, out);
    return;
  }
  float wy[4], wx[4];
  int ry[4], rx[4];
  taps(y, hs, KIND, false, wy, ry);
  taps(x, w, KIND, false, wx, rx);
#pragma unroll
  for (int c = 0; c < N; c++) out[c] = 0.0f;
#pragma unroll
  for (int i = 0; i < 4; i++) {
    const float* rowp = base + (ry[i] - y0) * row;
    float xacc[N];
#pragma unroll
    for (int c = 0; c < N; c++) xacc[c] = 0.0f;
#pragma unroll
    for (int j = 0; j < 4; j++) {
      float v[N];
      bool last = GLOBAL && ry[i] == hs - 1 && rx[j] == w - 1;
      load_texel<N, GLOBAL>(rowp + (long long)(rx[j] - x0) * tex, f,
                            last ? 1 : vw, v);
#pragma unroll
      for (int c = 0; c < N; c++)
        if (c < f) xacc[c] = xacc[c] + wx[j] * v[c];
    }
#pragma unroll
    for (int c = 0; c < N; c++)
      if (c < f) out[c] = out[c] + wy[i] * xacc[c];
  }
}

// The texel rows / columns [lo, hi] one pixel's taps read along an axis
// of n texels (clamped coord c).
template <int KIND>
__device__ __forceinline__ void axis_box(float c, int n, int& lo, int& hi) {
  if (KIND == HK_NEAREST) {
    lo = hi = (int)rintf(c);
  } else {
    int i0 = (int)floorf(c);
    lo = clampi(i0 - 1, n - 1);
    hi = clampi(i0 + 2, n - 1);
  }
}

// The union of the box over the block: every thread gets it.
__device__ __forceinline__ void block_box(int& ylo, int& yhi, int& xlo,
                                          int& xhi) {
  __shared__ int red[4][TILE_H];
  const unsigned all = 0xffffffffu;
  ylo = __reduce_min_sync(all, ylo);
  yhi = __reduce_max_sync(all, yhi);
  xlo = __reduce_min_sync(all, xlo);
  xhi = __reduce_max_sync(all, xhi);
  if (threadIdx.x == 0) {           // a warp is one row of the tile
    red[0][threadIdx.y] = ylo;
    red[1][threadIdx.y] = yhi;
    red[2][threadIdx.y] = xlo;
    red[3][threadIdx.y] = xhi;
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < TILE_H; k++) {
    ylo = min(ylo, red[0][k]);
    yhi = max(yhi, red[1][k]);
    xlo = min(xlo, red[2][k]);
    xhi = max(xhi, red[3][k]);
  }
}

// Source s at this thread's pixel (when `in`); with STAGE, from shared
// memory when the block's box fits. Every thread of the block calls it
// (the staging synchronises).
template <int KIND, int N, bool STAGE>
__device__ __forceinline__ void band_source(const BandArgs& a, int s,
                                            bool in, long long pix, float y,
                                            float x, float* smem) {
  const BandCall& t = a.t;
  const int f = t.f[s], vw = a.vin[s], p = t.stride[s];
  float out[N];
  bool done = false;
  if constexpr (STAGE) {
    int ylo = INT_MAX, yhi = INT_MIN, xlo = INT_MAX, xhi = INT_MIN;
    if (in) {
      axis_box<KIND>(y, t.hs, ylo, yhi);
      axis_box<KIND>(x, t.w, xlo, xhi);
    }
    block_box(ylo, yhi, xlo, xhi);
    const int fs = (f + vw - 1) / vw * vw;      // floats staged a texel
    const int rows = yhi - ylo + 1, cols = xhi - xlo + 1;
    const bool staged = (long long)rows * cols * fs <= STAGE_FLOATS;
    if (t.blocks != nullptr && threadIdx.x == 0 && threadIdx.y == 0)
      atomicAdd(t.blocks + (staged ? 0 : 1), 1);
    if (staged) {
      const int per = fs / vw, total = rows * cols * per;
      const float* src = t.src[s];
      for (int k = threadIdx.y * TILE_W + threadIdx.x; k < total;
           k += TILE_W * TILE_H) {
        int texel = k / per, q = k - texel * per;
        int r = texel / cols, c = texel - r * cols;
        const float* g =
            src + ((long long)(ylo + r) * t.w + (xlo + c)) * p + q * vw;
        float* d = smem + texel * fs + q * vw;
        if (ylo + r == t.hs - 1 && xlo + c == t.w - 1) {
          // the source's last texel: its channels only
          for (int e = 0; e < vw && q * vw + e < f; e++)
            __pipeline_memcpy_async(d + e, g + e, 4);
        } else if (vw == 4)
          __pipeline_memcpy_async(d, g, 16);
        else if (vw == 2)
          __pipeline_memcpy_async(d, g, 8);
        else
          __pipeline_memcpy_async(d, g, 4);
      }
      __pipeline_commit();
      __pipeline_wait_prior(0);
      __syncthreads();
      if (in)
        sample<KIND, N, false>(smem, (long long)cols * fs, fs, ylo, xlo, f,
                               vw, y, x, t.hs, t.w, out);
      done = true;
    }
  }
  if (!in) return;
  if (!done)
    sample<KIND, N, true>(t.src[s], (long long)t.w * p, p, 0, 0, f, vw, y,
                          x, t.hs, t.w, out);
  store_px<N>(t.dst[s] + pix * f, f, a.vout[s], out);
}

// Sources 0 (kind K0, <= N0 channels; staged when filtered) and 1 (K1,
// <= N1; HK_NONE: absent) at 32x8 tiles of output pixels.
template <int K0, int N0, int K1, int N1>
__global__ void __launch_bounds__(TILE_W* TILE_H)
    warp_band_tiled(BandArgs a) {
  extern __shared__ __align__(16) float smem[];
  const BandCall& t = a.t;
  int px = blockIdx.x * TILE_W + threadIdx.x;
  int py = blockIdx.y * TILE_H + threadIdx.y;
  bool in = px < t.w && py < t.h;
  long long pix = (long long)py * t.w + px;
  float y = 0.0f, x = 0.0f;
  if (in) {
    y = clampf(__ldg(t.sy + pix), (float)(t.hs - 1));
    x = clampf(__ldg(t.sx + pix), (float)(t.w - 1));
  }
  band_source<K0, N0, K0 != HK_NEAREST>(a, 0, in, pix, y, x, smem);
  if constexpr (K1 != HK_NONE)
    band_source<K1, N1, false>(a, 1, in, pix, y, x, smem);
}

// ---- kernel 11, generic instance: any kinds, any channel count, scalar
// loads, no staging

__global__ void __launch_bounds__(TILE_W* TILE_H)
    warp_band_generic(BandArgs a) {
  const BandCall& t = a.t;
  int px = blockIdx.x * TILE_W + threadIdx.x;
  int py = blockIdx.y * TILE_H + threadIdx.y;
  if (px >= t.w || py >= t.h) return;
  long long pix = (long long)py * t.w + px;
  int w = t.w, hs = t.hs;
  float y = clampf(t.sy[pix], (float)(hs - 1));
  float x = clampf(t.sx[pix], (float)(w - 1));
#pragma unroll
  for (int s = 0; s < HK_MAX_WARP; s++) {
    if (s >= t.n_src) break;
    const float* src = t.src[s];
    float* dst = t.dst[s] + pix * t.f[s];
    int p = t.stride[s];
    if (t.kind[s] == HK_NEAREST) {
      const float* q =
          src + ((long long)(int)rintf(y) * w + (int)rintf(x)) * p;
      for (int c = 0; c < t.f[s]; c++) dst[c] = q[c];
      continue;
    }
    float wy[4], wx[4];
    int ry[4], rx[4];
    taps(y, hs, t.kind[s], false, wy, ry);
    taps(x, w, t.kind[s], false, wx, rx);
    for (int c = 0; c < t.f[s]; c++) {
      float acc = 0.0f;
#pragma unroll
      for (int i = 0; i < 4; i++) {
        const float* row = src + (long long)ry[i] * w * p + c;
        float xacc = 0.0f;
#pragma unroll
        for (int j = 0; j < 4; j++)
          xacc = xacc + wx[j] * row[(long long)rx[j] * p];
        acc = acc + wy[i] * xacc;
      }
      dst[c] = acc;
    }
  }
}

// ---- kernel 12

// Every reduce nearest, <= 16 channels each, at 32x8 tiles: one vector
// fetch per reduce (the texel's channel range) and vector stores.
template <bool BF16>
__global__ void __launch_bounds__(TILE_W* TILE_H)
    warp_multi_nearest(MultiArgs a) {
  const MultiCall& t = a.t;
  int px = blockIdx.x * TILE_W + threadIdx.x;
  int py = blockIdx.y * TILE_H + threadIdx.y;
  if (px >= t.w || py >= t.h) return;
  long long pix = (long long)py * t.w + px;
  float y = clampf(__ldg(t.sy + pix), (float)(t.hs - 1));
  float x = clampf(__ldg(t.sx + pix), (float)(t.ws - 1));
#pragma unroll
  for (int r = 0; r < HK_MAX_WARP; r++) {
    if (r >= t.n_red) break;
    int iy = clampi((int)ceilf(y + t.offy[r] - 0.5f), t.hs - 1);
    int ix = clampi((int)ceilf(x + t.offx[r] - 0.5f), t.ws - 1);
    int nc = t.hi[r] - t.lo[r];
    bool last = iy == t.hs - 1 && ix == t.ws - 1;    // read a float at a time
    float v[16];
    load_texel<16, true>(t.src + ((long long)iy * t.ws + ix) * t.p + t.lo[r],
                         nc, last ? 1 : a.vin[r], v);
    if (BF16) {
#pragma unroll
      for (int c = 0; c < 16; c++)
        if (c < nc) v[c] = bf16_round(v[c]);
    }
    store_px<16>(t.dst[r] + pix * nc, nc, a.vout[r], v);
  }
}

// Any reduces (generic): scalar loads.
__global__ void __launch_bounds__(TILE_W* TILE_H)
    warp_multi_generic(MultiArgs a) {
  const MultiCall& t = a.t;
  int px = blockIdx.x * TILE_W + threadIdx.x;
  int py = blockIdx.y * TILE_H + threadIdx.y;
  if (px >= t.w || py >= t.h) return;
  long long pix = (long long)py * t.w + px;
  int hs = t.hs, ws = t.ws, p = t.p;
  bool bf16 = t.bf16 != 0;
  const float* src = t.src;
  float y = clampf(t.sy[pix], (float)(hs - 1));
  float x = clampf(t.sx[pix], (float)(ws - 1));
#pragma unroll
  for (int r = 0; r < HK_MAX_WARP; r++) {
    if (r >= t.n_red) break;
    float qy = y + t.offy[r], qx = x + t.offx[r];
    int lo = t.lo[r], nc = t.hi[r] - lo;
    float* dst = t.dst[r] + pix * nc;
    if (t.kind[r] == HK_NEAREST) {
      int iy = clampi((int)ceilf(qy - 0.5f), hs - 1);
      int ix = clampi((int)ceilf(qx - 0.5f), ws - 1);
      const float* q = src + ((long long)iy * ws + ix) * p + lo;
      for (int c = 0; c < nc; c++) dst[c] = bf16 ? bf16_round(q[c]) : q[c];
      continue;
    }
    float wy[4], wx[4];
    int ry[4], rx[4];
    taps(qy, hs, t.kind[r], bf16, wy, ry);
    taps(qx, ws, t.kind[r], bf16, wx, rx);
    for (int c = 0; c < nc; c++) {
      float acc = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; j++) {
        float s = 0.0f;
#pragma unroll
        for (int i = 0; i < 4; i++) {
          float v = src[((long long)ry[i] * ws + rx[j]) * p + lo + c];
          s = s + wy[i] * (bf16 ? bf16_round(v) : v);
        }
        acc = acc + s * wx[j];
      }
      dst[c] = acc;
    }
  }
}

// ---- entry points

// Floats per vector access (4, 2 or 1) of the channels from lo of texels
// `stride` floats apart from base: v divides the stride and the offset,
// and the address is aligned to v floats, so an access of the channels
// [lo, hi) rounded up to v stays within the texel's stride.
static int vec_width(const float* base, int stride, int lo) {
  for (int v = 4; v > 1; v /= 2)
    if (stride % v == 0 && lo % v == 0 &&
        (uintptr_t)(base + lo) % (sizeof(float) * v) == 0)
      return v;
  return 1;
}

static dim3 tiles(int h, int w) {
  return dim3((w + TILE_W - 1) / TILE_W, (h + TILE_H - 1) / TILE_H);
}

extern "C" int hk_warp_band(const BandCall* call, void* stream) {
  BandArgs a;
  a.t = *call;
  const BandCall& t = a.t;
  for (int s = 0; s < HK_MAX_WARP; s++) {
    bool on = s < t.n_src;
    a.vin[s] = on ? vec_width(t.src[s], t.stride[s], 0) : 1;
    a.vout[s] = on ? vec_width(t.dst[s], t.f[s], 0) : 1;
  }
  dim3 block(TILE_W, TILE_H), grid = tiles(t.h, t.w);
  cudaStream_t st = (cudaStream_t)stream;
  if (t.n_src == 2 && t.kind[0] == HK_CATMULL && t.kind[1] == HK_NEAREST &&
      t.f[0] <= 4 && t.f[1] <= 8)
    warp_band_tiled<HK_CATMULL, 4, HK_NEAREST, 8>
        <<<grid, block, STAGE_FLOATS * sizeof(float), st>>>(a);
  else if (t.n_src == 1 && t.kind[0] == HK_NEAREST && t.f[0] <= 4)
    warp_band_tiled<HK_NEAREST, 4, HK_NONE, 4><<<grid, block, 0, st>>>(a);
  else
    warp_band_generic<<<grid, block, 0, st>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int hk_warp_multi(const MultiCall* call, void* stream) {
  MultiArgs a;
  a.t = *call;
  const MultiCall& t = a.t;
  bool nearest = true;
  for (int r = 0; r < HK_MAX_WARP; r++) {
    bool on = r < t.n_red;
    int nc = t.hi[r] - t.lo[r];
    a.vin[r] = on ? vec_width(t.src, t.p, t.lo[r]) : 1;
    a.vout[r] = on ? vec_width(t.dst[r], nc, 0) : 1;
    if (on) nearest = nearest && t.kind[r] == HK_NEAREST && nc <= 16;
  }
  dim3 block(TILE_W, TILE_H), grid = tiles(t.h, t.w);
  cudaStream_t st = (cudaStream_t)stream;
  if (nearest && t.bf16)
    warp_multi_nearest<true><<<grid, block, 0, st>>>(a);
  else if (nearest)
    warp_multi_nearest<false><<<grid, block, 0, st>>>(a);
  else
    warp_multi_generic<<<grid, block, 0, st>>>(a);
  return (int)cudaGetLastError();
}
