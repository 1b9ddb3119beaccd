// Kernels 11 and 12: the history warps of TAA and SMAA, one thread per
// output pixel.
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
// Design: the TPU kernels' banded or 32-row group windows, lane rolls,
// scalar-prefetch packs and lane-packed panels exist because the TPU has no
// per-lane gather; here each thread loads its taps directly, which is the
// exact per-pixel filter. Within the TPU kernels' band / window the results
// agree; outside it the TPU clamps local coords to the window edge (an
// approximation every caller rejects), the port does not. The sums run in
// the plain versions' order (rows of x-taps, then over y; warp_multi: y-taps
// per column, then over x) and are compiled with --fmad=false, so a kernel
// rounds like its plain version.
//
// Bound on the H100: bytes. Per pixel a source channel costs one read and
// one write of 4 B (8 B of coords shared) against at most 16 taps of
// 2 flops plus the weights; neighbouring threads read neighbouring taps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define HK_MAX_WARP 4
#define HK_NEAREST 0
#define HK_BILINEAR 1
#define HK_CATMULL 2

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

struct BandArgs {
  const float* src[HK_MAX_WARP];
  float* dst[HK_MAX_WARP];
  int kind[HK_MAX_WARP];
  int f[HK_MAX_WARP];
  int stride[HK_MAX_WARP];
};

__global__ void __launch_bounds__(256)
warp_band_kernel(BandArgs a, int n_src, const float* __restrict__ sy,
                 const float* __restrict__ sx, int h, int w, int hs) {
  int pix = blockIdx.x * blockDim.x + threadIdx.x;
  if (pix >= h * w) return;
  float y = clampf(sy[pix], (float)(hs - 1));
  float x = clampf(sx[pix], (float)(w - 1));
#pragma unroll
  for (int s = 0; s < HK_MAX_WARP; s++) {
    if (s >= n_src) break;
    const float* src = a.src[s];
    float* dst = a.dst[s] + (long long)pix * a.f[s];
    int p = a.stride[s];
    if (a.kind[s] == HK_NEAREST) {
      const float* t =
          src + ((long long)(int)rintf(y) * w + (int)rintf(x)) * p;
      for (int c = 0; c < a.f[s]; c++) dst[c] = t[c];
      continue;
    }
    float wy[4], wx[4];
    int ry[4], rx[4];
    taps(y, hs, a.kind[s], false, wy, ry);
    taps(x, w, a.kind[s], false, wx, rx);
    for (int c = 0; c < a.f[s]; c++) {
      float acc = 0.0f;
#pragma unroll
      for (int i = 0; i < 4; i++) {
        const float* row = src + (long long)ry[i] * w * p + c;
        float xacc = 0.0f;
#pragma unroll
        for (int j = 0; j < 4; j++) xacc = xacc + wx[j] * row[rx[j] * p];
        acc = acc + wy[i] * xacc;
      }
      dst[c] = acc;
    }
  }
}

struct MultiArgs {
  float* dst[HK_MAX_WARP];
  int kind[HK_MAX_WARP];
  float offy[HK_MAX_WARP];
  float offx[HK_MAX_WARP];
  int lo[HK_MAX_WARP];
  int hi[HK_MAX_WARP];
};

__global__ void __launch_bounds__(256)
warp_multi_kernel(MultiArgs a, int n_red, const float* __restrict__ src,
                  int hs, int ws, int p, const float* __restrict__ sy,
                  const float* __restrict__ sx, int h, int w, int bf16) {
  int pix = blockIdx.x * blockDim.x + threadIdx.x;
  if (pix >= h * w) return;
  float y = clampf(sy[pix], (float)(hs - 1));
  float x = clampf(sx[pix], (float)(ws - 1));
#pragma unroll
  for (int r = 0; r < HK_MAX_WARP; r++) {
    if (r >= n_red) break;
    float qy = y + a.offy[r], qx = x + a.offx[r];
    int lo = a.lo[r], nc = a.hi[r] - lo;
    float* dst = a.dst[r] + (long long)pix * nc;
    if (a.kind[r] == HK_NEAREST) {
      int iy = clampi((int)ceilf(qy - 0.5f), hs - 1);
      int ix = clampi((int)ceilf(qx - 0.5f), ws - 1);
      const float* t = src + ((long long)iy * ws + ix) * p + lo;
      for (int c = 0; c < nc; c++)
        dst[c] = bf16 ? bf16_round(t[c]) : t[c];
      continue;
    }
    float wy[4], wx[4];
    int ry[4], rx[4];
    taps(qy, hs, a.kind[r], bf16, wy, ry);
    taps(qx, ws, a.kind[r], bf16, wx, rx);
    for (int c = 0; c < nc; c++) {
      float acc = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; j++) {
        float t = 0.0f;
#pragma unroll
        for (int i = 0; i < 4; i++) {
          float v = src[((long long)ry[i] * ws + rx[j]) * p + lo + c];
          t = t + wy[i] * (bf16 ? bf16_round(v) : v);
        }
        acc = acc + t * wx[j];
      }
      dst[c] = acc;
    }
  }
}

extern "C" int hk_warp_band(const float* sy, const float* sx, int h, int w,
                            int hs, int n_src, const float* s0,
                            const float* s1, const float* s2, const float* s3,
                            float* d0, float* d1, float* d2, float* d3, int k0,
                            int k1, int k2, int k3, int f0, int f1, int f2,
                            int f3, int p0, int p1, int p2, int p3,
                            void* stream) {
  BandArgs a = {{s0, s1, s2, s3}, {d0, d1, d2, d3}, {k0, k1, k2, k3},
                {f0, f1, f2, f3}, {p0, p1, p2, p3}};
  int threads = 256;
  int blocks = (h * w + threads - 1) / threads;
  warp_band_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      a, n_src, sy, sx, h, w, hs);
  return (int)cudaGetLastError();
}

extern "C" int hk_warp_multi(const float* src, int hs, int ws, int p,
                             const float* sy, const float* sx, int h, int w,
                             int bf16, int n_red, float* d0, float* d1,
                             float* d2, float* d3, int k0, int k1, int k2,
                             int k3, float oy0, float oy1, float oy2,
                             float oy3, float ox0, float ox1, float ox2,
                             float ox3, int lo0, int lo1, int lo2, int lo3,
                             int hi0, int hi1, int hi2, int hi3,
                             void* stream) {
  MultiArgs a = {{d0, d1, d2, d3},     {k0, k1, k2, k3},
                 {oy0, oy1, oy2, oy3}, {ox0, ox1, ox2, ox3},
                 {lo0, lo1, lo2, lo3}, {hi0, hi1, hi2, hi3}};
  int threads = 256;
  int blocks = (h * w + threads - 1) / threads;
  warp_multi_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      a, n_red, src, hs, ws, p, sy, sx, h, w, bf16);
  return (int)cudaGetLastError();
}
