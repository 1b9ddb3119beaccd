// Kernel C: one a-trous level for C channels, one thread per pixel.
//
// Replaces hikari_tpu/ops/denoise_fused.py:_build_kernel (launched by
// atrous_level, four times per frame with steps 8/4/2/1). Per pixel and
// tap: the edge-stopping weight normal^16 * exp(-(|dz|/(|g.o|+0.01) +
// |dl| * denom)) * instance match * kernel (denoise.wgsl:43-66), the
// irradiance accumulation, and for firefly channels the 3-sigma clamp.
//
// Design: taps are read straight from global memory. The stacks are
// planes ([3C,h,w] bf16 irradiance, [2+C,h,w] bf16 geometry, [5,h,w] f32
// depth/instance/normal), so a warp's 32 threads read 32 neighbouring
// values of one plane per tap; at 1080p the level's ~45 MB of inputs stay
// in the 50 MB L2 across the 8 taps. Taps outside the true h x w are
// skipped (the TPU kernel's row padding and block triple are gone).
// Results are rounded to bf16 to nearest even, as XLA's astype does.
//
// Bound on the H100: bytes. A level must read 10 C + 24 bytes per pixel
// and write 6 C (52 bytes at C=2, ~108 MB at 1080p: 32 us at 3.35 TB/s),
// against ~500 flops per pixel at C=2 (~1 GFLOP: 16 us at 67 TFLOP/s).

#include <cuda_bf16.h>

#include "common.cuh"

#define MAX_CH 3

__constant__ float K_ATROUS[3][3] = {{0.0625f, 0.125f, 0.0625f},
                                     {0.125f, 0.25f, 0.125f},
                                     {0.0625f, 0.125f, 0.0625f}};

__device__ __forceinline__ bool bad_rgb(float r, float g, float b) {
  return !(isfinite(r) && isfinite(g) && isfinite(b)) || r > HK_F32_MAX ||
         g > HK_F32_MAX || b > HK_F32_MAX;
}

__global__ void __launch_bounds__(256)
atrous_kernel(const __nv_bfloat16* __restrict__ irr,
              const __nv_bfloat16* __restrict__ geo,
              const float* __restrict__ f32s, int nch, int ffs_mask, int step,
              int h, int w, __nv_bfloat16* __restrict__ out) {
  int pix = blockIdx.x * blockDim.x + threadIdx.x;
  int npix = h * w;
  if (pix >= npix) return;
  int y = pix / w, x = pix % w;

  float gx = __bfloat162float(geo[pix]);
  float gy = __bfloat162float(geo[npix + pix]);
  float d0 = f32s[pix];
  float i0 = f32s[npix + pix];
  float n0x = f32s[2 * npix + pix], n0y = f32s[3 * npix + pix],
        n0z = f32s[4 * npix + pix];
  float k_center = K_ATROUS[1][1];

  float denom[MAX_CH], lum0[MAX_CH], sum_w[MAX_CH];
  float sum_irr[MAX_CH][3];
  float ff_m1[MAX_CH], ff_m2[MAX_CH], ff_cnt[MAX_CH];
  for (int c = 0; c < nch; c++) {
    denom[c] = __bfloat162float(geo[(2 + c) * npix + pix]);
    float r = __bfloat162float(irr[(3 * c) * npix + pix]);
    float g = __bfloat162float(irr[(3 * c + 1) * npix + pix]);
    float b = __bfloat162float(irr[(3 * c + 2) * npix + pix]);
    bool bad = bad_rgb(r, g, b);
    if (bad) r = g = b = 0.0f;
    lum0[c] = lum3(r, g, b);
    sum_irr[c][0] = r * k_center;
    sum_irr[c][1] = g * k_center;
    sum_irr[c][2] = b * k_center;
    sum_w[c] = bad ? 0.0f : k_center;
    ff_m1[c] = 0.0f;
    ff_m2[c] = 0.0f;
    ff_cnt[c] = 0.0f;
  }

  for (int oy = -1; oy <= 1; oy++) {
    for (int ox = -1; ox <= 1; ox++) {
      if (oy == 0 && ox == 0) continue;
      int ty = y + oy * step, tx = x + ox * step;
      if (ty < 0 || ty >= h || tx < 0 || tx >= w) continue;
      int t = ty * w + tx;
      float k_tap = K_ATROUS[oy + 1][ox + 1];
      float nw = fmaxf(0.0f, n0x * f32s[2 * npix + t] +
                                 n0y * f32s[3 * npix + t] +
                                 n0z * f32s[4 * npix + t]);
      nw = nw * nw;
      nw = nw * nw;
      nw = nw * nw;
      nw = nw * nw;
      float iw = fmaxf(0.0f, 1.0f - fabsf(i0 - f32s[npix + t]));
      float geo_w = nw * iw * k_tap;
      float dg = fabsf(gx * (float)ox + gy * (float)oy);
      float d_arg = fabsf(d0 - f32s[t]) / (dg + 0.01f);
      for (int c = 0; c < nch; c++) {
        float r = __bfloat162float(irr[(3 * c) * npix + t]);
        float g = __bfloat162float(irr[(3 * c + 1) * npix + t]);
        float b = __bfloat162float(irr[(3 * c + 2) * npix + t]);
        if (bad_rgb(r, g, b)) continue;
        float s_lum = lum3(r, g, b);
        float wgt = geo_w * expf(-(d_arg + fabsf(lum0[c] - s_lum) * denom[c]));
        sum_irr[c][0] = sum_irr[c][0] + r * wgt;
        sum_irr[c][1] = sum_irr[c][1] + g * wgt;
        sum_irr[c][2] = sum_irr[c][2] + b * wgt;
        sum_w[c] = sum_w[c] + wgt;
        if (ffs_mask & (1 << c)) {
          ff_m1[c] = ff_m1[c] + s_lum;
          ff_m2[c] = ff_m2[c] + s_lum * s_lum;
          ff_cnt[c] = ff_cnt[c] + 1.0f;
        }
      }
    }
  }

  for (int c = 0; c < nch; c++) {
    float wsum = sum_w[c];
    bool zero = wsum < 1e-4f;
    float inv = 1.0f / fmaxf(wsum, 1e-4f);
    float ni[3];
    for (int i = 0; i < 3; i++) ni[i] = zero ? 0.0f : sum_irr[c][i] * inv;
    if (ffs_mask & (1 << c)) {
      float cnt = fmaxf(ff_cnt[c], 1.0f);
      float mean = ff_m1[c] / cnt;
      float var = ff_m2[c] / cnt - mean * mean;
      bool fire = lum0[c] > mean + 3.0f * sqrtf(fmaxf(var, 0.0f));
      float scale = mean / fmaxf(lum0[c], 1e-30f);
      if (fire)
        for (int i = 0; i < 3; i++) ni[i] = scale * ni[i];
    }
    for (int i = 0; i < 3; i++)
      out[(3 * c + i) * npix + pix] = __float2bfloat16_rn(ni[i]);
  }
}

extern "C" int hk_atrous_level(const void* irr, const void* geo,
                               const float* f32s, int nch, int ffs_mask,
                               int step, int h, int w, void* out,
                               void* stream) {
  if (nch < 1 || nch > MAX_CH) return (int)cudaErrorInvalidValue;
  int threads = 256;
  int blocks = (h * w + threads - 1) / threads;
  atrous_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)irr, (const __nv_bfloat16*)geo, f32s, nch,
      ffs_mask, step, h, w, (__nv_bfloat16*)out);
  return (int)cudaGetLastError();
}
