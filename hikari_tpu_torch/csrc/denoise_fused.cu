// Kernel C: one a-trous level for C channels, on tiles staged in shared
// memory.
//
// Replaces hikari_tpu/ops/denoise_fused.py:_build_kernel (launched by
// atrous_level, four times per frame with steps 8/4/2/1). Per pixel and
// tap: the edge-stopping weight normal^16 * exp(-(|dz|/(|g.o|+0.01) +
// |dl| * denom)) * instance match * kernel (denoise.wgsl:43-66), the
// irradiance accumulation, and for firefly channels the 3-sigma clamp.
//
// Bound on the H100: bytes. A level must read 8 C + 24 bytes per pixel
// (irradiance 6 C, geometry 2 (2 + C), depth/instance/normal 20) and
// write 6 C: at C = 2, 40 + 12 bytes, at 1080p 83 MB in (more than the
// 50 MB L2) and 25 MB out, 32 us at 3.35 TB/s; ~500 flops per pixel at
// C = 2 (~1 GFLOP: 16 us at 67 TFLOP/s f32).
//
// What held the first design (one thread per pixel, every tap read from
// global memory) at ~10x that bound was not DRAM: at 960x540, where the
// level's 21 MB of inputs sit in L2, it still ran 12x its bound (NVIDIA
// H100 80GB HBM3, 700 W; chip_smoke.py). Each
// pixel issued ~103 scalar loads at C = 2 (the centre's 15 words, 8 taps
// x 11 planes), and a vertical tap `step` rows away lands on other cache
// lines for every plane, so the loads and their latency to L2 bound it.
//
// Design: a block covers 64 consecutive columns and 8 rows spaced `step`
// apart (rows y0 + k * step, one residue class of the rows modulo step),
// so its taps read only 10 rows: y0 - step .. y0 + 8 step. Its 64 x 4
// threads stage those 10 rows x (64 + 2 step) columns of the planes the
// taps read (f32s 5, irradiance 3C) in shared memory; then each thread
// filters two of the 8 rows (k and k + 4), its 9 taps read from shared
// memory. Each word comes from L2/DRAM about once per block (the halo
// costs 1.29x at step 1, 1.56x at step 8; a plain 2D tile would cost 4.5x
// at step 8). The geometry planes are read at the centre only, straight
// from global memory. Staging copies 16-byte chunks with cp.async when W
// is a multiple of 8 (every row of every plane then starts 16-byte
// aligned); at other widths it copies word by word. A staged row starts
// at the 8-aligned column at or left of x0 - step, so every chunk stays
// aligned in shared memory too. Rows and columns outside the true H x W
// are not staged: their taps are skipped by coordinate, never read.
// Shared memory: 10 rows x 80 columns x (20 + 6 C) bytes, 30.4 KB at C =
// 3. The cascade's steps (1, 2, 4, 8), the only ones it takes, are
// template instances, so tap offsets are immediates. What bounds the
// staged kernel is the instructions it issues (per pixel at C = 2, with
// --fmad=false: 16 expf, 8 IEEE divisions, 16 bad-texel tests, the
// accumulations and the address arithmetic), not memory; zero dividends
// skip the division's slow path (div_ieee). The arithmetic is the first design's, term for
// term (channels are a template parameter so the accumulators stay in
// registers), so the words equal its. Results are rounded to bf16 to
// nearest even, as XLA's astype does.
//
// Row sharding (parallel/shard.py, ops/denoise_fused.py levels_island): a
// rank's call filters its block of rows with a halo of neighbour rows
// above and below; `row0` is the image row of the planes' first row and
// `rows` the image's rows, and a tap whose image row lies outside
// [0, rows) is skipped as at the image's edge (the halo rows there are
// zeros, never read). The whole image is row0 = 0, rows = h.

#include <cuda_bf16.h>
#include <cuda_pipeline.h>

#include "common.cuh"

#define MAX_CH 3
#define TILE_W 64               // columns of a block
#define TILE_R 8                // rows of a block, `step` apart
#define THREADS_Y 4             // a thread takes rows k and k + 4
#define HALO_R (TILE_R + 2)     // staged rows: one tap row above and below
#define N_F32 5                 // depth, instance, nx, ny, nz

__constant__ float K_ATROUS[3][3] = {{0.0625f, 0.125f, 0.0625f},
                                     {0.125f, 0.25f, 0.125f},
                                     {0.0625f, 0.125f, 0.0625f}};

__device__ __forceinline__ bool bad_rgb(float r, float g, float b) {
  return !(isfinite(r) && isfinite(g) && isfinite(b)) || r > HK_F32_MAX ||
         g > HK_F32_MAX || b > HK_F32_MAX;
}

// a / b, the IEEE quotient. A zero dividend over b > 0 is answered
// without the division (a, its sign kept, as IEEE gives): the hardware's
// correctly rounded division takes its slow path on a zero dividend, and
// zero depth differences and luminance sums fill the dark and empty parts
// of a frame.
__device__ __forceinline__ float div_ieee(float a, float b) {
  return a == 0.0f && b > 0.0f ? a : a / b;
}

// The 8-aligned column at or left of c (c may be negative).
__host__ __device__ __forceinline__ int floor8(int c) {
  return c - (((c % 8) + 8) % 8);
}

// Words of a staged row: from floor8(x0 - step) to the last tap column.
__host__ __device__ __forceinline__ int stage_width(int step) {
  int lead = (8 - step % 8) % 8;        // (x0 - step) - floor8(x0 - step)
  return (lead + TILE_W + 2 * step + 7) / 8 * 8;
}

// One instance per channel count and step of the cascade (1, 2, 4, 8), so
// tap offsets in shared memory are immediates.
template <int NCH, int STEP>
__global__ void __launch_bounds__(TILE_W* THREADS_Y)
atrous_kernel(const __nv_bfloat16* __restrict__ irr,
              const __nv_bfloat16* __restrict__ geo,
              const float* __restrict__ f32s, int ffs_mask, int h, int w,
              int row0, int rows, int vec, __nv_bfloat16* __restrict__ out) {
  extern __shared__ float4 smem4[];
  const int step = STEP;
  const int sw = stage_width(STEP);
  const int np = HALO_R * sw;           // words of a staged plane
  float* s_f = reinterpret_cast<float*>(smem4);         // [5][HALO_R][sw]
  __nv_bfloat16* s_i =
      reinterpret_cast<__nv_bfloat16*>(s_f + N_F32 * np);  // [3C][..][sw]
  const long long npix = (long long)h * w;

  const int tid = threadIdx.y * TILE_W + threadIdx.x;
  const int x0 = blockIdx.x * TILE_W;
  const int y0 = blockIdx.y % step + (blockIdx.y / step) * TILE_R * step;
  const int base = floor8(x0 - step);   // shared column 0
  // the planes' rows that lie in the image: the taps' row range
  const int y_lo = max(0, -row0), y_hi = min(h, rows - row0);
  const int c_lo = max(x0 - step, 0);
  const int c_hi = min(x0 + TILE_W + step, w);

  // --- stage rows y0 + (r - 1) * step, r = 0..9, columns [c_lo, c_hi)
  if (vec) {
    const int va = c_lo & ~7, vb = (c_hi + 7) & ~7;    // vb <= w
    const int nf = (vb - va) >> 2, nb = (vb - va) >> 3;
    const int tot_f = N_F32 * HALO_R * nf;
    const int tot = tot_f + 3 * NCH * HALO_R * nb;
    for (int k = tid; k < tot; k += TILE_W * THREADS_Y) {
      const bool f = k < tot_f;
      const int kk = f ? k : k - tot_f;
      const int per = f ? nf : nb;
      const int pr = kk / per, q = kk - pr * per;
      const int p = pr / HALO_R, r = pr - p * HALO_R;
      const int y = y0 + (r - 1) * step;
      if (y < 0 || y >= h) continue;
      const long long g = p * npix + (long long)y * w;
      if (f) {
        const int col = va + 4 * q;
        __pipeline_memcpy_async(s_f + pr * sw + (col - base),
                                f32s + g + col, 16);
      } else {
        const int col = va + 8 * q;
        __pipeline_memcpy_async(s_i + pr * sw + (col - base), irr + g + col,
                                16);
      }
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
  } else {
    const int cols = c_hi - c_lo;
    const int tot_f = N_F32 * HALO_R * cols;
    const int tot = tot_f + 3 * NCH * HALO_R * cols;
    for (int k = tid; k < tot; k += TILE_W * THREADS_Y) {
      const bool f = k < tot_f;
      const int kk = f ? k : k - tot_f;
      const int pr = kk / cols, col = c_lo + (kk - pr * cols);
      const int p = pr / HALO_R, r = pr - p * HALO_R;
      const int y = y0 + (r - 1) * step;
      if (y < 0 || y >= h) continue;
      const long long g = p * npix + (long long)y * w + col;
      if (f)
        s_f[pr * sw + (col - base)] = f32s[g];
      else
        s_i[pr * sw + (col - base)] = irr[g];
    }
  }
  __syncthreads();

  const int x = x0 + threadIdx.x;
  if (x >= w) return;
  for (int k = threadIdx.y; k < TILE_R; k += THREADS_Y) {
    const int y = y0 + k * step;
    if (y >= h) return;
    const long long pix = (long long)y * w + x;
    const int s0 = (k + 1) * sw + (x - base);  // centre, in a plane

    float gx = __bfloat162float(geo[pix]);
    float gy = __bfloat162float(geo[npix + pix]);
    float d0 = s_f[s0];
    float i0 = s_f[np + s0];
    float n0x = s_f[2 * np + s0], n0y = s_f[3 * np + s0],
          n0z = s_f[4 * np + s0];
    float k_center = K_ATROUS[1][1];

    float denom[NCH], lum0[NCH], sum_w[NCH];
    float sum_irr[NCH][3];
    float ff_m1[NCH], ff_m2[NCH], ff_cnt[NCH];
#pragma unroll
    for (int c = 0; c < NCH; c++) {
      denom[c] = __bfloat162float(geo[(2 + c) * npix + pix]);
      float r = __bfloat162float(s_i[(3 * c) * np + s0]);
      float g = __bfloat162float(s_i[(3 * c + 1) * np + s0]);
      float b = __bfloat162float(s_i[(3 * c + 2) * np + s0]);
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

#pragma unroll
    for (int oy = -1; oy <= 1; oy++) {
#pragma unroll
      for (int ox = -1; ox <= 1; ox++) {
        if (oy == 0 && ox == 0) continue;
        int ty = y + oy * step, tx = x + ox * step;
        if (ty < y_lo || ty >= y_hi || tx < 0 || tx >= w) continue;
        int t = s0 + oy * sw + ox * step;
        float k_tap = K_ATROUS[oy + 1][ox + 1];
        float nw = fmaxf(0.0f, n0x * s_f[2 * np + t] +
                                   n0y * s_f[3 * np + t] +
                                   n0z * s_f[4 * np + t]);
        nw = nw * nw;
        nw = nw * nw;
        nw = nw * nw;
        nw = nw * nw;
        float iw = fmaxf(0.0f, 1.0f - fabsf(i0 - s_f[np + t]));
        float geo_w = nw * iw * k_tap;
        float dg = fabsf(gx * (float)ox + gy * (float)oy);
        float d_arg = div_ieee(fabsf(d0 - s_f[t]), dg + 0.01f);
#pragma unroll
        for (int c = 0; c < NCH; c++) {
          float r = __bfloat162float(s_i[(3 * c) * np + t]);
          float g = __bfloat162float(s_i[(3 * c + 1) * np + t]);
          float b = __bfloat162float(s_i[(3 * c + 2) * np + t]);
          if (bad_rgb(r, g, b)) continue;
          float s_lum = lum3(r, g, b);
          float wgt =
              geo_w * expf(-(d_arg + fabsf(lum0[c] - s_lum) * denom[c]));
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

#pragma unroll
    for (int c = 0; c < NCH; c++) {
      float wsum = sum_w[c];
      bool zero = wsum < 1e-4f;
      float inv = 1.0f / fmaxf(wsum, 1e-4f);
      float ni[3];
      for (int i = 0; i < 3; i++) ni[i] = zero ? 0.0f : sum_irr[c][i] * inv;
      if (ffs_mask & (1 << c)) {
        float cnt = fmaxf(ff_cnt[c], 1.0f);
        float mean = div_ieee(ff_m1[c], cnt);
        float var = div_ieee(ff_m2[c], cnt) - mean * mean;
        bool fire = lum0[c] > mean + 3.0f * sqrtf(fmaxf(var, 0.0f));
        float scale = div_ieee(mean, fmaxf(lum0[c], 1e-30f));
        if (fire)
          for (int i = 0; i < 3; i++) ni[i] = scale * ni[i];
      }
      for (int i = 0; i < 3; i++)
        out[(3 * c + i) * npix + pix] = __float2bfloat16_rn(ni[i]);
    }
  }
}

template <int NCH, int STEP>
static int launch_step(const void* irr, const void* geo, const float* f32s,
                       int ffs_mask, int h, int w, int row0, int rows,
                       void* out, cudaStream_t stream) {
  // <= 30.4 KB: no opt-in above the default 48 KB
  const size_t smem =
      (size_t)HALO_R * stage_width(STEP) * (N_F32 * 4 + 3 * NCH * 2);
  // 16-byte chunks: every plane row starts 16-byte aligned
  const int vec = w % 8 == 0 && ((uintptr_t)irr | (uintptr_t)f32s) % 16 == 0;
  const int groups = ((h + STEP - 1) / STEP + TILE_R - 1) / TILE_R;
  dim3 grid((w + TILE_W - 1) / TILE_W, STEP * groups);
  atrous_kernel<NCH, STEP><<<grid, dim3(TILE_W, THREADS_Y), smem, stream>>>(
      (const __nv_bfloat16*)irr, (const __nv_bfloat16*)geo, f32s, ffs_mask,
      h, w, row0, rows, vec, (__nv_bfloat16*)out);
  return (int)cudaGetLastError();
}

template <int NCH>
static int launch(const void* irr, const void* geo, const float* f32s,
                  int ffs_mask, int step, int h, int w, int row0, int rows,
                  void* out, cudaStream_t stream) {
  switch (step) {
    case 1:
      return launch_step<NCH, 1>(irr, geo, f32s, ffs_mask, h, w, row0, rows,
                                 out, stream);
    case 2:
      return launch_step<NCH, 2>(irr, geo, f32s, ffs_mask, h, w, row0, rows,
                                 out, stream);
    case 4:
      return launch_step<NCH, 4>(irr, geo, f32s, ffs_mask, h, w, row0, rows,
                                 out, stream);
    case 8:
      return launch_step<NCH, 8>(irr, geo, f32s, ffs_mask, h, w, row0, rows,
                                 out, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// row0, rows: the image row of the planes' first row and the image's
// rows (0 and h for the whole image)
extern "C" int hk_atrous_level(const void* irr, const void* geo,
                               const float* f32s, int nch, int ffs_mask,
                               int step, int h, int w, int row0, int rows,
                               void* out, void* stream) {
  if (h < 1 || w < 1 || rows < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (nch) {
    case 1:
      return launch<1>(irr, geo, f32s, ffs_mask, step, h, w, row0, rows, out,
                       s);
    case 2:
      return launch<2>(irr, geo, f32s, ffs_mask, step, h, w, row0, rows, out,
                       s);
    case 3:
      return launch<3>(irr, geo, f32s, ffs_mask, step, h, w, row0, rows, out,
                       s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
