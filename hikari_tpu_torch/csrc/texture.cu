// Kernel 14: the coherent atlas sampler, one thread per pixel.
//
// Replaces hikari_tpu/ops/texture_pallas.py:_kernel (pallas_call in
// _sample_impl), reached from sample_atlas_coherent. Each pixel samples the
// f32 texture atlas [A_h, A_w, 4] bilinearly with repeat addressing, as
// ops/shading.py sample_atlas does: with its texture's rect (x0, y0, w, h),
//   u = uv.x - floor(uv.x), fx = u * w - 0.5, ix = floor(fx), ax = fx - ix
// (v, fy, iy, ay alike); the four texels (ix|ix+1, iy|iy+1) wrapped into the
// rect; blended as c00(1-ax)(1-ay) + c10 ax(1-ay) + c01(1-ax)ay + c11 ax ay,
// one operation at a time in that order. A tex_id of -1 gives 1.0.
//
// Design: the TPU kernel DMAs one bf16 window of a panel tiling per 16x16
// pixel group (the TPU has no per-lane gather), weighs it with a matrix
// product and clamps taps outside the window to its edge. Here each thread
// loads its four texels as float4 from the f32 atlas: the exact bilinear,
// with no window and no clamp. ix and iy are integer-valued floats, so the
// wrap is integer arithmetic and exact. Built with --fmad=false, the kernel
// equals its plain version bit for bit.
//
// Bound on the H100: bytes. Per pixel 12 B in (id, uv) and 16 B out, plus
// 16 B per texel tapped for a textured pixel (four taps, at most the texels
// of the rects addressed); about 30 flops per textured pixel.

#include <cuda_runtime.h>

__device__ __forceinline__ int wrap(int i, int n) {
  int m = i % n;
  return m < 0 ? m + n : m;
}

__device__ __forceinline__ int clampi(int i, int hi) {
  return i < 0 ? 0 : (i > hi ? hi : i);
}

__global__ void __launch_bounds__(256)
sample_kernel(const float4* __restrict__ atlas, const int4* __restrict__ rect,
              const int* __restrict__ tex_id, int id_stride,
              const float* __restrict__ uv, int uv_stride,
              float4* __restrict__ out, int n, int ah, int aw, int n_rect) {
  int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  int t = tex_id[(long long)p * id_stride];
  if (t < 0) {
    out[p] = make_float4(1.0f, 1.0f, 1.0f, 1.0f);
    return;
  }
  int4 r = rect[t < n_rect ? t : n_rect - 1];
  int twi = r.z > 1 ? r.z : 1;
  int thi = r.w > 1 ? r.w : 1;
  const float* q = uv + (long long)p * uv_stride;
  float uvx = q[0], uvy = q[1];
  float u = uvx - floorf(uvx);
  float v = uvy - floorf(uvy);
  float fx = u * (float)twi - 0.5f;
  float fy = v * (float)thi - 0.5f;
  float ix = floorf(fx);
  float iy = floorf(fy);
  float ax = fx - ix;
  float ay = fy - iy;
  int xi = (int)ix, yi = (int)iy;
  int xa = clampi(wrap(xi, twi) + r.x, aw - 1);
  int xb = clampi(wrap(xi + 1, twi) + r.x, aw - 1);
  int ya = clampi(wrap(yi, thi) + r.y, ah - 1);
  int yb = clampi(wrap(yi + 1, thi) + r.y, ah - 1);
  float4 c00 = atlas[(long long)ya * aw + xa];
  float4 c10 = atlas[(long long)ya * aw + xb];
  float4 c01 = atlas[(long long)yb * aw + xa];
  float4 c11 = atlas[(long long)yb * aw + xb];
  float bx = 1.0f - ax, by = 1.0f - ay;
#define HK_BLEND(c)                                                      \
  (((((c00.c * bx) * by) + ((c10.c * ax) * by)) + ((c01.c * bx) * ay)) + \
   ((c11.c * ax) * ay))
  out[p] = make_float4(HK_BLEND(x), HK_BLEND(y), HK_BLEND(z), HK_BLEND(w));
#undef HK_BLEND
}

extern "C" int hk_sample_atlas(const float* atlas, const int* rect,
                               const int* tex_id, const float* uv,
                               int id_stride, int uv_stride, float* out,
                               int n, int ah, int aw, int n_rect,
                               void* stream) {
  if (n <= 0) return 0;
  int threads = 256;
  int blocks = (n + threads - 1) / threads;
  sample_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float4*)atlas, (const int4*)rect, tex_id, id_stride, uv, uv_stride,
      (float4*)out, n, ah, aw, n_rect);
  return (int)cudaGetLastError();
}
