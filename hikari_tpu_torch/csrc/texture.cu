// Kernel 14: the coherent atlas sampler, one thread per pixel for every
// requested texture slot.
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
// One launch samples every requested slot of a pixel (the primary
// surface's base colour and emissive on the textured paths): the thread
// reads the uv once and, per slot, the slot's texture id from the pixel's
// row of four ids, and writes the slot's texel to its own [n, 4] output
// (the outputs follow one another in one allocation). The arguments come
// as one table (SampleCall, ops/texture_pallas.py SAMPLE_TABLE), so the
// host passes two pointers per launch.
//
// Bound on the H100: bytes. Per pixel 8 B of uv, per slot 4 B of id and
// 16 B out, plus 16 B per texel tapped for a textured sample (four taps,
// at most the texels of the rects addressed); about 30 flops per textured
// sample. At 4-6 us of device time per launch the host's call decides the
// time by events, hence the one launch for all slots and the table.

#include <cuda_runtime.h>

#define HK_MAX_SLOTS 4
// values per pixel of the planes the ids and the uv are read from (a
// material's id row, velocity_uv)
#define HK_ROW 4

struct SampleCall {
  const float* atlas;  // [A_h, A_w, 4]
  const int* rect;     // [T, 4] (x0, y0, w, h)
  const int* ids;      // a pixel's ids at ids[p * HK_ROW + slot[s]]
  const float* uv;     // a pixel's uv at uv[p * HK_ROW + 0 / 1]
  float* out;          // slot s of pixel p at out[(s * n + p) * 4]
  int n, ah, aw, n_rect, n_slots;
  int slot[HK_MAX_SLOTS];
  int pad;
};
static_assert(sizeof(SampleCall) == 80, "SampleCall: ops/texture_pallas.py");

__device__ __forceinline__ int wrap(int i, int n) {
  int m = i % n;
  return m < 0 ? m + n : m;
}

__device__ __forceinline__ int clampi(int i, int hi) {
  return i < 0 ? 0 : (i > hi ? hi : i);
}

// The bilinear sample of texture t at the fractional (u, v) of one uv.
__device__ __forceinline__ float4 sample_one(const SampleCall& c, int t,
                                             float uvx, float uvy) {
  if (t < 0) return make_float4(1.0f, 1.0f, 1.0f, 1.0f);
  const float4* atlas = reinterpret_cast<const float4*>(c.atlas);
  int4 r = reinterpret_cast<const int4*>(c.rect)[t < c.n_rect ? t
                                                              : c.n_rect - 1];
  int twi = r.z > 1 ? r.z : 1;
  int thi = r.w > 1 ? r.w : 1;
  float u = uvx - floorf(uvx);
  float v = uvy - floorf(uvy);
  float fx = u * (float)twi - 0.5f;
  float fy = v * (float)thi - 0.5f;
  float ix = floorf(fx);
  float iy = floorf(fy);
  float ax = fx - ix;
  float ay = fy - iy;
  int xi = (int)ix, yi = (int)iy;
  int aw = c.aw;
  int xa = clampi(wrap(xi, twi) + r.x, aw - 1);
  int xb = clampi(wrap(xi + 1, twi) + r.x, aw - 1);
  int ya = clampi(wrap(yi, thi) + r.y, c.ah - 1);
  int yb = clampi(wrap(yi + 1, thi) + r.y, c.ah - 1);
  float4 c00 = atlas[(long long)ya * aw + xa];
  float4 c10 = atlas[(long long)ya * aw + xb];
  float4 c01 = atlas[(long long)yb * aw + xa];
  float4 c11 = atlas[(long long)yb * aw + xb];
  float bx = 1.0f - ax, by = 1.0f - ay;
#define HK_BLEND(q)                                                      \
  (((((c00.q * bx) * by) + ((c10.q * ax) * by)) + ((c01.q * bx) * ay)) + \
   ((c11.q * ax) * ay))
  return make_float4(HK_BLEND(x), HK_BLEND(y), HK_BLEND(z), HK_BLEND(w));
#undef HK_BLEND
}

__global__ void __launch_bounds__(256)
sample_kernel(const __grid_constant__ SampleCall c) {
  int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= c.n) return;
  const float* q = c.uv + (long long)p * HK_ROW;
  float uvx = q[0], uvy = q[1];
  const int* id = c.ids + (long long)p * HK_ROW;
  float4* out = reinterpret_cast<float4*>(c.out);
#pragma unroll
  for (int s = 0; s < HK_MAX_SLOTS; s++)
    if (s < c.n_slots)
      out[(long long)s * c.n + p] = sample_one(c, id[c.slot[s]], uvx, uvy);
}

extern "C" int hk_sample_atlas(const SampleCall* call, void* stream) {
  const SampleCall c = *call;
  if (c.n <= 0) return 0;
  if (c.n_slots < 1 || c.n_slots > HK_MAX_SLOTS)
    return (int)cudaErrorInvalidValue;
  int threads = 256;
  int blocks = (c.n + threads - 1) / threads;
  sample_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(c);
  return (int)cudaGetLastError();
}
