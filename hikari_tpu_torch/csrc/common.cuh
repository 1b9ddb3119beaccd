// Device functions shared by the port's kernels: Moller-Trumbore loops,
// the material lookup and the Burley/GGX shading chain of light.wgsl.
//
// Every expression keeps the operand order of its Python counterpart
// (hikari_tpu/ops/light_fused.py and the plain PyTorch versions beside each
// wrapper), and the sources are compiled with --fmad=false and IEEE
// division and square root, so a kernel rounds like its plain version one
// operation at a time.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define HK_F32_MAX 3.402823466e38f
#define HK_F32_EPS 1.1920929e-7f
#define HK_DISTANCE_MAX 65535.0f
#define HK_RAY_BIAS 0.02f
#define HK_GOLDEN 1.618033989f
#define HK_TAU 6.283185307f
// Python folds 2.0 * INV_TAU and 1.0 / PI in double before the f32 multiply
#define HK_TWO_INV_TAU ((float)(2.0 * 0.159154943))
#define HK_INV_PI ((float)(1.0 / 3.14159265358979))

// Floats per table row in shared memory.
#define HK_TRI 10   // v0 v1 v2 (9) + instance id
#define HK_MAT 11   // base rgba, emissive rgba, roughness, metallic, reflectance

struct f3 {
  float x, y, z;
};

__device__ __forceinline__ f3 mk3(float x, float y, float z) {
  f3 r;
  r.x = x;
  r.y = y;
  r.z = z;
  return r;
}

__device__ __forceinline__ float dot3(f3 a, f3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}

__device__ __forceinline__ f3 sub3(f3 a, f3 b) {
  return mk3(a.x - b.x, a.y - b.y, a.z - b.z);
}

__device__ __forceinline__ f3 add3(f3 a, f3 b) {
  return mk3(a.x + b.x, a.y + b.y, a.z + b.z);
}

// a + d * t (component-wise), the ray-point form of the Python code
__device__ __forceinline__ f3 ray_at(f3 o, f3 d, float t) {
  return mk3(o.x + d.x * t, o.y + d.y * t, o.z + d.z * t);
}

__device__ __forceinline__ f3 rsqrt_n(f3 v) {
  float inv = rsqrtf(fmaxf(v.x * v.x + v.y * v.y + v.z * v.z, 1e-20f));
  return mk3(v.x * inv, v.y * inv, v.z * inv);
}

__device__ __forceinline__ float lum3(float r, float g, float b) {
  return 0.2126f * r + 0.7152f * g + 0.0722f * b;
}

__device__ __forceinline__ float clip01(float x) {
  return fminf(fmaxf(x, 0.0f), 1.0f);
}

__device__ __forceinline__ float pow5(float x) {
  float x2 = x * x;
  return x2 * x2 * x;
}

__device__ __forceinline__ float sgnf(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
}

// apply_normal_basis (utils.wgsl:42-50): rotate l (z-up) into n's frame
__device__ __forceinline__ f3 onb_apply(f3 n, f3 l) {
  float s = fminf(sgnf(n.z) * 2.0f + 1.0f, 1.0f);
  float u = -1.0f / (s + n.z);
  float v = n.x * n.y * u;
  float tx = 1.0f + s * n.x * n.x * u;
  float ty = s * v;
  float tz = -s * n.x;
  float bx = v;
  float by = s + n.y * n.y * u;
  float bz = -n.y;
  return mk3(tx * l.x + bx * l.y + n.x * l.z,
             ty * l.x + by * l.y + n.y * l.z,
             tz * l.x + bz * l.y + n.z * l.z);
}

// Karis EnvBRDFApprox for one colour
__device__ __forceinline__ f3 env_brdf_approx(f3 f0, float pr, float nov) {
  float r0 = 1.0f - pr;
  float r1 = 0.0425f - 0.0275f * pr;
  float r2 = 1.04f - 0.572f * pr;
  float r3 = 0.022f * pr - 0.04f;
  float a004 = fminf(r0 * r0, exp2f(-9.28f * nov)) * r0 + r1;
  float ab_x = -1.04f * a004 + r2;
  float ab_y = 1.04f * a004 + r3;
  return mk3(f0.x * ab_x + ab_y, f0.y * ab_x + ab_y, f0.z * ab_x + ab_y);
}

struct Surface {
  f3 em;
  float em_a;
  float rough;
  f3 f0;
  f3 diff;
};

// The material id a pass shades with, from a G-buffer instance_material
// .y: truncated to int, at least 0 (ops/light_fused.py material_ids).
__device__ __forceinline__ float material_id(float y) {
  return (float)max((int)y, 0);
}

// Row index of a float material id: hikari_tpu's select-sweep keeps row 0
// unless the id equals a row number exactly.
__device__ __forceinline__ int row_of(float f, int n) {
  int i = (int)f;
  return (i >= 0 && i < n && (float)i == f) ? i : 0;
}

__device__ __forceinline__ Surface surface_of(const float* mats, int n_mats,
                                              float mat_f) {
  const float* m = mats + HK_MAT * row_of(mat_f, n_mats);
  Surface s;
  float br = m[0], bg = m[1], bb = m[2];
  s.em = mk3(m[4], m[5], m[6]);
  s.em_a = m[7];
  float clamped = fminf(fmaxf(m[8], 0.089f), 1.0f);
  s.rough = clamped * clamped;
  float metal = m[9];
  float refl = m[10];
  float f = 0.16f * refl * refl * (1.0f - metal);
  s.f0 = mk3(f + br * metal, f + bg * metal, f + bb * metal);
  s.diff = mk3(br * (1.0f - metal), bg * (1.0f - metal), bb * (1.0f - metal));
  return s;
}

// shading() (light.wgsl:869-888): lit * a + ambient * (1 - a)
__device__ __forceinline__ f3 shade(const Surface& s, f3 amb, f3 v, f3 n,
                                    f3 l, f3 rad, float rad_a) {
  f3 h = rsqrt_n(add3(l, v));
  float nol = clip01(dot3(n, l));
  float noh = clip01(dot3(n, h));
  float loh = clip01(dot3(l, h));
  float nov = fmaxf(dot3(n, v), 0.0001f);
  float rough = s.rough;
  float f90 = 0.5f + 2.0f * rough * loh * loh;
  float fd = (1.0f + (f90 - 1.0f) * pow5(1.0f - nol)) *
             (1.0f + (f90 - 1.0f) * pow5(1.0f - nov)) * HK_INV_PI;
  float one_minus = 1.0f - noh * noh;
  float a_ = noh * rough;
  float k = rough / (one_minus + a_ * a_);
  float d = k * k * HK_INV_PI;
  float a2 = rough * rough;
  float lam_v = nol * sqrtf((nov - a2 * nov) * nov + a2);
  float lam_l = nov * sqrtf((nol - a2 * nol) * nol + a2);
  float vis = 0.5f / fmaxf(lam_v + lam_l, 1e-7f);
  float dv = d * vis;
  float fr90 = clip01((s.f0.x + s.f0.y + s.f0.z) * 16.5f);
  float sch = pow5(1.0f - loh);
  float fr = s.f0.x + (fr90 - s.f0.x) * sch;
  float fg = s.f0.y + (fr90 - s.f0.y) * sch;
  float fb = s.f0.z + (fr90 - s.f0.z) * sch;
  float lit_r = (dv * fr + s.diff.x * fd) * rad.x * nol;
  float lit_g = (dv * fg + s.diff.y * fd) * rad.y * nol;
  float lit_b = (dv * fb + s.diff.z * fd) * rad.z * nol;
  f3 da = env_brdf_approx(s.diff, 1.0f, nov);
  f3 sa = env_brdf_approx(s.f0, rough, nov);
  float am_r = (da.x + sa.x) * amb.x;
  float am_g = (da.y + sa.y) * amb.y;
  float am_b = (da.z + sa.z) * amb.z;
  float one_m = 1.0f - rad_a;
  return mk3(lit_r * rad_a + am_r * one_m, lit_g * rad_a + am_g * one_m,
             lit_b * rad_a + am_b * one_m);
}

// ---- the one Moller-Trumbore routine of the port's ray loops
// (trace_pallas._mt8 and its division-free twin in _kernel_shadow, whose
// expressions ops/trace_pallas.py mt_terms writes out): trace.cu's kernels
// 5, 6 and 7, light_fused.cu (B, 4) and trace_bvh.cu (13) run them on
// staged edge rows (edge_terms), kernel A (prepass_fused.cu) on its staged
// per-frame terms.

// The determinant and the numerators of u, v and t of a triangle.
struct MT {
  float det, uu, vv, dist;
};

// The terms of an edge row of three float4s (v0 + instance, v1 - v0, v2 -
// v0): trace_pallas.mt_terms' expressions, with the edges read instead of
// subtracted (the same IEEE subtractions, done once).
__device__ __forceinline__ MT edge_terms(float4 a, float4 b, float4 c, f3 o,
                                         f3 d) {
  float ux = d.y * c.z - d.z * c.y;
  float uy = d.z * c.x - d.x * c.z;
  float uz = d.x * c.y - d.y * c.x;
  MT m;
  m.det = b.x * ux + b.y * uy + b.z * uz;
  float aox = o.x - a.x, aoy = o.y - a.y, aoz = o.z - a.z;
  m.uu = aox * ux + aoy * uy + aoz * uz;
  float vx = aoy * b.z - aoz * b.y;
  float vy = aoz * b.x - aox * b.z;
  float vz = aox * b.y - aoy * b.x;
  m.vv = d.x * vx + d.y * vy + d.z * vz;
  m.dist = c.x * vx + c.y * vy + c.z * vz;
  return m;
}

// The instance masks, on float ids: real triangles only (padding rows
// carry -1), not the excluded instance, and the included one when
// incl >= 0 (incl < 0, the probe's "no pick" -2 included, accepts all).
__device__ __forceinline__ bool mt_accepts(float inst, float excl,
                                           float incl) {
  return inst >= 0.0f && inst != excl && (incl < 0.0f || inst == incl);
}

struct Closest {
  float t, u, v;  // t = F32_MAX, u = v = 0 on a miss
  int prim;       // triangle index, -1 on a miss
  float inst;     // -1 on a miss
};

__device__ __forceinline__ Closest closest_miss() {
  Closest c;
  c.t = HK_F32_MAX;
  c.u = 0.0f;
  c.v = 0.0f;
  c.prim = -1;
  c.inst = -1.0f;
  return c;
}

// a0 + u * (a1 - a0) + v * (a2 - a0), the attribute interpolation of
// trace_pallas._kernel_full and trace.hit_info_onehot
__device__ __forceinline__ float interp(float a0, float a1, float a2, float u,
                                        float v) {
  return a0 + u * (a1 - a0) + v * (a2 - a0);
}

struct Hit {
  float t;
  f3 n;       // interpolated, not normalized
  float mat;  // -1 on a miss
  float inst; // -1 on a miss
};

struct Shadow {
  bool occluded;
  float t;    // nearest accepted hit distance, F32_MAX if none
  float inst; // -1 if none
};

// The running nearest occluder of a division-free loop: t = td / ads.
struct Occluder {
  float td, ads, inst;
};

__device__ __forceinline__ Occluder occluder_none() {
  Occluder b;
  b.td = HK_F32_MAX;
  b.ads = 1.0f;
  b.inst = -1.0f;
  return b;
}

// One division per ray, at the end.
__device__ __forceinline__ Shadow shadow_result(const Occluder& b) {
  Shadow sh;
  sh.occluded = b.inst >= 0.0f;
  sh.t = sh.occluded ? b.td / b.ads : HK_F32_MAX;
  sh.inst = b.inst;
  return sh;
}

// ---- the 64 B packed reservoir (ops/reservoir.py): 16 float planes of an
// [h,16,w] tensor, plane c of pixel (y, x) at ((y * 16 + c) * w + x).
// bf16 rounds to nearest even on the raw bits, unorm16/snorm8 with rintf
// (half to even, as torch.round), and every packed word is a u32 pattern.

struct Rsv {
  float vpx, vpy, vpz, vpd, spx, spy, spz, spw, vinst;
  float rad_r, rad_g, rad_b, rad_a, rnd0, rnd1, rnd2, rnd3;
  float vnx, vny, vnz, life, snx, sny, snz;
  float count, w, w_sum, w2_sum;
};

__device__ __forceinline__ uint32_t hk_rne16(float f) {
  uint32_t u = __float_as_uint(f);
  return (u + 0x7FFFu + ((u >> 16) & 1u)) >> 16;
}

__device__ __forceinline__ float bf16_pair(float a, float b) {
  return __uint_as_float(hk_rne16(a) | (hk_rne16(b) << 16));
}

__device__ __forceinline__ void bf16_unpair(float lane, float& a, float& b) {
  uint32_t u = __float_as_uint(lane);
  a = __uint_as_float((u & 0xFFFFu) << 16);
  b = __uint_as_float(u & 0xFFFF0000u);
}

__device__ __forceinline__ uint32_t hk_unorm16(float a) {
  return (uint32_t)(int)rintf(fminf(fmaxf(a, 0.0f), 1.0f) * 65535.0f);
}

__device__ __forceinline__ uint32_t hk_snorm8(float v) {
  return (uint32_t)(int)rintf((fminf(fmaxf(v, -1.0f), 1.0f) * 0.5f + 0.5f) *
                              255.0f);
}

__device__ __forceinline__ float snorm8_vec(float x, float y, float z,
                                            float extra) {
  return __uint_as_float(hk_snorm8(x) | (hk_snorm8(y) << 8) |
                         (hk_snorm8(z) << 16) | ((uint32_t)(int)extra << 24));
}

__device__ __forceinline__ float snorm8_dec(uint32_t u, int shift) {
  return (float)((u >> shift) & 0xFFu) / 255.0f * 2.0f - 1.0f;
}

__device__ __forceinline__ Rsv rsv_empty() {
  Rsv r;
  r.vpx = r.vpy = r.vpz = r.vpd = 0.0f;
  r.spx = r.spy = r.spz = r.spw = 0.0f;
  r.vinst = -1.0f;
  r.rad_r = r.rad_g = r.rad_b = r.rad_a = 0.0f;
  r.rnd0 = r.rnd1 = r.rnd2 = r.rnd3 = 0.0f;
  r.vnx = r.vny = r.vnz = r.life = 0.0f;
  r.snx = r.sny = r.snz = 0.0f;
  r.count = r.w = r.w_sum = r.w2_sum = 0.0f;
  return r;
}

// Unpack the reservoir whose plane 0 sits at t[base] (planes w apart).
__device__ __forceinline__ Rsv rsv_load(const float* t, long long base,
                                        int w) {
  Rsv r;
  r.vpx = t[base];
  r.vpy = t[base + w];
  r.vpz = t[base + 2LL * w];
  r.vpd = t[base + 3LL * w];
  r.spx = t[base + 4LL * w];
  r.spy = t[base + 5LL * w];
  r.spz = t[base + 6LL * w];
  r.vinst = t[base + 7LL * w];
  bf16_unpair(t[base + 8LL * w], r.rad_r, r.rad_g);
  bf16_unpair(t[base + 9LL * w], r.rad_b, r.rad_a);
  uint32_t u = __float_as_uint(t[base + 10LL * w]);
  r.rnd0 = (float)(u & 0xFFFFu) / 65535.0f;
  r.rnd1 = (float)(u >> 16) / 65535.0f;
  u = __float_as_uint(t[base + 11LL * w]);
  r.rnd2 = (float)(u & 0xFFFFu) / 65535.0f;
  r.rnd3 = (float)(u >> 16) / 65535.0f;
  u = __float_as_uint(t[base + 12LL * w]);
  r.vnx = snorm8_dec(u, 0);
  r.vny = snorm8_dec(u, 8);
  r.vnz = snorm8_dec(u, 16);
  r.life = (float)(u >> 24);
  u = __float_as_uint(t[base + 13LL * w]);
  r.snx = snorm8_dec(u, 0);
  r.sny = snorm8_dec(u, 8);
  r.snz = snorm8_dec(u, 16);
  r.spw = (float)(u >> 24) > 127.0f ? 1.0f : 0.0f;
  bf16_unpair(t[base + 14LL * w], r.count, r.w);
  bf16_unpair(t[base + 15LL * w], r.w_sum, r.w2_sum);
  return r;
}

__device__ __forceinline__ void rsv_store(float* t, long long base, int w,
                                          const Rsv& r) {
  t[base] = r.vpx;
  t[base + w] = r.vpy;
  t[base + 2LL * w] = r.vpz;
  t[base + 3LL * w] = r.vpd;
  t[base + 4LL * w] = r.spx;
  t[base + 5LL * w] = r.spy;
  t[base + 6LL * w] = r.spz;
  t[base + 7LL * w] = r.vinst;
  t[base + 8LL * w] = bf16_pair(r.rad_r, r.rad_g);
  t[base + 9LL * w] = bf16_pair(r.rad_b, r.rad_a);
  t[base + 10LL * w] =
      __uint_as_float(hk_unorm16(r.rnd0) | (hk_unorm16(r.rnd1) << 16));
  t[base + 11LL * w] =
      __uint_as_float(hk_unorm16(r.rnd2) | (hk_unorm16(r.rnd3) << 16));
  t[base + 12LL * w] =
      snorm8_vec(r.vnx, r.vny, r.vnz, fminf(fmaxf(r.life, 0.0f), 255.0f));
  t[base + 13LL * w] =
      snorm8_vec(r.snx, r.sny, r.snz, r.spw > 0.5f ? 255.0f : 0.0f);
  t[base + 14LL * w] = bf16_pair(r.count, r.w);
  t[base + 15LL * w] = bf16_pair(r.w_sum, r.w2_sum);
}

// The sample fields a WRS replace copies (everything but the statistics
// count, w, w_sum, w2_sum and the lifetime).
__device__ __forceinline__ void rsv_take_sample(Rsv& r, const Rsv& s) {
  r.vpx = s.vpx;
  r.vpy = s.vpy;
  r.vpz = s.vpz;
  r.vpd = s.vpd;
  r.spx = s.spx;
  r.spy = s.spy;
  r.spz = s.spz;
  r.spw = s.spw;
  r.vinst = s.vinst;
  r.rad_r = s.rad_r;
  r.rad_g = s.rad_g;
  r.rad_b = s.rad_b;
  r.rad_a = s.rad_a;
  r.rnd0 = s.rnd0;
  r.rnd1 = s.rnd1;
  r.rnd2 = s.rnd2;
  r.rnd3 = s.rnd3;
  r.vnx = s.vnx;
  r.vny = s.vny;
  r.vnz = s.vnz;
  r.snx = s.snx;
  r.sny = s.sny;
  r.snz = s.snz;
}

// History clamp (light.wgsl:944-951, 1645-1651)
__device__ __forceinline__ void rsv_clamp(Rsv& r, float m) {
  bool over = r.count > m;
  float scale = over ? m / fmaxf(r.count, 1e-30f) : 1.0f;
  r.w_sum = r.w_sum * scale;
  r.w2_sum = r.w2_sum * scale;
  r.count = fminf(r.count, m);
}

// Stored variance (light.wgsl:1224-1227), before the cap of 10
__device__ __forceinline__ float rsv_variance(const Rsv& r) {
  float cnt = fmaxf(r.count, 1e-30f);
  float mean = r.w_sum / cnt;
  float var = r.w2_sum / cnt - mean * mean;
  return r.count < 1.0f ? var : var / cnt;
}

// Copy `rows` rows of `cols` floats (source row stride `stride`, starting
// at column `col0`) into shared memory, all threads of the block helping.
__device__ __forceinline__ void stage_rows(float* dst, const float* src,
                                           int rows, int cols, int stride,
                                           int col0) {
  for (int k = threadIdx.x; k < rows * cols; k += blockDim.x) {
    int r = k / cols, c = k % cols;
    dst[k] = src[r * stride + col0 + c];
  }
}

#define HK_MAX_DEVICES 16

// Lets `kernel` take `smem` bytes of dynamic shared memory on the current
// device. The attribute is held per device, so `allowed[dev]` records what
// the kernel may take on device dev so far; it is set only above the
// 48 KB default and only when a launch needs more than that record.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, int smem, int* allowed) {
  if (smem <= 48 * 1024) return cudaSuccess;
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= HK_MAX_DEVICES) return cudaErrorInvalidDevice;
  if (smem <= allowed[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) allowed[dev] = smem;
  return err;
}
