// Kernel A: the fused G-buffer prepass, one thread per pixel; and kernel 8:
// the SMAA parity quads, de-interleaved from kernel A's planes.
//
// Kernel A replaces hikari_tpu/ops/prepass_fused.py:_build_kernel (the
// Pallas body, launched by _call_planes). Per pixel: the jittered camera
// ray, the nearest hit over every scene triangle with normal/uv/material
// interpolation, world position and NDC depth, instance and material ids
// (+0.5), velocity through the per-instance motion matrix, and the
// env-BRDF albedo of the no-texture surface.
//
// Design: the triangle table (<= 768 rows x 26 floats, ~80 KB), the motion
// matrices and the materials sit in dynamic shared memory; every thread of
// a warp reads the same triangle at once (a broadcast). Outputs are
// written straight into the interleaved G-buffer tensors (position [h,w,4],
// normal [h,w,3], ids [h,w,2], velocity+uv [h,w,4], albedo [h,w,4]), so a
// warp stores contiguous runs.
//
// Bound of kernel A on the H100: operations. Each pixel runs ~60 flops per
// ray-triangle test against 68 bytes of output; at 1080p with the
// 36-triangle box that is ~4.5 GFLOP (67 us at 67 TFLOP/s f32) against
// ~141 MB (42 us at 3.35 TB/s).
//
// Kernel 8 replaces prepass_fused.py:_build_kernel_slim (launched by
// prepass_fused_quads, once per parity there): depth, velocity and
// instance (+0.5) at the image pixels (2y+a, 2x+b) of the four parities
// (a, b). The TPU traced those pixels a second time because its lanes
// cannot read a stride-2 view of kernel A's planes. The same frame's
// kernel A has already written those words at those pixels with the same
// parameters, so here kernel 8 traces nothing: it moves kernel A's
// position .w, velocity_uv .xy and instance_material .x into the parity
// planes, as 32-bit words with no float arithmetic (NaN payloads and -0.0
// survive). One thread per image pixel: consecutive threads read
// consecutive pixels of a row and write to two planes (b = x & 1), so
// both reads and writes coalesce.
//
// Bound of kernel 8 on the H100: bytes. 16 B in (depth 4, velocity 8,
// instance 4) and 16 B out per image pixel, ~66 MB at 1080p: 20 us at
// 3.35 TB/s. The inputs are interleaved, so whole 32-byte sectors carry
// 40 B per pixel (all of position and velocity_uv, all of the ids): with
// them ~116 MB, 35 us.

#include "common.cuh"

// params layout (ops/prepass_fused.py _P_*)
#define P_INV_VP 0
#define P_VP 16
#define P_PREV_VP 32
#define P_CAM 48
#define P_JIT 51
#define P_WH 53
#define P_COUNT 55

#define A_STRIDE 16  // normals (9), uv (6), material

__device__ __forceinline__ f3 project3(const float* m, f3 p, float* w_out) {
  // rows 0..3 of a row-major 4x4 applied to (p, 1)
  float cx = m[0] * p.x + m[1] * p.y + m[2] * p.z + m[3];
  float cy = m[4] * p.x + m[5] * p.y + m[6] * p.z + m[7];
  float cz = m[8] * p.x + m[9] * p.y + m[10] * p.z + m[11];
  *w_out = m[12] * p.x + m[13] * p.y + m[14] * p.z + m[15];
  return mk3(cx, cy, cz);
}

// The jittered camera ray through image pixel (x, y)
// (ops/prepass.py camera_rays): unit direction into *d, origin returned.
__device__ __forceinline__ f3 camera_ray(const float* params, float x,
                                         float y, f3* d_out) {
  float w_img = params[P_WH], h_img = params[P_WH + 1];
  float u = (x + 0.5f + params[P_JIT]) / w_img;
  float v = (y + 0.5f + params[P_JIT + 1]) / h_img;
  float ndc_x = u * 2.0f - 1.0f;
  float ndc_y = (1.0f - v) * 2.0f - 1.0f;
  f3 a, b;
  {
    const float* m = params + P_INV_VP;
    float hw;
    hw = m[12] * ndc_x + m[13] * ndc_y + m[14] * 0.9f + m[15];
    float inv = 1.0f / hw;
    a = mk3((m[0] * ndc_x + m[1] * ndc_y + m[2] * 0.9f + m[3]) * inv,
            (m[4] * ndc_x + m[5] * ndc_y + m[6] * 0.9f + m[7]) * inv,
            (m[8] * ndc_x + m[9] * ndc_y + m[10] * 0.9f + m[11]) * inv);
    hw = m[12] * ndc_x + m[13] * ndc_y + m[14] * 0.1f + m[15];
    inv = 1.0f / hw;
    b = mk3((m[0] * ndc_x + m[1] * ndc_y + m[2] * 0.1f + m[3]) * inv,
            (m[4] * ndc_x + m[5] * ndc_y + m[6] * 0.1f + m[7]) * inv,
            (m[8] * ndc_x + m[9] * ndc_y + m[10] * 0.1f + m[11]) * inv);
  }
  f3 d = sub3(b, a);
  float inv_len = rsqrtf(fmaxf(d.x * d.x + d.y * d.y + d.z * d.z, 1e-30f));
  *d_out = mk3(d.x * inv_len, d.y * inv_len, d.z * inv_len);
  return mk3(params[P_CAM], params[P_CAM + 1], params[P_CAM + 2]);
}

struct SurfacePoint {
  bool mask;  // a triangle was hit
  f3 wp;      // world position (the far point on a miss)
  float depth, velu, velv;
};

// World position, NDC depth and velocity through the hit instance's motion
// matrix, from the nearest hit (t_best, inst_f) (kernel A's tail).
__device__ __forceinline__ SurfacePoint surface_point(const float* params,
                                                      const float* motion,
                                                      int n_inst, f3 o, f3 d,
                                                      float t_best,
                                                      float inst_f) {
  SurfacePoint s;
  s.mask = inst_f >= 0.0f;
  float tt = s.mask ? t_best : HK_DISTANCE_MAX;
  s.wp = ray_at(o, d, tt);
  f3 wp = s.wp;

  float cw;
  f3 c = project3(params + P_VP, wp, &cw);
  s.depth = s.mask ? c.z / cw : 0.0f;

  const float* mm = motion + 16 * row_of(fmaxf(inst_f, 0.0f), n_inst);
  float pw = mm[12] * wp.x + mm[13] * wp.y + mm[14] * wp.z + mm[15];
  float inv_pw = 1.0f / pw;
  f3 pwp = mk3((mm[0] * wp.x + mm[1] * wp.y + mm[2] * wp.z + mm[3]) * inv_pw,
               (mm[4] * wp.x + mm[5] * wp.y + mm[6] * wp.z + mm[7]) * inv_pw,
               (mm[8] * wp.x + mm[9] * wp.y + mm[10] * wp.z + mm[11]) *
                   inv_pw);
  float un = (c.x / cw + 1.0f) * 0.5f;
  float vn = 1.0f - (c.y / cw + 1.0f) * 0.5f;
  float pcw;
  f3 pc = project3(params + P_PREV_VP, pwp, &pcw);
  float up = (pc.x / pcw + 1.0f) * 0.5f;
  float vp = 1.0f - (pc.y / pcw + 1.0f) * 0.5f;
  s.velu = s.mask ? un - up : 0.0f;
  s.velv = s.mask ? vn - vp : 0.0f;
  return s;
}

__global__ void __launch_bounds__(256)
prepass_kernel(const float* __restrict__ params_g,
               const float* __restrict__ tris_g,
               const float* __restrict__ attr_g, int n_tris,
               const float* __restrict__ motion_g, int n_inst,
               const float* __restrict__ mats_g, int n_mats, int h, int w,
               float* __restrict__ position, float* __restrict__ normal,
               float* __restrict__ inst_mat, float* __restrict__ vel_uv,
               float* __restrict__ albedo) {
  extern __shared__ float smem[];
  float* params = smem;
  float* tris = params + P_COUNT + 1;
  float* attrs = tris + HK_TRI * n_tris;
  float* motion = attrs + A_STRIDE * n_tris;
  float* mats = motion + 16 * n_inst;

  stage_rows(params, params_g, 1, P_COUNT, P_COUNT, 0);
  stage_rows(tris, tris_g, n_tris, HK_TRI, HK_TRI, 0);
  // tri_attr rows are [normals 9, uv 6, instance, material]
  for (int k = threadIdx.x; k < n_tris * A_STRIDE; k += blockDim.x) {
    int r = k / A_STRIDE, c = k % A_STRIDE;
    attrs[k] = attr_g[r * 17 + (c < 15 ? c : 16)];
  }
  stage_rows(motion, motion_g, n_inst, 16, 16, 0);
  stage_rows(mats, mats_g, n_mats, HK_MAT, 15, 0);
  __syncthreads();

  int pix = blockIdx.x * blockDim.x + threadIdx.x;
  if (pix >= h * w) return;
  f3 d;
  f3 o = camera_ray(params, (float)(pix % w), (float)(pix / w), &d);

  // --- nearest hit with attribute interpolation from the winner's row
  Closest hit = closest_hit(tris, n_tris, o, d, HK_F32_MAX, -1.0f, -1.0f);
  float t_best = hit.t, inst_f = hit.inst;
  f3 n = mk3(0.0f, 0.0f, 0.0f);
  float uvx = 0.0f, uvy = 0.0f, mat_f = -1.0f;
  if (hit.prim >= 0) {
    const float* q = attrs + A_STRIDE * hit.prim;
    n = mk3(interp(q[0], q[3], q[6], hit.u, hit.v),
            interp(q[1], q[4], q[7], hit.u, hit.v),
            interp(q[2], q[5], q[8], hit.u, hit.v));
    uvx = interp(q[9], q[11], q[13], hit.u, hit.v);
    uvy = interp(q[10], q[12], q[14], hit.u, hit.v);
    mat_f = q[15];
  }
  SurfacePoint sp = surface_point(params, motion, n_inst, o, d, t_best,
                                  inst_f);
  bool mask = sp.mask;
  f3 wp = sp.wp;
  n = rsqrt_n(n);
  if (!mask) n = mk3(0.0f, 0.0f, 0.0f);

  // --- full-screen albedo (env_brdf of the no-texture surface)
  bool valid = sp.depth >= HK_F32_EPS;
  Surface s = surface_of(mats, n_mats, fmaxf(mat_f, 0.0f));
  f3 vdir = rsqrt_n(mk3(params[P_CAM] - wp.x, params[P_CAM + 1] - wp.y,
                        params[P_CAM + 2] - wp.z));
  float nov = fmaxf(dot3(n, vdir), 0.0001f);
  f3 da = env_brdf_approx(s.diff, 1.0f, nov);
  f3 sa = env_brdf_approx(s.f0, s.rough, nov);

  float4* pos4 = reinterpret_cast<float4*>(position);
  pos4[pix] = make_float4(mask ? wp.x : 0.0f, mask ? wp.y : 0.0f,
                          mask ? wp.z : 0.0f, sp.depth);
  normal[3 * pix] = n.x;
  normal[3 * pix + 1] = n.y;
  normal[3 * pix + 2] = n.z;
  reinterpret_cast<float2*>(inst_mat)[pix] =
      make_float2(inst_f + 0.5f, mat_f + 0.5f);
  reinterpret_cast<float4*>(vel_uv)[pix] =
      make_float4(sp.velu, sp.velv, mask ? uvx : 0.0f, mask ? uvy : 0.0f);
  reinterpret_cast<float4*>(albedo)[pix] =
      make_float4(valid ? da.x + sa.x : 0.0f, valid ? da.y + sa.y : 0.0f,
                  valid ? da.z + sa.z : 0.0f, valid ? 1.0f : 0.0f);
}

// Kernel 8: plane p = 2a + b of depth [4,h,w], velocity [4,h,w,2] and
// instance [4,h,w] holds image pixel (2y+a, 2x+b) of position [H,W,4] .w,
// velocity_uv [H,W,4] .xy and instance_material [H,W,2] .x at (y, x);
// h = H/2, w = W/2. Words are moved as unsigned integers.
__global__ void __launch_bounds__(256)
quads_kernel(const unsigned* __restrict__ position,
             const unsigned* __restrict__ vel_uv,
             const unsigned* __restrict__ inst_mat, int H, int W,
             unsigned* __restrict__ depth, uint2* __restrict__ velocity,
             unsigned* __restrict__ instance) {
  int X = blockIdx.x * blockDim.x + threadIdx.x;
  int Y = blockIdx.y;
  if (X >= W) return;
  long long pix = (long long)Y * W + X;
  long long h = H >> 1, w = W >> 1;
  long long o = ((((Y & 1) << 1) | (X & 1)) * h + (Y >> 1)) * w + (X >> 1);
  depth[o] = position[4 * pix + 3];
  velocity[o] = reinterpret_cast<const uint2*>(vel_uv)[2 * pix];
  instance[o] = inst_mat[2 * pix];
}

extern "C" int hk_prepass_fused(const float* params, const float* tris,
                                const float* tri_attr, int n_tris,
                                const float* motion, int n_inst,
                                const float* mats, int n_mats, int h, int w,
                                float* position, float* normal,
                                float* inst_mat, float* vel_uv, float* albedo,
                                void* stream) {
  size_t smem = sizeof(float) * (P_COUNT + 1 + HK_TRI * n_tris +
                                 A_STRIDE * n_tris + 16 * n_inst +
                                 HK_MAT * n_mats);
  cudaError_t err = cudaFuncSetAttribute(
      prepass_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int threads = 256;
  int blocks = (h * w + threads - 1) / threads;
  prepass_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      params, tris, tri_attr, n_tris, motion, n_inst, mats, n_mats, h, w,
      position, normal, inst_mat, vel_uv, albedo);
  return (int)cudaGetLastError();
}

// H, W: the image's size (even); the planes are [4, H/2, W/2]
extern "C" int hk_prepass_quads(const float* position, const float* vel_uv,
                                const float* inst_mat, int H, int W,
                                float* depth, float* velocity,
                                float* instance, void* stream) {
  if (H <= 0 || W <= 0 || (H | W) & 1) return (int)cudaErrorInvalidValue;
  int threads = 256;
  dim3 grid((W + threads - 1) / threads, H);
  quads_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const unsigned*)position, (const unsigned*)vel_uv,
      (const unsigned*)inst_mat, H, W, (unsigned*)depth, (uint2*)velocity,
      (unsigned*)instance);
  return (int)cudaGetLastError();
}
