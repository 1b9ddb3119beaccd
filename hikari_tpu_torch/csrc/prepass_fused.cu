// Kernel A: the fused G-buffer prepass, two pixels per thread; and kernel
// 8: the SMAA parity quads, de-interleaved from kernel A's planes.
//
// Kernel A replaces hikari_tpu/ops/prepass_fused.py:_build_kernel (the
// Pallas body, launched by _call_planes). Per pixel: the jittered camera
// ray, the nearest hit over every scene triangle with normal/uv/material
// interpolation, world position and NDC depth, instance and material ids
// (+0.5), velocity through the per-instance motion matrix, and the
// env-BRDF albedo of the no-texture surface.
//
// Bound of kernel A on the H100: operations. Each pixel runs ~60 flops per
// ray-triangle test against 68 bytes of output; at 1080p with the
// 36-triangle box that is ~4.5 GFLOP (67 us at 67 TFLOP/s f32) against
// ~141 MB (42 us at 3.35 TB/s). Built with --fmad=false, every multiply
// and add issues alone, so the kernel is bound by its instruction issue.
//
// Design, against that issue count:
// * Every ray of kernel A starts at the camera, so the terms of
//   trace_pallas.mt_terms that do not involve the direction are the same
//   for every pixel of the frame: the edges ab and ac, ao = cam - v0,
//   v = ao x ab and the distance numerator ac . v. Each block stages them
//   once per triangle (stage_tris: four float4 rows, one thread per
//   triangle, no division per element), by the same float operations on
//   the same operands as mt_terms, so every word is unchanged. The test
//   per pixel is left with u = d x ac, det = ab . u, uu = ao . u and
//   vv = d . v.
// * The reciprocal is skipped where the result is already decided
//   (tri_test); see the proof there.
// * Two pixels per thread (A_PIX), a block's two runs of 256
//   pixels: each staged row is read from shared memory once for both rays.
// * The attribute row is read from global memory for the winner only.
//
// Row sharding (parallel/shard.py): a rank's call writes the planes of
// its block of rows, h of them from image row params[P_ROW0] (0 for the
// whole image), its rays through those image rows of the image of
// params[P_WH] x params[P_WH + 1]; the words of a pixel do not depend on
// the block.
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
#define P_ROW0 55  // image row of the planes' first row (a row block)
#define P_COUNT 56

#define A_THREADS 256
#define A_PIX 2  // pixels per thread
#define TRI_ROWS 4  // float4s per staged triangle

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

// The per-frame terms of mt_terms for rays from o, one triangle per
// thread: rows (ab, instance), (ac, ac . v), (ao, 0), (v, 0) with
// ab = v1 - v0, ac = v2 - v0, ao = o - v0, v = ao x ab, each expression
// as mt_terms writes it.
__device__ __forceinline__ void stage_tris(float4* dst, const float* tris,
                                           int n, f3 o) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float* r = tris + HK_TRI * i;
    float abx = r[3] - r[0], aby = r[4] - r[1], abz = r[5] - r[2];
    float acx = r[6] - r[0], acy = r[7] - r[1], acz = r[8] - r[2];
    float aox = o.x - r[0], aoy = o.y - r[1], aoz = o.z - r[2];
    float vx = aoy * abz - aoz * aby;
    float vy = aoz * abx - aox * abz;
    float vz = aox * aby - aoy * abx;
    float4* q = dst + TRI_ROWS * i;
    q[0] = make_float4(abx, aby, abz, r[9]);
    q[1] = make_float4(acx, acy, acz, acx * vx + acy * vy + acz * vz);
    q[2] = make_float4(aox, aoy, aoz, 0.0f);
    q[3] = make_float4(vx, vy, vz, 0.0f);
  }
}

// trace_pallas.closest_accept for kernel A's rays (maxt = F32_MAX, every
// instance id >= 0 accepted, checked by the caller) on a staged triangle:
// the same terms and the same accept test, its conditions evaluated in
// another order, some of them before the division.
//
// The sign skip. The test accepts only |det| >= eps and
// dist = num * inv_det > eps, with inv_det = 1 / det. For finite det with
// |det| >= eps, 1 / det is finite, carries det's sign and is not zero
// (|1 / det| >= 1 / F32_MAX > 0, a denormal at the least, and the build
// does not flush denormals). So dist > eps > 0 needs num and det of one
// strict sign: where num is 0, -0 or NaN, or num and det have opposite
// signs, num * inv_det is a zero, negative or NaN and the test fails.
// det = +-inf gives inv_det = +-0 and dist a zero or NaN: rejected as
// well. So skipping every triangle whose num and det do not share a
// strict sign rejects only triangles the full test rejects.
__device__ __forceinline__ void tri_test(const float4* q, int i, f3 d,
                                         Closest& c) {
  float4 ab = q[0], ac = q[1];
  float ux = d.y * ac.z - d.z * ac.y;
  float uy = d.z * ac.x - d.x * ac.z;
  float uz = d.x * ac.y - d.y * ac.x;
  float det = ab.x * ux + ab.y * uy + ab.z * uz;
  float num = ac.w;
  bool same_sign = det > 0.0f ? num > 0.0f : (det < 0.0f && num < 0.0f);
  if (!(fabsf(det) >= HK_F32_EPS) || !same_sign) return;
  float inv_det = 1.0f / det;
  float dist = num * inv_det;
  if (!(dist > HK_F32_EPS && dist < HK_F32_MAX && dist < c.t)) return;
  float4 ao = q[2], v = q[3];
  float uu = ao.x * ux + ao.y * uy + ao.z * uz;
  float vv = d.x * v.x + d.y * v.y + d.z * v.z;
  float u = uu * inv_det;
  float vb = vv * inv_det;
  if (u >= 0.0f && u <= 1.0f && vb >= 0.0f && u + vb <= 1.0f) {
    c.t = dist;
    c.u = u;
    c.v = vb;
    c.prim = i;
    c.inst = ab.w;
  }
}

// Kernel A's outputs at pixel `pix` from its nearest hit.
__device__ __forceinline__ void pixel_tail(
    const float* params, const float* __restrict__ attr_g,
    const float* motion, int n_inst, const float* mats, int n_mats, int pix,
    f3 o, f3 d, const Closest& hit, float* __restrict__ position,
    float* __restrict__ normal, float* __restrict__ inst_mat,
    float* __restrict__ vel_uv, float* __restrict__ albedo) {
  float t_best = hit.t, inst_f = hit.inst;
  f3 n = mk3(0.0f, 0.0f, 0.0f);
  float uvx = 0.0f, uvy = 0.0f, mat_f = -1.0f;
  if (hit.prim >= 0) {
    // tri_attr rows are [normals 9, uv 6, instance, material]
    const float* q = attr_g + 17 * hit.prim;
    n = mk3(interp(__ldg(q), __ldg(q + 3), __ldg(q + 6), hit.u, hit.v),
            interp(__ldg(q + 1), __ldg(q + 4), __ldg(q + 7), hit.u, hit.v),
            interp(__ldg(q + 2), __ldg(q + 5), __ldg(q + 8), hit.u, hit.v));
    uvx = interp(__ldg(q + 9), __ldg(q + 11), __ldg(q + 13), hit.u, hit.v);
    uvy = interp(__ldg(q + 10), __ldg(q + 12), __ldg(q + 14), hit.u, hit.v);
    mat_f = __ldg(q + 16);
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

// Shared-memory bytes of a launch: the staged triangles (16-byte aligned,
// first), params, motion matrices and materials.
__host__ __device__ inline size_t prepass_smem(int n_tris, int n_inst,
                                               int n_mats) {
  return sizeof(float) * (4 * TRI_ROWS * n_tris + P_COUNT + 16 * n_inst +
                          HK_MAT * n_mats);
}

// Material rows of 15 floats (ops: mat_packed) to HK_MAT-float rows, one
// thread per row.
__device__ __forceinline__ void stage_mats(float* dst, const float* src,
                                           int n) {
  for (int r = threadIdx.x; r < n; r += blockDim.x)
    for (int c = 0; c < HK_MAT; c++) dst[HK_MAT * r + c] = src[15 * r + c];
}

__global__ void __launch_bounds__(A_THREADS)
prepass_kernel(const float* __restrict__ params_g,
               const float* __restrict__ tris_g,
               const float* __restrict__ attr_g, int n_tris,
               const float* __restrict__ motion_g, int n_inst,
               const float* __restrict__ mats_g, int n_mats, int h, int w,
               float* __restrict__ position, float* __restrict__ normal,
               float* __restrict__ inst_mat, float* __restrict__ vel_uv,
               float* __restrict__ albedo) {
  extern __shared__ float4 smem4[];
  float4* tris = smem4;
  float* params = reinterpret_cast<float*>(tris + TRI_ROWS * n_tris);
  float* motion = params + P_COUNT;
  float* mats = motion + 16 * n_inst;

  f3 cam = mk3(__ldg(params_g + P_CAM), __ldg(params_g + P_CAM + 1),
               __ldg(params_g + P_CAM + 2));
  stage_tris(tris, tris_g, n_tris, cam);
  for (int k = threadIdx.x; k < P_COUNT; k += blockDim.x)
    params[k] = params_g[k];
  for (int k = threadIdx.x; k < 16 * n_inst; k += blockDim.x)
    motion[k] = motion_g[k];
  stage_mats(mats, mats_g, n_mats);
  __syncthreads();

  int npix = h * w;
  int first = blockIdx.x * (A_THREADS * A_PIX) + threadIdx.x;
  f3 o, d[A_PIX];
  Closest c[A_PIX];
#pragma unroll
  for (int k = 0; k < A_PIX; k++) {
    int pix = min(first + k * A_THREADS, npix - 1);
    // the image row: the block's first row + the plane row (integers
    // below 2^24, so the sum is exact)
    o = camera_ray(params, (float)(pix % w),
                   params[P_ROW0] + (float)(pix / w), &d[k]);
    c[k] = closest_miss();
  }
  if (first >= npix) return;

  // --- nearest hit, every ray of the thread against each staged row
  for (int i = 0; i < n_tris; i++) {
    const float4* q = tris + TRI_ROWS * i;
    if (!(q[0].w >= 0.0f)) continue;  // padding rows (instance -1)
#pragma unroll
    for (int k = 0; k < A_PIX; k++) tri_test(q, i, d[k], c[k]);
  }

#pragma unroll
  for (int k = 0; k < A_PIX; k++) {
    int pix = first + k * A_THREADS;
    if (pix < npix)
      pixel_tail(params, attr_g, motion, n_inst, mats, n_mats, pix, o, d[k],
                 c[k], position, normal, inst_mat, vel_uv, albedo);
  }
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
  if (h <= 0 || w <= 0) return (int)cudaErrorInvalidValue;
  // the dynamic shared memory each device allows the kernel so far
  static int allowed[HK_MAX_DEVICES];
  int smem = (int)prepass_smem(n_tris, n_inst, n_mats);
  cudaError_t err = allow_smem(prepass_kernel, smem, allowed);
  if (err != cudaSuccess) return (int)err;
  int per_block = A_THREADS * A_PIX;
  int blocks = (h * w + per_block - 1) / per_block;
  prepass_kernel<<<blocks, A_THREADS, smem, (cudaStream_t)stream>>>(
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
