// Kernel 10: the fused spatial ReSTIR pass of one channel, one thread per
// pixel.
//
// Replaces hikari_tpu/ops/spatial_fused.py:_build_kernel (launched by
// spatial_fused). Per pixel: the start reservoir by lifetime (previous
// spatial or this frame's temporal), the merge of the temporal reservoir,
// then per spiral tap the in-bounds gate, a screen-space depth ray-march,
// the depth-ratio / normal / forward gates, the clamped GRIS Jacobian and
// the WRS step; the winner-plane epilogue, the history clamp, shading at
// the visible point, finalize w, lifetime + 1, the variance (NaN where the
// frame keeps the temporal variance) and the 64 B repack.
//
// Design: the TPU kernel stages a row band of the temporal planes and depth
// with a +-range halo in VMEM and rolls lanes per tap; here each thread
// reads its taps' 16 planes and depths straight from global memory and L2
// serves the neighbours (a tap is the same offset for every pixel of the
// frame, so a warp reads one contiguous run per plane). The tap offsets and
// march offsets come from the host in the parameter vector (computed once
// per frame in float32), so the kernel and the plain version use the same
// integers. A tap that is out of bounds or lands on an invalid pixel leaves
// the reservoir unchanged, so it is skipped. The winning sample is carried
// as its 16 packed words and unpacked once after the loop.
//
// Bound on the H100: bytes for both channels (chip_smoke.py counts both
// sides). Each pixel reads and writes 232 B; even the indirect channel's
// 16 shaded taps, about 6.1e9 flops over a 1080p frame of the box, take
// under two thirds of the time those bytes take at the memory rate.

#include "common.cuh"

// params layout (ops/spatial_fused.py _S_*)
#define S_MAXLIFE 0
#define S_MAXCNT 1
#define S_AMB 2
#define S_CAM 5
#define S_TAPS 8
#define S_STEPS 5  // SPATIAL_TAPS + 1 march steps at most
#define TAP_STRIDE (3 + 3 * S_STEPS)
#define S_COUNT (S_TAPS + TAP_STRIDE * 16)

struct SpCtx {
  const float* params;
  Surface surf;
  f3 amb, v, s_vp, s_vn;
};

__device__ __forceinline__ float shade_lum(const SpCtx& cx, f3 ld,
                                           const Rsv& q) {
  f3 o = shade(cx.surf, cx.amb, cx.v, cx.s_vn, ld,
               mk3(q.rad_r, q.rad_g, q.rad_b), q.rad_a);
  return lum3(o.x, o.y, o.z);
}

struct Running {
  float w_sum, w2_sum, count;
  bool win_is_tap;
  float win[16];
};

// merge_reservoir (light.wgsl:175-179) on the running statistics; the
// sample is kept as the winner's packed words, read from planes at `base`
__device__ __forceinline__ void wrs_step(Running& st, const float* planes,
                                         long long base, int w, const Rsv& q,
                                         float mw, bool mask, bool is_tap) {
  float w_new = mw * q.w * q.count;
  float ws_n = st.w_sum + w_new;
  float rand = fmodf(q.rnd0 + q.rnd1 + q.rnd2 + q.rnd3, 1.0f);
  bool replace = mask && (rand < w_new / fmaxf(ws_n, 1e-30f));
  if (mask) {
    st.w_sum = ws_n;
    st.w2_sum = st.w2_sum + w_new * w_new;
    st.count = st.count + q.count;
  }
  if (replace) {
    for (int c = 0; c < 16; c++) st.win[c] = planes[base + (long long)c * w];
  }
  st.win_is_tap = is_tap ? (st.win_is_tap || replace)
                         : (st.win_is_tap && !replace);
}

__device__ __forceinline__ float depth_at(const float* position, int h, int w,
                                          int y, int x) {
  y = min(max(y, 0), h - 1);
  x = min(max(x, 0), w - 1);
  return position[4 * ((long long)y * w + x) + 3];
}

__global__ void __launch_bounds__(128)
spatial_kernel(const float* __restrict__ params_g,
               const float* __restrict__ mats_g, int n_mats,
               const float* __restrict__ temporal,
               const float* __restrict__ prev,
               const float* __restrict__ position,
               const float* __restrict__ mat_f, int h, int w, int n_taps,
               int emissive_lit, float* __restrict__ render,
               float* __restrict__ var_out, float* __restrict__ planes_out) {
  __shared__ float params[S_COUNT];
  __shared__ float mats[HK_MAT * 16];
  stage_rows(params, params_g, 1, S_COUNT, S_COUNT, 0);
  stage_rows(mats, mats_g, n_mats, HK_MAT, 15, 0);
  __syncthreads();

  long long pix = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (pix >= (long long)h * w) return;
  int y = (int)(pix / w), x = (int)(pix % w);
  long long base = (long long)y * 16 * w + x;

  float4 pos = reinterpret_cast<const float4*>(position)[pix];
  float depth = pos.w;
  bool valid = depth >= HK_F32_EPS;
  SpCtx cx;
  cx.params = params;
  cx.amb = mk3(params[S_AMB], params[S_AMB + 1], params[S_AMB + 2]);
  cx.v = rsqrt_n(mk3(params[S_CAM] - pos.x, params[S_CAM + 1] - pos.y,
                     params[S_CAM + 2] - pos.z));
  cx.surf = surface_of(mats, n_mats, mat_f[pix]);

  Rsv q0 = rsv_load(temporal, base, w);
  cx.s_vp = mk3(q0.vpx, q0.vpy, q0.vpz);
  cx.s_vn = mk3(q0.vnx, q0.vny, q0.vnz);
  bool keep = q0.life <= params[S_MAXLIFE];
  Running st;
  for (int c = 0; c < 16; c++)
    st.win[c] = keep ? prev[base + (long long)c * w]
                     : temporal[base + (long long)c * w];
  st.win_is_tap = false;
  float p_cnt, p_w, p_ws, p_w2;
  bf16_unpair(prev[base + 14LL * w], p_cnt, p_w);
  bf16_unpair(prev[base + 15LL * w], p_ws, p_w2);
  float p_life = (float)(__float_as_uint(prev[base + 12LL * w]) >> 24);
  st.w_sum = keep ? p_ws : q0.w_sum;
  st.w2_sum = keep ? p_w2 : q0.w2_sum;
  st.count = keep ? p_cnt : q0.count;
  float r_life = keep ? p_life : q0.life;

  float merge_w0;
  if (emissive_lit) {
    merge_w0 = lum3(q0.rad_r, q0.rad_g, q0.rad_b);
  } else {
    merge_w0 = shade_lum(
        cx, rsqrt_n(mk3(q0.spx - cx.s_vp.x, q0.spy - cx.s_vp.y,
                        q0.spz - cx.s_vp.z)),
        q0);
  }
  wrs_step(st, temporal, base, w, q0, merge_w0, valid, false);
  bool use_sp_var = q0.count <= 4.0f;

  for (int t = 0; t < n_taps && valid; t++) {
    const float* tp = params + S_TAPS + TAP_STRIDE * t;
    int oy = (int)tp[0], ox = (int)tp[1], n_march = (int)tp[2];
    int ty = y + oy, tx = x + ox;
    if (ty < 0 || ty >= h || tx < 0 || tx >= w) continue;
    long long tbase = (long long)ty * 16 * w + tx;
    Rsv q = rsv_load(temporal, tbase, w);
    float sdep = depth_at(position, h, w, ty, tx);
    // screen-space depth ray-march (light.wgsl:1608-1628)
    bool occluded = false;
    for (int j = 0; j < n_march; j++) {
      float ref_depth = depth + (sdep - depth) * tp[5 + 3 * j];
      occluded = occluded ||
                 depth_at(position, h, w, y + (int)tp[3 + 3 * j],
                          x + (int)tp[4 + 3 * j]) > ref_depth + 1e-5f;
    }
    float ratio = depth / (sdep == 0.0f ? 1e-30f : sdep);
    bool ok = (ratio >= 0.9f) && (ratio <= 1.1f);
    ok = ok && (q.count >= HK_F32_EPS);
    ok = ok && (dot3(cx.s_vn, mk3(q.vnx, q.vny, q.vnz)) >= 0.866f);
    f3 sd = rsqrt_n(mk3(q.spx - cx.s_vp.x, q.spy - cx.s_vp.y,
                        q.spz - cx.s_vp.z));
    ok = ok && (dot3(sd, cx.s_vn) >= 0.0f) && !occluded;
    // GRIS Jacobian (light.wgsl:985-1004)
    f3 sn = mk3(q.snx, q.sny, q.snz);
    f3 tr = rsqrt_n(mk3(cx.s_vp.x - q.spx, cx.s_vp.y - q.spy,
                        cx.s_vp.z - q.spz));
    f3 tq = rsqrt_n(mk3(q.vpx - q.spx, q.vpy - q.spy, q.vpz - q.spz));
    float cos1 = fabsf(dot3(tr, sn));
    float cos2 = fabsf(dot3(tq, sn));
    float term1 = cos1 / fmaxf(cos2, 1e-4f);
    float ax = q.vpx - q.spx, ay = q.vpy - q.spy, az = q.vpz - q.spz;
    float bx = cx.s_vp.x - q.spx, by = cx.s_vp.y - q.spy,
          bz = cx.s_vp.z - q.spz;
    float num = ax * ax + ay * ay + az * az;
    float den = bx * bx + by * by + bz * bz;
    float term2 = num / fmaxf(den, 1e-4f);
    float jac = fminf(fmaxf(term1 * term2, 1.0f), 50.0f);
    if (!(q.spw > 0.5f)) jac = 1.0f;
    float mw = emissive_lit ? lum3(q.rad_r, q.rad_g, q.rad_b) / jac
                            : shade_lum(cx, sd, q) / jac;
    wrs_step(st, temporal, tbase, w, q, mw, ok, true);
  }

  // winner epilogue: the visible point and normal stay the centre's
  // unless a tap's sample won
  Rsv r = rsv_load(st.win, 0, 1);
  r.w_sum = st.w_sum;
  r.w2_sum = st.w2_sum;
  r.count = st.count;
  r.life = r_life;
  if (!st.win_is_tap) {
    r.vpx = q0.vpx;
    r.vpy = q0.vpy;
    r.vpz = q0.vpz;
    r.vpd = q0.vpd;
    r.vnx = q0.vnx;
    r.vny = q0.vny;
    r.vnz = q0.vnz;
  }
  rsv_clamp(r, params[S_MAXCNT]);
  f3 ld = rsqrt_n(mk3(r.spx - cx.s_vp.x, r.spy - cx.s_vp.y,
                      r.spz - cx.s_vp.z));
  f3 o = shade(cx.surf, cx.amb, cx.v, cx.s_vn, ld,
               mk3(r.rad_r, r.rad_g, r.rad_b), r.rad_a);
  float target = emissive_lit ? lum3(r.rad_r, r.rad_g, r.rad_b)
                              : lum3(o.x, o.y, o.z);
  float tot = r.count * target;
  r.w = tot > 0.0f ? r.w_sum / fmaxf(tot, 1e-30f) : 0.0f;
  r.life = r.life + 1.0f;
  float var = fminf(rsv_variance(r), 10.0f);
  reinterpret_cast<float4*>(render)[pix] = make_float4(
      valid ? r.w * o.x : 0.0f, valid ? r.w * o.y : 0.0f,
      valid ? r.w * o.z : 0.0f, valid ? 1.0f : 0.0f);
  var_out[pix] = (valid && use_sp_var) ? var : __int_as_float(0x7fc00000);
  if (!valid) r = rsv_empty();
  rsv_store(planes_out, base, w, r);
}

extern "C" int hk_spatial_fused(const float* params, const float* mats,
                                int n_mats, const float* temporal,
                                const float* prev, const float* position,
                                const float* mat_f, int h, int w, int n_taps,
                                int emissive_lit, float* render,
                                float* variance, float* planes,
                                void* stream) {
  if (n_mats > 16 || n_taps > 16) return (int)cudaErrorInvalidValue;
  int threads = 128;
  long long blocks = ((long long)h * w + threads - 1) / threads;
  spatial_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      params, mats, n_mats, temporal, prev, position, mat_f, h, w, n_taps,
      emissive_lit, render, variance, planes);
  return (int)cudaGetLastError();
}
