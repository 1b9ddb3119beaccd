// Kernel 10: the fused spatial ReSTIR pass of one channel, one thread per
// pixel in tiles of 32x8.
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
// with a +-range halo in VMEM and rolls lanes per tap. Here a block is a
// tile of 32x8 pixels, with one template instance per channel (emissive:
// 8 taps within 10 pixels; indirect: 16 within 20):
// * the block stages the depth of its tile and a halo of the channel's
//   reach plus one (11 or 21 pixels) in shared memory, from the clamped
//   coordinates depth_at reads, so a tap's depth, its ratio gate and its
//   whole ray-march read shared memory (an offset beyond the halo, which
//   the host's spiral never makes, reads global memory);
// * the gates that read shared memory run before any load of the tap's
//   planes, for every tap at once (phase 1: bounds, depth ratio, march);
//   the taps left (candidates) then run in order (phase 2): each one's
//   13 words (count, normal, sample point and the rest) are copied by
//   cp.async into the thread's column of a two-slot stash in shared
//   memory while the one before it is evaluated, then come its count,
//   normal and forward gates and its WRS step. A rejected tap leaves the
//   reservoir unchanged (wrs_step with its mask false is a no-op), so
//   skipping it keeps every word, and the gates are pure, so taking them
//   ahead keeps the order of the WRS steps. Both channels are bound by
//   their L2 traffic and its latency (each candidate's 52 B, the depth
//   tile's sectors), so resident warps pay: the stash keeps the words in
//   flight out of registers. Measured alternatives, all slower: the gates
//   tap by tap (three dependent round trips to L2 each), the count,
//   normal and sample words of a batch of candidates first and the rest
//   after (re-reading four), the next candidate's words held in
//   registers (PERF.md);
// * the winner is carried as a code (the start reservoir's prev or
//   temporal plane set, or the index of the tap that won: both are
//   inputs) and its 16 words are read once, after the taps.
// The tap offsets and march offsets come from the host in the parameter
// vector (computed once per frame in float32), so the kernel and the plain
// version use the same integers. The material row is read from the
// G-buffer's instance_material .y as the plain version forms it.
//
// Bound on the H100: bytes for both channels (chip_smoke.py counts both
// sides). Each pixel reads and writes 232 B; even the indirect channel's
// 16 shaded taps, about 6.1e9 flops over a 1080p frame of the box, take
// under two thirds of the time those bytes take at the memory rate.

#include <cuda_pipeline.h>

#include "common.cuh"

// params layout (ops/spatial_fused.py _S_*)
#define S_MAXLIFE 0
#define S_MAXCNT 1
#define S_TAPS 2
#define S_STEPS 5  // SPATIAL_TAPS + 1 march steps at most
#define TAP_STRIDE (3 + 3 * S_STEPS)
#define S_AMB (S_TAPS + TAP_STRIDE * 16)
#define S_CAM (S_AMB + 3)
#define S_COUNT (S_CAM + 3)

#define SP_TX 32
// tile rows; the stash takes 104 B a thread, so with the depth tile 8 rows
// at most fit the 48 KB of static shared memory
#define SP_TY 8
// least resident blocks per SM: 4 caps the instances at 64 registers (32
// warps per SM); both then spill a little and run faster than at their
// 80 and 72 registers without spills (PERF.md)
#define SP_MIN_BLOCKS 4

struct SpCtx {
  Surface surf;
  f3 amb, v, s_vp, s_vn;
};

__device__ __forceinline__ float shade_lum(const SpCtx& cx, f3 ld,
                                           const Rsv& q) {
  f3 o = shade(cx.surf, cx.amb, cx.v, cx.s_vn, ld,
               mk3(q.rad_r, q.rad_g, q.rad_b), q.rad_a);
  return lum3(o.x, o.y, o.z);
}

// The running statistics and the winner: WIN_PREV or WIN_TEMPORAL, the
// start reservoir's plane set at the pixel, or the index of the tap whose
// temporal reservoir won (its words are read once, after the taps).
#define WIN_PREV (-2)
#define WIN_TEMPORAL (-1)

struct Running {
  float w_sum, w2_sum, count;
  int win;
};

// merge_reservoir (light.wgsl:175-179) on the running statistics; `who`
// is the candidate's winner code. The reference's win_is_tap flag is
// win >= 0: the centre's merge comes first and only taps follow.
__device__ __forceinline__ void wrs_step(Running& st, int who, const Rsv& q,
                                         float mw, bool mask) {
  float w_new = mw * q.w * q.count;
  float ws_n = st.w_sum + w_new;
  // fmodf(s, 1): every rnd is +0 or a positive quotient, so s is +0 or
  // positive and finite, and s - truncf(s) is its exact fractional part
  float s = q.rnd0 + q.rnd1 + q.rnd2 + q.rnd3;
  float rand = s - truncf(s);
  bool replace = mask && (rand < w_new / fmaxf(ws_n, 1e-30f));
  if (mask) {
    st.w_sum = ws_n;
    st.w2_sum = st.w2_sum + w_new * w_new;
    st.count = st.count + q.count;
  }
  if (replace) st.win = who;
}

__device__ __forceinline__ float depth_at(const float* position, int h, int w,
                                          int y, int x) {
  y = min(max(y, 0), h - 1);
  x = min(max(x, 0), w - 1);
  return position[4 * ((long long)y * w + x) + 3];
}

// The depth at pixel (y + dy, x + dx), clamped into the image: from the
// block's tile where the offset lies within its halo, else from global
// memory. `fits` is the same for every thread (the offsets are the
// frame's), so the branch does not diverge.
template <int HALO>
struct DepthTile {
  const float* tile;  // this thread's pixel at tile[0]
  const float* position;
  int h, w, y, x;
  __device__ __forceinline__ float at(int dy, int dx, bool fits) const {
    return fits ? tile[dy * (SP_TX + 2 * HALO) + dx]
                : depth_at(position, h, w, y + dy, x + dx);
  }
};

__device__ __forceinline__ bool within(int o, int halo) {
  return o >= -halo && o <= halo;
}

// x / c for an integer-valued x in [0, c], c = 65535 or 255, as the IEEE
// division rounds it: the product with the rounded reciprocal, corrected
// once by its fmaf residual. A test (tests/test_torch_spatial_launch.py)
// checks every x of both divisors: all are the division's words, while the
// product alone misses 512 and 126 of them.
__device__ __forceinline__ float div_exact(float x, float c, float rc) {
  float q = x * rc;
  return fmaf(fmaf(-q, c, x), rc, q);
}

// the float32 reciprocals 1 / 65535 and 1 / 255, rounded to nearest
#define RCP_65535 0x1.0001p-16f
#define RCP_255 0x1.010102p-8f

__device__ __forceinline__ float unorm16_dec(uint32_t u, int shift) {
  return div_exact((float)((u >> shift) & 0xFFFFu), 65535.0f, RCP_65535);
}

// snorm8_dec (common.cuh) with div_exact
__device__ __forceinline__ float snorm8_exact(uint32_t u, int shift) {
  return div_exact((float)((u >> shift) & 0xFFu), 255.0f, RCP_255) *
             2.0f -
         1.0f;
}

// Plane 0 of tap t's pixel, an offset of the frame's spiral from (y, x).
__device__ __forceinline__ long long tap_base(const float* params, int t,
                                              int y, int x, int w) {
  const float* tp = params + S_TAPS + TAP_STRIDE * t;
  return (long long)(y + (int)tp[0]) * 16 * w + x + (int)tp[1];
}

// rsqrt_n (common.cuh) of a tap's sample point minus the visible point,
// the direction to the sample, with that vector's squared length.
struct SampleDir {
  f3 d;
  float len2;
};

__device__ __forceinline__ SampleDir sample_dir(f3 sp, f3 vp) {
  f3 v = mk3(sp.x - vp.x, sp.y - vp.y, sp.z - vp.z);
  SampleDir r;
  r.len2 = v.x * v.x + v.y * v.y + v.z * v.z;
  float inv = rsqrtf(fmaxf(r.len2, 1e-20f));
  r.d = mk3(v.x * inv, v.y * inv, v.z * inv);
  return r;
}

// The count, normal and forward gates (light.wgsl:1566-1606) on a tap's
// words 12 (normal) and 14 (count) and its sample direction.
__device__ __forceinline__ bool tap_gates(const SpCtx& cx, float w12,
                                          float w14, f3 sd) {
  float q_cnt, q_w;
  bf16_unpair(w14, q_cnt, q_w);
  if (!(q_cnt >= HK_F32_EPS)) return false;
  uint32_t u = __float_as_uint(w12);
  f3 vn = mk3(snorm8_exact(u, 0), snorm8_exact(u, 8), snorm8_exact(u, 16));
  if (!(dot3(cx.s_vn, vn) >= 0.866f)) return false;
  return dot3(sd, cx.s_vn) >= 0.0f;
}

// The packed words of a candidate tap that its gates, Jacobian, shading
// and wrs_step read: planes 0-2, 4-6 and 8-14.
#define TAP_WORDS 13

struct TapWords {
  float v[TAP_WORDS];
};

// A candidate's words, by cp.async, into this thread's column of a slot
// of the block's stash.
__device__ __forceinline__ void stash_tap(float (*dst)[SP_TX * SP_TY],
                                          int tid, const float* t, int w) {
  const int planes[TAP_WORDS] = {0, 1, 2, 4, 5, 6, 8, 9, 10, 11, 12, 13, 14};
#pragma unroll
  for (int i = 0; i < TAP_WORDS; i++)
    __pipeline_memcpy_async(&dst[i][tid], t + (long long)planes[i] * w, 4);
  __pipeline_commit();
}

// rsv_load's decode of those words.
__device__ __forceinline__ Rsv tap_decode(const TapWords& k) {
  Rsv r = rsv_empty();
  r.vpx = k.v[0];
  r.vpy = k.v[1];
  r.vpz = k.v[2];
  r.spx = k.v[3];
  r.spy = k.v[4];
  r.spz = k.v[5];
  bf16_unpair(k.v[6], r.rad_r, r.rad_g);
  bf16_unpair(k.v[7], r.rad_b, r.rad_a);
  uint32_t u = __float_as_uint(k.v[8]);
  r.rnd0 = unorm16_dec(u, 0);
  r.rnd1 = unorm16_dec(u, 16);
  u = __float_as_uint(k.v[9]);
  r.rnd2 = unorm16_dec(u, 0);
  r.rnd3 = unorm16_dec(u, 16);
  u = __float_as_uint(k.v[11]);
  r.snx = snorm8_exact(u, 0);
  r.sny = snorm8_exact(u, 8);
  r.snz = snorm8_exact(u, 16);
  r.spw = (float)(u >> 24) > 127.0f ? 1.0f : 0.0f;
  bf16_unpair(k.v[12], r.count, r.w);
  return r;
}

// One accepted tap: its GRIS Jacobian (light.wgsl:985-1004), its weight
// and the WRS step. The Jacobian's direction from the sample point to the
// visible point, tr = rsqrt_n(vp - sp), is -sd word for word (a - b is
// -(b - a), +0 where both are 0, and the squares, so the reciprocal
// length, are the same), so |tr . sn| = |sd . sn| (a negated sum, up to
// the sign of a zero); and |vp - sp|^2 is sd's len2. Both are taken from
// sd (tests/test_torch_spatial_launch.py checks them against the
// expressions they replace).
template <bool EMISSIVE>
__device__ __forceinline__ void tap_step(Running& st, const SpCtx& cx,
                                         const TapWords& cur, SampleDir sd,
                                         int t) {
  Rsv q = tap_decode(cur);
  f3 sn = mk3(q.snx, q.sny, q.snz);
  f3 tq = rsqrt_n(mk3(q.vpx - q.spx, q.vpy - q.spy, q.vpz - q.spz));
  float cos1 = fabsf(dot3(sd.d, sn));
  float cos2 = fabsf(dot3(tq, sn));
  float term1 = cos1 / fmaxf(cos2, 1e-4f);
  float ax = q.vpx - q.spx, ay = q.vpy - q.spy, az = q.vpz - q.spz;
  float num = ax * ax + ay * ay + az * az;
  float term2 = num / fmaxf(sd.len2, 1e-4f);
  float jac = fminf(fmaxf(term1 * term2, 1.0f), 50.0f);
  if (!(q.spw > 0.5f)) jac = 1.0f;
  float mw = EMISSIVE ? lum3(q.rad_r, q.rad_g, q.rad_b) / jac
                      : shade_lum(cx, sd.d, q) / jac;
  wrs_step(st, t, q, mw, true);
}

// EMISSIVE: the channel (8 taps within 10 pixels, else 16 within 20);
// HALO: its reach plus one.
template <bool EMISSIVE, int HALO>
__global__ void __launch_bounds__(SP_TX * SP_TY, SP_MIN_BLOCKS)
spatial_kernel(const float* __restrict__ params_g,
               const float* __restrict__ mats_g, int n_mats,
               const float* __restrict__ temporal,
               const float* __restrict__ prev,
               const float* __restrict__ position,
               const float* __restrict__ inst_mat, int h, int w,
               float* __restrict__ render, float* __restrict__ var_out,
               float* __restrict__ planes_out) {
  constexpr int N_TAPS = EMISSIVE ? 8 : 16;
  constexpr int TW = SP_TX + 2 * HALO, TH = SP_TY + 2 * HALO;
  __shared__ float params[S_COUNT];
  __shared__ float mats[HK_MAT * 16];
  __shared__ float dtile[TH * TW];
  // two slots of the candidates' words, a column per thread (cp.async)
  __shared__ float stash[2][TAP_WORDS][SP_TX * SP_TY];
  int tid = threadIdx.y * SP_TX + threadIdx.x;
  for (int k = tid; k < S_COUNT; k += SP_TX * SP_TY) params[k] = params_g[k];
  for (int r = tid; r < n_mats; r += SP_TX * SP_TY)
    for (int c = 0; c < HK_MAT; c++) mats[HK_MAT * r + c] = mats_g[15 * r + c];
  int x0 = blockIdx.x * SP_TX, y0 = blockIdx.y * SP_TY;
  for (int ly = threadIdx.y; ly < TH; ly += SP_TY) {
    int gy = min(max(y0 - HALO + ly, 0), h - 1);
    const float* row = position + 4LL * gy * w + 3;
    for (int lx = threadIdx.x; lx < TW; lx += SP_TX)
      dtile[ly * TW + lx] = row[4 * min(max(x0 - HALO + lx, 0), w - 1)];
  }
  __syncthreads();

  int x = x0 + threadIdx.x, y = y0 + threadIdx.y;
  if (x >= w || y >= h) return;
  long long pix = (long long)y * w + x;
  long long base = (long long)y * 16 * w + x;
  DepthTile<HALO> dt;
  dt.tile = dtile + (threadIdx.y + HALO) * TW + threadIdx.x + HALO;
  dt.position = position;
  dt.h = h;
  dt.w = w;
  dt.y = y;
  dt.x = x;

  float4 pos = reinterpret_cast<const float4*>(position)[pix];
  float depth = pos.w;
  bool valid = depth >= HK_F32_EPS;
  SpCtx cx;
  cx.amb = mk3(params[S_AMB], params[S_AMB + 1], params[S_AMB + 2]);
  cx.v = rsqrt_n(mk3(params[S_CAM] - pos.x, params[S_CAM + 1] - pos.y,
                     params[S_CAM + 2] - pos.z));
  // the material id as the plain version forms it: clamp(int(id), 0)
  cx.surf = surface_of(mats, n_mats, material_id(inst_mat[2 * pix + 1]));

  Rsv q0 = rsv_load(temporal, base, w);
  cx.s_vp = mk3(q0.vpx, q0.vpy, q0.vpz);
  cx.s_vn = mk3(q0.vnx, q0.vny, q0.vnz);
  bool keep = q0.life <= params[S_MAXLIFE];
  Running st;
  st.win = keep ? WIN_PREV : WIN_TEMPORAL;
  float p_cnt, p_w, p_ws, p_w2;
  bf16_unpair(prev[base + 14LL * w], p_cnt, p_w);
  bf16_unpair(prev[base + 15LL * w], p_ws, p_w2);
  float p_life = (float)(__float_as_uint(prev[base + 12LL * w]) >> 24);
  st.w_sum = keep ? p_ws : q0.w_sum;
  st.w2_sum = keep ? p_w2 : q0.w2_sum;
  st.count = keep ? p_cnt : q0.count;
  float r_life = keep ? p_life : q0.life;

  float merge_w0;
  if (EMISSIVE) {
    merge_w0 = lum3(q0.rad_r, q0.rad_g, q0.rad_b);
  } else {
    merge_w0 = shade_lum(
        cx, rsqrt_n(mk3(q0.spx - cx.s_vp.x, q0.spy - cx.s_vp.y,
                        q0.spz - cx.s_vp.z)),
        q0);
  }
  wrs_step(st, WIN_TEMPORAL, q0, merge_w0, valid);
  bool use_sp_var = q0.count <= 4.0f;

  // phase 1, shared memory only: the bounds, depth-ratio and march gates
  // (light.wgsl:1608-1628) of every tap
  uint32_t cand = 0;
  for (int t = 0; t < N_TAPS && valid; t++) {
    const float* tp = params + S_TAPS + TAP_STRIDE * t;
    int oy = (int)tp[0], ox = (int)tp[1], n_march = (int)tp[2];
    int ty = y + oy, tx = x + ox;
    if (ty < 0 || ty >= h || tx < 0 || tx >= w) continue;
    float sdep = dt.at(oy, ox, within(oy, HALO) && within(ox, HALO));
    float ratio = depth / (sdep == 0.0f ? 1e-30f : sdep);
    if (!((ratio >= 0.9f) && (ratio <= 1.1f))) continue;
    bool occluded = false;
    for (int j = 0; j < n_march && !occluded; j++) {
      float ref_depth = depth + (sdep - depth) * tp[5 + 3 * j];
      int my = (int)tp[3 + 3 * j], mx = (int)tp[4 + 3 * j];
      occluded = dt.at(my, mx, within(my, HALO) && within(mx, HALO)) >
                 ref_depth + 1e-5f;
    }
    if (!occluded) cand |= 1u << t;
  }

  // phase 2: the candidates in order, each one's 13 words loaded while the
  // one before it is evaluated: the count, normal and forward gates, then
  // the tap
  int t = cand ? __ffs(cand) - 1 : -1;
  cand &= cand - 1;
  int slot = 0;
  if (t >= 0)
    stash_tap(stash[0], tid, temporal + tap_base(params, t, y, x, w), w);
  while (t >= 0) {
    int tn = cand ? __ffs(cand) - 1 : -1;
    cand &= cand - 1;
    if (tn >= 0) {
      stash_tap(stash[slot ^ 1], tid,
                temporal + tap_base(params, tn, y, x, w), w);
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    TapWords cur;
#pragma unroll
    for (int i = 0; i < TAP_WORDS; i++)
      cur.v[i] = stash[slot][i][tid];
    SampleDir sd = sample_dir(mk3(cur.v[3], cur.v[4], cur.v[5]), cx.s_vp);
    if (tap_gates(cx, cur.v[10], cur.v[12], sd.d))
      tap_step<EMISSIVE>(st, cx, cur, sd, t);
    t = tn;
    slot ^= 1;
  }

  // winner epilogue: the visible point and normal stay the centre's
  // unless a tap's sample won
  Rsv r = rsv_load(st.win == WIN_PREV ? prev : temporal,
                   st.win >= 0 ? tap_base(params, st.win, y, x, w) : base, w);
  r.w_sum = st.w_sum;
  r.w2_sum = st.w2_sum;
  r.count = st.count;
  r.life = r_life;
  if (st.win < 0) {
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
  float target = EMISSIVE ? lum3(r.rad_r, r.rad_g, r.rad_b)
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

// n_taps must be the channel's (8 emissive, 16 indirect).
extern "C" int hk_spatial_fused(const float* params, const float* mats,
                                int n_mats, const float* temporal,
                                const float* prev, const float* position,
                                const float* inst_mat, int h, int w,
                                int n_taps, int emissive_lit, float* render,
                                float* variance, float* planes,
                                void* stream) {
  if (n_mats > 16 || h <= 0 || w <= 0 ||
      n_taps != (emissive_lit ? 8 : 16))
    return (int)cudaErrorInvalidValue;
  dim3 block(SP_TX, SP_TY);
  dim3 grid((w + SP_TX - 1) / SP_TX, (h + SP_TY - 1) / SP_TY);
  cudaStream_t s = (cudaStream_t)stream;
  if (emissive_lit)
    spatial_kernel<true, 11><<<grid, block, 0, s>>>(
        params, mats, n_mats, temporal, prev, position, inst_mat, h, w,
        render, variance, planes);
  else
    spatial_kernel<false, 21><<<grid, block, 0, s>>>(
        params, mats, n_mats, temporal, prev, position, inst_mat, h, w,
        render, variance, planes);
  return (int)cudaGetLastError();
}
