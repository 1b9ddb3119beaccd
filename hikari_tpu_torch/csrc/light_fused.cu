// Kernel B: the no-reuse lighting, one thread per pixel.
//
// Replaces hikari_tpu/ops/light_fused.py:_build_kernel with temporal=False
// (launched by fused_lighting). Per pixel, for the channels present:
// * direct (has_sun): solar-cone NEE candidate, shadow ray, Burley/GGX
//   shading, plus the surface emission;
// * emissive (n_em > 0): emissive-BVH leaf walk, alias-table triangle pick,
//   probe ray restricted to the picked emitter, area-to-solid-angle pdf,
//   shadow ray, shading;
// * indirect (bounces > 0): cosine-hemisphere bounce(s) with NEE at each
//   hit (emissive pick with solar fallback), radiance clamp, transport,
//   final shading at the visible point.
//
// Design: every table (scene triangles with normal+material, emissive
// triangles, materials, the emissive leaves and alias slots in the
// parameter vector) is staged once per block in dynamic shared memory.
// The TPU kernel's per-lane select-sweeps over those tables become indexed
// loads, and its unrolled emissive-leaf walk a loop over n_em. The
// G-buffer is read from the interleaved [h,w,C] tensors and each channel
// is written as rgb + valid alpha into its [h,w,4] render.
//
// Bound on the H100: operations. With 1 bounce the flagship runs five
// triangle sweeps per pixel (emissive probe and shadow, bounce, NEE probe
// and shadow) at ~60 flops per ray-triangle test: ~8e3 flops per pixel for
// the 36-triangle box against 68 bytes of G-buffer and noise in and 32
// bytes out, far above the card's ~20 flops per byte.

#include "common.cuh"

// params layout (ops/light_fused.py _P_*)
#define P_DIRL 0
#define P_DIRC 3
#define P_AMB 6
#define P_COS_SOLAR 9
#define P_CAM 10
#define P_MAX_IND 13
#define P_ADV 14
#define P_EM 16
#define EM_STRIDE 10
#define P_ALIAS 96
#define P_COUNT 224

struct Cand {
  f3 d;
  float p, maxd, em_inst, info_inst, info_mat;
  f3 sp;
};

struct Tables {
  const float* params;
  const float* tris;
  const float* attrs;
  int n_tris;
  const float* em_tris;
  const float* em_attrs;
  int n_em_tris;
  const float* mats;
  int n_mats;
  int n_em;
  int n_alias;
};

// select_light_candidate(sample_emissive=True): light.wgsl:624-696
__device__ Cand emissive_candidate(const Tables& tb, float r0, float r1,
                                   float r2, float r3, f3 p, f3 n,
                                   float excl) {
  const float* prm = tb.params;
  float cos_solar = prm[P_COS_SOLAR];
  float cz = 1.0f - (1.0f - cos_solar) * r2;
  float theta = HK_TAU * r3;
  float cr = sqrtf(fmaxf(1.0f - cz * cz, 0.0f));
  f3 rd0 = onb_apply(mk3(prm[P_DIRL], prm[P_DIRL + 1], prm[P_DIRL + 2]),
                     mk3(cr * cosf(theta), cr * sinf(theta), cz));
  Cand c;
  if (tb.n_em == 0) {
    c.d = rd0;
    c.p = 1.0f;
    c.maxd = HK_F32_MAX;
    c.em_inst = -1.0f;
    c.info_inst = -1.0f;
    c.info_mat = -1.0f;
    c.sp = ray_at(p, rd0, HK_DISTANCE_MAX);
    return c;
  }
  // emissive-BVH leaf walk in leaf order, reservoir pick of one leaf
  float picked = -1.0f, count = 0.0f, rand_w = r0;
  for (int e = 0; e < tb.n_em; e++) {
    const float* em = prm + P_EM + EM_STRIDE * e;
    float rad = em[3];
    bool inside = (p.x > em[0] - rad) && (p.x < em[0] + rad) &&
                  (p.y > em[1] - rad) && (p.y < em[1] + rad) &&
                  (p.z > em[2] - rad) && (p.z < em[2] + rad);
    bool take_leaf = inside && (em[4] != excl);
    float new_rand = fmodf(rand_w + HK_GOLDEN, 1.0f);
    if (take_leaf) {
      rand_w = new_rand;
      count = count + 1.0f;
    }
    bool take = take_leaf && (rand_w < 1.0f / fmaxf(count, 1.0f));
    if (take) picked = (float)e;
  }
  bool has_pick = picked >= 0.0f;
  const float* em = prm + P_EM + EM_STRIDE * row_of(picked, tb.n_em);
  float em_inst = em[4], a_off = em[5], a_cnt = em[6], area = em[7],
        tri_off = em[8];

  // alias-table triangle pick (light.wgsl:662-669)
  float ai = fminf(floorf(r0 * a_cnt), fmaxf(a_cnt - 1.0f, 0.0f));
  float slot = a_off + ai;
  float prob = 0.0f, alias_v = 0.0f;
  int si = (int)slot;
  if (si >= 0 && si < tb.n_alias && (float)si == slot) {
    prob = prm[P_ALIAS + 2 * si];
    alias_v = prm[P_ALIAS + 2 * si + 1];
  }
  float prim_local = r1 < prob ? alias_v : ai;
  float em_prim = tri_off + prim_local;
  float tv[9] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  int ti = (int)em_prim;
  if (ti >= 0 && ti < tb.n_em_tris && (float)ti == em_prim) {
    for (int k = 0; k < 9; k++) tv[k] = tb.em_tris[HK_TRI * ti + k];
  }
  float srx = sqrtf(r2);
  float b0 = 1.0f - srx;
  float b1 = r3 * srx;
  float b2 = 1.0f - b0 - b1;
  f3 t = mk3(b0 * tv[0] + b1 * tv[3] + b2 * tv[6],
             b0 * tv[1] + b1 * tv[4] + b2 * tv[7],
             b0 * tv[2] + b1 * tv[5] + b2 * tv[8]);
  f3 ro = mk3(p.x + n.x * HK_RAY_BIAS, p.y + n.y * HK_RAY_BIAS,
              p.z + n.z * HK_RAY_BIAS);
  f3 rd = rsqrt_n(sub3(t, p));

  // probe ray restricted to the picked emitter (light.wgsl:672-687)
  Hit ph = trace_full(tb.em_tris, tb.em_attrs, tb.n_em_tris, ro, rd,
                      HK_F32_MAX, -1.0f, has_pick ? em_inst : -2.0f);
  f3 pn = rsqrt_n(ph.n);
  bool probe_hit = ph.inst >= 0.0f;
  bool probe_ok = has_pick && (dot3(rd, n) > 0.0f) && probe_hit;
  float ptt = probe_hit ? ph.t : HK_DISTANCE_MAX;
  f3 hp = ray_at(ro, rd, ptt);
  float dx = hp.x - p.x, dy = hp.y - p.y, dz = hp.z - p.z;
  float d2 = dx * dx + dy * dy + dz * dz;
  float denom = fabsf(dot3(rd, pn) * area);
  float p_em = d2 / fmaxf(denom, 1e-20f) / fmaxf(count, 1.0f);

  c.d = probe_ok ? rd : rd0;
  c.p = probe_ok ? p_em : 1.0f;
  c.maxd = probe_ok ? ph.t : HK_F32_MAX;
  c.em_inst = probe_ok ? em_inst : -1.0f;
  c.info_inst = probe_ok ? ph.inst : -1.0f;
  c.info_mat = probe_ok ? ph.mat : -1.0f;
  c.sp = probe_ok ? hp : ray_at(ro, rd0, HK_DISTANCE_MAX);
  return c;
}

// direct_lit's no-reuse path: candidate -> shadow -> input radiance ->
// shading * w (restir.py:318-370)
__device__ f3 shade_channel(const Tables& tb, const Cand& c, bool directional,
                            f3 p, f3 n, f3 v, const Surface& surf, f3 amb,
                            bool valid) {
  const float* prm = tb.params;
  bool trace_ok = (dot3(c.d, n) > 0.0f) && (c.p > 0.0f);
  if (!directional) trace_ok = trace_ok && (c.em_inst >= 0.0f);
  f3 ro = mk3(p.x + n.x * HK_RAY_BIAS, p.y + n.y * HK_RAY_BIAS,
              p.z + n.z * HK_RAY_BIAS);
  Shadow sh = shadow_sweep(tb.tris, tb.n_tris, ro, c.d, c.maxd, c.em_inst);
  float info_inst = sh.occluded ? sh.inst : c.info_inst;
  float info_mat = sh.occluded ? -1.0f : c.info_mat;
  f3 sp = sh.occluded ? ray_at(ro, c.d, sh.t) : c.sp;
  bool miss = info_inst < 0.0f;
  f3 rad;
  float rad_a;
  if (directional) {
    float cosdl = dot3(c.d, mk3(prm[P_DIRL], prm[P_DIRL + 1], prm[P_DIRL + 2]));
    bool take_dir = miss && (cosdl >= prm[P_COS_SOLAR]);
    rad = take_dir ? mk3(prm[P_DIRC], prm[P_DIRC + 1], prm[P_DIRC + 2])
                   : mk3(0.0f, 0.0f, 0.0f);
    rad_a = 1.0f - ((miss && !take_dir) ? 1.0f : 0.0f);
  } else {
    Surface hs = surface_of(tb.mats, tb.n_mats, fmaxf(info_mat, 0.0f));
    bool take_em = !miss && (info_inst == c.em_inst);
    float s255 = 255.0f * hs.em_a;
    rad = take_em ? mk3(s255 * hs.em.x, s255 * hs.em.y, s255 * hs.em.z)
                  : mk3(0.0f, 0.0f, 0.0f);
    rad_a = 1.0f - (miss ? 1.0f : 0.0f);
  }
  if (!trace_ok) {
    rad = mk3(0.0f, 0.0f, 0.0f);
    rad_a = 0.0f;
  }
  float lum = lum3(rad.x, rad.y, rad.z);
  float w_new = c.p > 0.0f ? lum / fmaxf(c.p, 1e-30f) : 0.0f;
  float w_f = lum > 0.0f ? w_new / fmaxf(lum, 1e-30f) : 0.0f;
  float w2d = valid ? w_f : 0.0f;
  f3 l = rsqrt_n(sub3(sp, p));
  f3 o = shade(surf, amb, v, n, l, rad, rad_a);
  return mk3(o.x * w2d, o.y * w2d, o.z * w2d);
}

// indirect_lit_ambient's no-reuse path (light.wgsl:1264-1498)
__device__ f3 indirect_channel(const Tables& tb, int bounces, float r0,
                               float r1, float r2, float r3, f3 p, f3 n,
                               f3 v, const Surface& surf, f3 amb,
                               bool valid) {
  const float* prm = tb.params;
  f3 dirl = mk3(prm[P_DIRL], prm[P_DIRL + 1], prm[P_DIRL + 2]);
  f3 bn = rsqrt_n(n);
  f3 b_p = p, b_n = bn;
  float br0 = r0, br1 = r1, br2 = r2, br3 = r3;
  f3 transport = mk3(1.0f, 1.0f, 1.0f);
  float tot_r = 0.0f, tot_g = 0.0f, tot_b = 0.0f, tot_a = 0.0f;
  bool alive = true;
  f3 first_p = mk3(0.0f, 0.0f, 0.0f);
  float pdf0 = 0.0f;
  float adv = prm[P_ADV];
  float max_ind = prm[P_MAX_IND];

  for (int nb = 0; nb < bounces; nb++) {
    // cosine-hemisphere bounce
    float rr = sqrtf(br0);
    float th = HK_TAU * br1;
    float hx = rr * cosf(th);
    float hy = rr * sinf(th);
    float hz = sqrtf(fmaxf(1.0f - (hx * hx + hy * hy), 0.0f));
    float bpdf = HK_TWO_INV_TAU * hz;
    f3 rd = onb_apply(b_n, mk3(hx, hy, hz));
    f3 ro = mk3(b_p.x + b_n.x * HK_RAY_BIAS, b_p.y + b_n.y * HK_RAY_BIAS,
                b_p.z + b_n.z * HK_RAY_BIAS);
    Hit h = trace_full(tb.tris, tb.attrs, tb.n_tris, ro, rd, HK_F32_MAX,
                       -1.0f, -1.0f);
    bool hit_ok = h.inst >= 0.0f;
    f3 hn = rsqrt_n(h.n);
    float htt = hit_ok ? h.t : HK_DISTANCE_MAX;
    f3 hp = ray_at(ro, rd, htt);
    if (!hit_ok) hn = mk3(0.0f, 0.0f, 0.0f);
    if (nb == 0) {
      first_p = hp;
      pdf0 = bpdf;
    }
    Surface hs = surface_of(tb.mats, tb.n_mats, hit_ok ? h.mat : 0.0f);
    hs.rough = 1.0f;  // roughness := 1 at bounces

    Cand c = emissive_candidate(tb, br0, br1, br2, br3, hp, hn, h.inst);
    bool sample_directional = c.em_inst < 0.0f;
    f3 bv = rsqrt_n(sub3(b_p, hp));
    bool nee_ok = (dot3(c.d, hn) > 0.0f) && (c.p > 0.0f);
    f3 ro2 = mk3(hp.x + hn.x * HK_RAY_BIAS, hp.y + hn.y * HK_RAY_BIAS,
                 hp.z + hn.z * HK_RAY_BIAS);
    Shadow sh = shadow_sweep(tb.tris, tb.n_tris, ro2, c.d, c.maxd, c.em_inst);
    float ci_inst = sh.occluded ? sh.inst : c.info_inst;
    float ci_mat = sh.occluded ? -1.0f : c.info_mat;
    // input_radiance with sample_directional=True
    bool miss2 = ci_inst < 0.0f;
    float cosdl = dot3(c.d, dirl);
    bool take_dir = miss2 && (cosdl >= prm[P_COS_SOLAR]);
    Surface ns = surface_of(tb.mats, tb.n_mats, fmaxf(ci_mat, 0.0f));
    bool take_em = !miss2 && (ci_inst == c.em_inst);
    float s255 = 255.0f * ns.em_a;
    f3 ir = take_dir ? mk3(prm[P_DIRC], prm[P_DIRC + 1], prm[P_DIRC + 2])
                     : (take_em ? mk3(s255 * ns.em.x, s255 * ns.em.y,
                                      s255 * ns.em.z)
                                : mk3(0.0f, 0.0f, 0.0f));
    float ir_a = 1.0f - ((miss2 && !take_dir) ? 1.0f : 0.0f);
    // keep rgb only for directional picks or hits on the emitter
    bool keep = sample_directional || (ci_inst == c.em_inst);
    if (!keep) ir = mk3(0.0f, 0.0f, 0.0f);
    f3 o = shade(hs, amb, bv, hn, c.d, ir, ir_a);
    float inv_p = 1.0f / fmaxf(c.p, 1e-30f);
    o = mk3(o.x * inv_p, o.y * inv_p, o.z * inv_p);
    if (nb > 0) {
      bool kill = bpdf < 0.01f;
      float inv_b = 1.0f / fmaxf(bpdf, 1e-30f);
      o = kill ? mk3(0.0f, 0.0f, 0.0f)
               : mk3(o.x * inv_b, o.y * inv_b, o.z * inv_b);
    }
    float lum_b = lum3(o.x, o.y, o.z);
    float scale = lum_b > max_ind ? max_ind / fmaxf(lum_b, 1e-30f) : 1.0f;
    o = mk3(o.x * scale, o.y * scale, o.z * scale);
    if (alive && hit_ok && nee_ok) {
      tot_r = tot_r + transport.x * o.x;
      tot_g = tot_g + transport.y * o.y;
      tot_b = tot_b + transport.z * o.z;
      tot_a = tot_a + 1.0f;
    }
    if (alive && !hit_ok) {
      tot_r = tot_r + transport.x * amb.x;
      tot_g = tot_g + transport.y * amb.y;
      tot_b = tot_b + transport.z * amb.z;
    }
    // transport *= env_brdf(hit surface, bounce view, hit normal)
    float nov_t = fmaxf(dot3(hn, bv), 0.0001f);
    f3 da = env_brdf_approx(hs.diff, 1.0f, nov_t);
    f3 sa = env_brdf_approx(hs.f0, hs.rough, nov_t);
    if (alive && hit_ok)
      transport = mk3(transport.x * (da.x + sa.x),
                      transport.y * (da.y + sa.y),
                      transport.z * (da.z + sa.z));
    alive = alive && hit_ok &&
            (transport.x > 0.01f || transport.y > 0.01f ||
             transport.z > 0.01f);
    br0 = fmodf(br0 + adv, 1.0f);
    br1 = fmodf(br1 + adv, 1.0f);
    br2 = fmodf(br2 + adv, 1.0f);
    br3 = fmodf(br3 + adv, 1.0f);
    if (hit_ok) {
      b_p = hp;
      b_n = hn;
    }
  }
  tot_a = fminf(tot_a, 1.0f);
  f3 l = rsqrt_n(sub3(first_p, p));
  f3 s = shade(surf, amb, v, bn, l, mk3(tot_r, tot_g, tot_b), tot_a);
  float lum_s = lum3(s.x, s.y, s.z);
  float w_new = pdf0 > 0.0f ? lum_s / fmaxf(pdf0, 1e-30f) : 0.0f;
  float w2d = (valid && lum_s > 0.0f) ? w_new / fmaxf(lum_s, 1e-30f) : 0.0f;
  return mk3(s.x * w2d, s.y * w2d, s.z * w2d);
}

__global__ void __launch_bounds__(128)
light_kernel(const float* __restrict__ params_g,
             const float* __restrict__ tris_g, const float* __restrict__ attr_g,
             int n_tris, const float* __restrict__ em_tris_g,
             const float* __restrict__ em_attr_g, int n_em_tris,
             const float* __restrict__ mats_g, int n_mats,
             const float* __restrict__ position,
             const float* __restrict__ normal,
             const float* __restrict__ inst_mat,
             const float* __restrict__ rand, int h, int w, int n_em,
             int n_alias, int bounces, float* __restrict__ d_out,
             float* __restrict__ e_out, float* __restrict__ i_out) {
  extern __shared__ float smem[];
  float* params = smem;
  float* tris = params + P_COUNT;
  float* attrs = tris + HK_TRI * n_tris;
  float* em_tris = attrs + HK_TRI * n_tris;
  float* em_attrs = em_tris + HK_TRI * n_em_tris;
  float* mats = em_attrs + HK_TRI * n_em_tris;

  stage_rows(params, params_g, 1, P_COUNT, P_COUNT, 0);
  stage_rows(tris, tris_g, n_tris, HK_TRI, HK_TRI, 0);
  stage_rows(em_tris, em_tris_g, n_em_tris, HK_TRI, HK_TRI, 0);
  // attribute rows: the 9 vertex normals + the material (column 16)
  for (int k = threadIdx.x; k < n_tris * HK_TRI; k += blockDim.x) {
    int r = k / HK_TRI, c = k % HK_TRI;
    attrs[k] = attr_g[r * 17 + (c < 9 ? c : 16)];
  }
  for (int k = threadIdx.x; k < n_em_tris * HK_TRI; k += blockDim.x) {
    int r = k / HK_TRI, c = k % HK_TRI;
    em_attrs[k] = em_attr_g[r * 17 + (c < 9 ? c : 16)];
  }
  stage_rows(mats, mats_g, n_mats, HK_MAT, 15, 0);
  __syncthreads();

  int pix = blockIdx.x * blockDim.x + threadIdx.x;
  if (pix >= h * w) return;

  Tables tb;
  tb.params = params;
  tb.tris = tris;
  tb.attrs = attrs;
  tb.n_tris = n_tris;
  tb.em_tris = em_tris;
  tb.em_attrs = em_attrs;
  tb.n_em_tris = n_em_tris;
  tb.mats = mats;
  tb.n_mats = n_mats;
  tb.n_em = n_em;
  tb.n_alias = n_alias;

  float4 pos = reinterpret_cast<const float4*>(position)[pix];
  f3 p = mk3(pos.x, pos.y, pos.z);
  float depth = pos.w;
  f3 n = mk3(normal[3 * pix], normal[3 * pix + 1], normal[3 * pix + 2]);
  float2 im = reinterpret_cast<const float2*>(inst_mat)[pix];
  // ids as the TPU wrapper feeds them: truncated to int, material >= 0
  float inst_f = (float)(int)im.x;
  float mat_f = (float)max((int)im.y, 0);
  float4 rnd = reinterpret_cast<const float4*>(rand)[pix];

  bool valid = depth >= HK_F32_EPS;
  f3 amb = mk3(params[P_AMB], params[P_AMB + 1], params[P_AMB + 2]);
  Surface surf = surface_of(mats, n_mats, mat_f);
  f3 v = rsqrt_n(mk3(params[P_CAM] - p.x, params[P_CAM + 1] - p.y,
                     params[P_CAM + 2] - p.z));
  float alpha = valid ? 1.0f : 0.0f;

  if (d_out != nullptr) {
    // solar-only candidate (sampling.py:157)
    float cos_solar = params[P_COS_SOLAR];
    float cz = 1.0f - (1.0f - cos_solar) * rnd.z;
    float theta = HK_TAU * rnd.w;
    float cr = sqrtf(fmaxf(1.0f - cz * cz, 0.0f));
    Cand c;
    c.d = onb_apply(mk3(params[P_DIRL], params[P_DIRL + 1], params[P_DIRL + 2]),
                    mk3(cr * cosf(theta), cr * sinf(theta), cz));
    c.p = 1.0f;
    c.maxd = HK_F32_MAX;
    c.em_inst = -1.0f;
    c.info_inst = -1.0f;
    c.info_mat = -1.0f;
    c.sp = ray_at(p, c.d, HK_DISTANCE_MAX);
    f3 o = shade_channel(tb, c, true, p, n, v, surf, amb, valid);
    float em_add = 255.0f * surf.em_a;
    reinterpret_cast<float4*>(d_out)[pix] =
        make_float4(valid ? o.x + em_add * surf.em.x : 0.0f,
                    valid ? o.y + em_add * surf.em.y : 0.0f,
                    valid ? o.z + em_add * surf.em.z : 0.0f, alpha);
  }
  if (e_out != nullptr) {
    Cand c = emissive_candidate(tb, rnd.x, rnd.y, rnd.z, rnd.w, p, n, inst_f);
    f3 o = shade_channel(tb, c, false, p, n, v, surf, amb, valid);
    reinterpret_cast<float4*>(e_out)[pix] = make_float4(
        valid ? o.x : 0.0f, valid ? o.y : 0.0f, valid ? o.z : 0.0f, alpha);
  }
  if (i_out != nullptr) {
    f3 o = indirect_channel(tb, bounces, rnd.x, rnd.y, rnd.z, rnd.w, p, n, v,
                            surf, amb, valid);
    reinterpret_cast<float4*>(i_out)[pix] = make_float4(
        valid ? o.x : 0.0f, valid ? o.y : 0.0f, valid ? o.z : 0.0f, alpha);
  }
}

extern "C" int hk_light_fused(const float* params, const float* tris,
                              const float* tri_attr, int n_tris,
                              const float* em_tris, const float* em_attr,
                              int n_em_tris, const float* mats, int n_mats,
                              const float* position, const float* normal,
                              const float* inst_mat, const float* rand, int h,
                              int w, int n_em, int n_alias, int bounces,
                              float* d_out, float* e_out, float* i_out,
                              void* stream) {
  size_t smem = sizeof(float) * (P_COUNT + 2 * HK_TRI * n_tris +
                                 2 * HK_TRI * n_em_tris + HK_MAT * n_mats);
  cudaError_t err = cudaFuncSetAttribute(
      light_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int threads = 128;
  int blocks = (h * w + threads - 1) / threads;
  light_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      params, tris, tri_attr, n_tris, em_tris, em_attr, n_em_tris, mats,
      n_mats, position, normal, inst_mat, rand, h, w, n_em, n_alias, bounces,
      d_out, e_out, i_out);
  return (int)cudaGetLastError();
}
