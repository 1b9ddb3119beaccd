// Kernels B and 4: the lighting of every channel, one thread per pixel.
//
// Replaces hikari_tpu/ops/light_fused.py:_build_kernel (launched by
// fused_lighting), with temporal=False (kernel B) and temporal=True
// (kernel 4). Per pixel, for the channels present:
// * direct (has_sun): solar-cone NEE candidate, shadow ray, Burley/GGX
//   shading, plus the surface emission;
// * emissive (n_em > 0): emissive-BVH leaf walk, alias-table triangle pick,
//   probe ray restricted to the picked emitter, area-to-solid-angle pdf,
//   shadow ray, shading;
// * indirect (bounces > 0): cosine-hemisphere bounce(s) with NEE at each
//   hit (emissive pick with solar fallback), radiance clamp, transport,
//   final shading at the visible point.
// With TEMPORAL each channel merges its reprojected previous reservoir
// (light.wgsl:917-952): the reprojection gates, the WRS update and history
// clamp, on validation frames (VALIDATION) the retrace of the remembered
// sample (light.wgsl:1156-1213, direct and emissive only), the finalize and
// the 64 B repack, plus the variance. TRACK_DE / TRACK_IND add the flags
// (1 = gate miss, +2 = validation miss) and, for direct and emissive, the
// reservoir the validation scatter writes into the spatial buffer.
//
// Design: every table (scene triangles with normal+material, emissive
// triangles, materials, the emissive leaves and alias slots in the
// parameter vector) is staged once per block in dynamic shared memory.
// The TPU kernel's per-lane select-sweeps over those tables become indexed
// loads, and its unrolled emissive-leaf walk a loop over n_em. The
// G-buffer is read from the interleaved [h,w,C] tensors, the reservoirs
// from and to the [h,16,w] channel planes (threads of a warp on
// neighbouring x of one plane). The variants are template instances picked
// on the host from Python integers, never from a device value.
//
// Bound on the H100: operations. With 1 bounce the no-reuse flagship runs
// five triangle sweeps per pixel (emissive probe and shadow, bounce, NEE
// probe and shadow) at ~60 flops per ray-triangle test: ~8e3 flops per
// pixel for the 36-triangle box against 68 bytes of G-buffer and noise in
// and 32 bytes out, far above the card's ~20 flops per byte. The temporal
// variant adds 64 B in and out per channel (and 64 B more per tracked
// channel) and, on validation frames, one probe and one shadow sweep per
// direct/emissive channel: still bound by operations. Two live reservoirs
// of ~28 floats each exceed the register budget, so the temporal
// instances spill (the build log prints ptxas's counts).

#include "common.cuh"

// params layout (ops/light_fused.py _P_*)
#define P_DIRL 0
#define P_DIRC 3
#define P_AMB 6
#define P_COS_SOLAR 9
#define P_CAM 10
#define P_MAX_IND 13
#define P_ADV 14
#define P_MAXCNT 15
#define P_EM 16
#define EM_STRIDE 10
#define P_ALIAS 96
#define P_VAL 224
#define P_COUNT 228

struct Cand {
  f3 d;
  float p, maxd, em_inst, info_inst, info_mat;
  f3 sp;
  float spw;  // 1 when the sample point lies on a surface
  f3 sn;      // the sample point's normal
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

// Per-channel tensors of one launch, channel order d, e, i; null where a
// channel or the variant has none.
struct LightIO {
  float* render[3];       // [h,w,4]
  float* var[3];          // [h,w]
  float* packed[3];       // [h,16,w]
  float* flags[3];        // [h,w]
  float* scatter[3];      // [h,16,w] (d, e)
  const float* prev[3];   // [h,16,w] gathered previous reservoirs
};

// The visible point of one pixel, shared by the channels.
struct Px {
  f3 p, n, nn, v, amb;
  float depth, inst_f, r0, r1, r2, r3;
  Surface surf;
  bool valid;
};

// sample_uniform_cone around dir_to_light (sampling.py:157): p = 1, no
// emitter, the sample point DISTANCE_MAX along the direction from `pos`
__device__ Cand solar_candidate(const float* prm, float r2, float r3, f3 pos) {
  float cz = 1.0f - (1.0f - prm[P_COS_SOLAR]) * r2;
  float theta = HK_TAU * r3;
  float cr = sqrtf(fmaxf(1.0f - cz * cz, 0.0f));
  Cand c;
  c.d = onb_apply(mk3(prm[P_DIRL], prm[P_DIRL + 1], prm[P_DIRL + 2]),
                  mk3(cr * cosf(theta), cr * sinf(theta), cz));
  c.p = 1.0f;
  c.maxd = HK_F32_MAX;
  c.em_inst = -1.0f;
  c.info_inst = -1.0f;
  c.info_mat = -1.0f;
  c.sp = ray_at(pos, c.d, HK_DISTANCE_MAX);
  c.spw = 0.0f;
  c.sn = mk3(0.0f, 0.0f, 0.0f);
  return c;
}

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
    c.spw = 0.0f;
    c.sn = mk3(0.0f, 0.0f, 0.0f);
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
  c.spw = probe_ok ? 1.0f : 0.0f;
  c.sn = probe_ok ? pn : mk3(0.0f, 0.0f, 0.0f);
  return c;
}

// input_radiance (sample_ambient=False): the sun through the solar cone,
// or the emission of the emitter the ray was aimed at
__device__ void input_radiance(const Tables& tb, bool directional, f3 d,
                               float info_inst, float info_mat,
                               float em_inst, f3& rad, float& rad_a) {
  const float* prm = tb.params;
  bool miss = info_inst < 0.0f;
  if (directional) {
    float cosdl = dot3(d, mk3(prm[P_DIRL], prm[P_DIRL + 1], prm[P_DIRL + 2]));
    bool take_dir = miss && (cosdl >= prm[P_COS_SOLAR]);
    rad = take_dir ? mk3(prm[P_DIRC], prm[P_DIRC + 1], prm[P_DIRC + 2])
                   : mk3(0.0f, 0.0f, 0.0f);
    rad_a = 1.0f - ((miss && !take_dir) ? 1.0f : 0.0f);
  } else {
    Surface hs = surface_of(tb.mats, tb.n_mats, fmaxf(info_mat, 0.0f));
    bool take_em = !miss && (info_inst == em_inst);
    float s255 = 255.0f * hs.em_a;
    rad = take_em ? mk3(s255 * hs.em.x, s255 * hs.em.y, s255 * hs.em.z)
                  : mk3(0.0f, 0.0f, 0.0f);
    rad_a = 1.0f - (miss ? 1.0f : 0.0f);
  }
}

struct Traced {
  f3 rad;
  float rad_a, lum, w_new;
  f3 sp;
  float spw;
  f3 sn;
};

// candidate -> shadow -> input radiance, occluders overriding the probe
__device__ Traced trace_candidate(const Tables& tb, const Cand& c,
                                  bool directional, f3 p, f3 n) {
  bool trace_ok = (dot3(c.d, n) > 0.0f) && (c.p > 0.0f);
  if (!directional) trace_ok = trace_ok && (c.em_inst >= 0.0f);
  f3 ro = mk3(p.x + n.x * HK_RAY_BIAS, p.y + n.y * HK_RAY_BIAS,
              p.z + n.z * HK_RAY_BIAS);
  Shadow sh = shadow_sweep(tb.tris, tb.n_tris, ro, c.d, c.maxd, c.em_inst,
                           -1.0f);
  float info_inst = sh.occluded ? sh.inst : c.info_inst;
  float info_mat = sh.occluded ? -1.0f : c.info_mat;
  Traced t;
  t.sp = sh.occluded ? ray_at(ro, c.d, sh.t) : c.sp;
  t.spw = sh.occluded ? 1.0f : c.spw;
  t.sn = sh.occluded ? mk3(0.0f, 0.0f, 0.0f) : c.sn;
  input_radiance(tb, directional, c.d, info_inst, info_mat, c.em_inst, t.rad,
                 t.rad_a);
  if (!trace_ok) {
    t.rad = mk3(0.0f, 0.0f, 0.0f);
    t.rad_a = 0.0f;
  }
  t.lum = lum3(t.rad.x, t.rad.y, t.rad.z);
  t.w_new = c.p > 0.0f ? t.lum / fmaxf(c.p, 1e-30f) : 0.0f;
  return t;
}

// direct_lit's no-reuse path: candidate -> shadow -> input radiance ->
// shading * w (restir.py:318-370)
__device__ f3 shade_channel(const Tables& tb, const Cand& c, bool directional,
                            const Px& px) {
  Traced t = trace_candidate(tb, c, directional, px.p, px.n);
  float w_f = t.lum > 0.0f ? t.w_new / fmaxf(t.lum, 1e-30f) : 0.0f;
  float w2d = px.valid ? w_f : 0.0f;
  f3 l = rsqrt_n(sub3(t.sp, px.p));
  f3 o = shade(px.surf, px.amb, px.v, px.n, l, t.rad, t.rad_a);
  return mk3(o.x * w2d, o.y * w2d, o.z * w2d);
}

struct Ind {
  float tot_r, tot_g, tot_b, tot_a;
  f3 first_p, first_n, bn;
  bool first_hit;
  float pdf0;
};

// indirect_lit_ambient's bounces (light.wgsl:1264-1498): the gathered
// radiance and the first bounce's hit, before shading at the visible point
__device__ Ind indirect_bounces(const Tables& tb, int bounces, const Px& px) {
  const float* prm = tb.params;
  f3 dirl = mk3(prm[P_DIRL], prm[P_DIRL + 1], prm[P_DIRL + 2]);
  f3 amb = px.amb;
  Ind ind;
  ind.bn = px.nn;
  f3 b_p = px.p, b_n = px.nn;
  float br0 = px.r0, br1 = px.r1, br2 = px.r2, br3 = px.r3;
  f3 transport = mk3(1.0f, 1.0f, 1.0f);
  float tot_r = 0.0f, tot_g = 0.0f, tot_b = 0.0f, tot_a = 0.0f;
  bool alive = true;
  ind.first_p = mk3(0.0f, 0.0f, 0.0f);
  ind.first_n = mk3(0.0f, 0.0f, 0.0f);
  ind.first_hit = false;
  ind.pdf0 = 0.0f;
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
      ind.first_p = hp;
      ind.first_n = hn;
      ind.first_hit = hit_ok;
      ind.pdf0 = bpdf;
    }
    Surface hs = surface_of(tb.mats, tb.n_mats, hit_ok ? h.mat : 0.0f);
    hs.rough = 1.0f;  // roughness := 1 at bounces

    Cand c = emissive_candidate(tb, br0, br1, br2, br3, hp, hn, h.inst);
    bool sample_directional = c.em_inst < 0.0f;
    f3 bv = rsqrt_n(sub3(b_p, hp));
    bool nee_ok = (dot3(c.d, hn) > 0.0f) && (c.p > 0.0f);
    f3 ro2 = mk3(hp.x + hn.x * HK_RAY_BIAS, hp.y + hn.y * HK_RAY_BIAS,
                 hp.z + hn.z * HK_RAY_BIAS);
    Shadow sh = shadow_sweep(tb.tris, tb.n_tris, ro2, c.d, c.maxd, c.em_inst,
                             -1.0f);
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
  ind.tot_r = tot_r;
  ind.tot_g = tot_g;
  ind.tot_b = tot_b;
  ind.tot_a = fminf(tot_a, 1.0f);
  return ind;
}

// shading of the gathered radiance at the visible point; returns its
// resampling weight
__device__ float indirect_sample(const Px& px, const Ind& ind, f3& s,
                                 float& lum_s) {
  f3 l = rsqrt_n(sub3(ind.first_p, px.p));
  s = shade(px.surf, px.amb, px.v, ind.bn, l,
            mk3(ind.tot_r, ind.tot_g, ind.tot_b), ind.tot_a);
  lum_s = lum3(s.x, s.y, s.z);
  return ind.pdf0 > 0.0f ? lum_s / fmaxf(ind.pdf0, 1e-30f) : 0.0f;
}

// ---- temporal reuse --------------------------------------------------

// check_previous_reservoir (light.wgsl:917-935): zeroes the reservoir on
// a depth, instance or normal miss; returns the miss
__device__ bool gates(Rsv& r, const Px& px) {
  float ratio = r.vpd / (px.depth == 0.0f ? 1e-30f : px.depth);
  ratio = ratio < 1.0f ? 1.0f / (ratio == 0.0f ? 1e-30f : ratio) : ratio;
  bool depth_miss = ratio > 1.05f * (1.0f + 0.5f * px.r0);
  bool inst_miss = r.vinst != px.inst_f;
  bool normal_miss =
      px.nn.x * r.vnx + px.nn.y * r.vny + px.nn.z * r.vnz < 0.9f;
  bool miss = depth_miss || inst_miss || normal_miss;
  if (miss) r = rsv_empty();
  return miss;
}

// WRS update (reservoir.update_reservoir, light.wgsl:146-173)
__device__ void rsv_update(Rsv& r, const Rsv& s, float w_new, bool mask) {
  float w_sum = r.w_sum + w_new;
  float w2_sum = r.w2_sum + w_new * w_new;
  float count = r.count + 1.0f;
  float rand = fmodf(s.rnd0 + s.rnd1 + s.rnd2 + s.rnd3, 1.0f);
  bool replace = mask && (rand < w_new / fmaxf(w_sum, 1e-30f));
  if (mask) {
    r.w_sum = w_sum;
    r.w2_sum = w2_sum;
    r.count = count;
  }
  if (replace) rsv_take_sample(r, s);
}

// this frame's sample as reservoir fields
__device__ Rsv sample_of(f3 rad, float rad_a, const Px& px, f3 vn, f3 sp,
                         float spw, f3 sn) {
  Rsv s = rsv_empty();
  s.rad_r = rad.x;
  s.rad_g = rad.y;
  s.rad_b = rad.z;
  s.rad_a = rad_a;
  s.rnd0 = px.r0;
  s.rnd1 = px.r1;
  s.rnd2 = px.r2;
  s.rnd3 = px.r3;
  s.vpx = px.p.x;
  s.vpy = px.p.y;
  s.vpz = px.p.z;
  s.vpd = px.depth;
  s.vnx = vn.x;
  s.vny = vn.y;
  s.vnz = vn.z;
  s.vinst = px.inst_f;
  s.spx = sp.x;
  s.spy = sp.y;
  s.spz = sp.z;
  s.spw = spw;
  s.snx = sn.x;
  s.sny = sn.y;
  s.snz = sn.z;
  return s;
}

// visible point := this frame's, life + 1, the capped variance, and the
// empty reservoir on invalid pixels; returns the variance
__device__ float finish(Rsv& r, const Px& px, f3 vn) {
  r.vpx = px.p.x;
  r.vpy = px.p.y;
  r.vpz = px.p.z;
  r.vpd = px.depth;
  r.vnx = vn.x;
  r.vny = vn.y;
  r.vnz = vn.z;
  r.life = r.life + 1.0f;
  float var = px.valid ? fminf(rsv_variance(r), 10.0f) : 0.0f;
  if (!px.valid) r = rsv_empty();
  return var;
}

__device__ Cand channel_candidate(const Tables& tb, bool directional,
                                  float r0, float r1, float r2, float r3,
                                  f3 pos, f3 nrm, float excl) {
  if (directional) return solar_candidate(tb.params, r2, r3, pos);
  return emissive_candidate(tb, r0, r1, r2, r3, pos, nrm, excl);
}

// the temporal path of direct_lit (light.wgsl:1045-1261) for the direct
// or emissive channel; returns the shaded rgb * w
template <bool VALIDATION, bool TRACK>
__device__ f3 reuse_channel(const Tables& tb, bool directional, const Px& px,
                            const float* prev, float is_val, long long base,
                            long long pix, int w, float* var_out,
                            float* packed_out, float* flags_out,
                            float* scatter_out) {
  Rsv r = rsv_load(prev, base, w);
  bool gate_miss = gates(r, px);
  Cand c = channel_candidate(tb, directional, px.r0, px.r1, px.r2, px.r3,
                             px.p, px.n, px.inst_f);
  Traced t = trace_candidate(tb, c, directional, px.p, px.n);
  Rsv s2 = sample_of(t.rad, t.rad_a, px, px.n, t.sp, t.spw, t.sn);
  bool gate = px.valid && ((is_val < 0.5f) || (r.count < 4.0f));
  Rsv cur = r;
  rsv_update(cur, s2, t.w_new, gate);
  rsv_clamp(cur, tb.params[P_MAXCNT]);
  if (TRACK) rsv_store(scatter_out, base, w, cur);
  bool val_miss = false;
  if (VALIDATION && is_val > 0.5f) {
    // retrace of the remembered sample: candidate re-select at the stored
    // point, shadow ray from this frame's point towards the stored sample
    Cand cv = channel_candidate(tb, directional, r.rnd0, r.rnd1, r.rnd2,
                                r.rnd3, mk3(r.vpx, r.vpy, r.vpz),
                                mk3(r.vnx, r.vny, r.vnz), px.inst_f);
    f3 rv = rsqrt_n(mk3(r.spx - px.p.x, r.spy - px.p.y, r.spz - px.p.z));
    bool trace_ok =
        (dot3(cv.d, mk3(r.vnx, r.vny, r.vnz)) > 0.0f) && (cv.p > 0.0f);
    if (!directional) trace_ok = trace_ok && (cv.em_inst >= 0.0f);
    f3 ro = mk3(px.p.x + px.n.x * HK_RAY_BIAS, px.p.y + px.n.y * HK_RAY_BIAS,
                px.p.z + px.n.z * HK_RAY_BIAS);
    Shadow sh = shadow_sweep(tb.tris, tb.n_tris, ro, rv, cv.maxd, cv.em_inst,
                             -1.0f);
    float vi_inst = sh.occluded ? sh.inst : cv.info_inst;
    float vi_mat = sh.occluded ? -1.0f : cv.info_mat;
    f3 vsp = sh.occluded ? ray_at(ro, rv, sh.t) : cv.sp;
    float vspw = sh.occluded ? 1.0f : cv.spw;
    f3 vsn = sh.occluded ? mk3(0.0f, 0.0f, 0.0f) : cv.sn;
    f3 vrad;
    float vrad_a;
    input_radiance(tb, directional, rv, vi_inst, vi_mat, cv.em_inst, vrad,
                   vrad_a);
    if (!trace_ok) {
      vrad = mk3(0.0f, 0.0f, 0.0f);
      vrad_a = 0.0f;
    }
    Rsv s2v = s2;
    if (r.count >= 4.0f) {
      s2v.rnd0 = r.rnd0;
      s2v.rnd1 = r.rnd1;
      s2v.rnd2 = r.rnd2;
      s2v.rnd3 = r.rnd3;
      s2v.spx = vsp.x;
      s2v.spy = vsp.y;
      s2v.spz = vsp.z;
      s2v.spw = vspw;
      s2v.snx = vsn.x;
      s2v.sny = vsn.y;
      s2v.snz = vsn.z;
      s2v.rad_r = vrad.x;
      s2v.rad_g = vrad.y;
      s2v.rad_b = vrad.z;
      s2v.rad_a = vrad_a;
    }
    float lum_ratio = lum3(vrad.x, vrad.y, vrad.z) /
                      fmaxf(lum3(r.rad_r, r.rad_g, r.rad_b), 1e-4f);
    bool take_v = ((lum_ratio > 1.25f) || (lum_ratio < 0.8f)) && px.valid;
    float w_new_v =
        cv.p > 0.0f
            ? lum3(s2v.rad_r, s2v.rad_g, s2v.rad_b) / fmaxf(cv.p, 1e-30f)
            : 0.0f;
    if (take_v) {
      cur = s2v;
      cur.count = 1.0f;
      cur.life = 0.0f;
      cur.w = 0.0f;
      cur.w_sum = w_new_v;
      cur.w2_sum = w_new_v * w_new_v;
    }
    val_miss = take_v;
  }
  if (TRACK)
    flags_out[pix] = ((gate_miss && px.valid) ? 1.0f : 0.0f) +
                     2.0f * (val_miss ? 1.0f : 0.0f);
  // finalize (light.wgsl:1216-1259)
  float tot = cur.count * lum3(cur.rad_r, cur.rad_g, cur.rad_b);
  cur.w = tot > 0.0f ? cur.w_sum / fmaxf(tot, 1e-30f) : 0.0f;
  var_out[pix] = finish(cur, px, px.n);
  rsv_store(packed_out, base, w, cur);
  f3 ld = rsqrt_n(mk3(cur.spx - cur.vpx, cur.spy - cur.vpy, cur.spz - cur.vpz));
  f3 o = shade(px.surf, px.amb, px.v, px.n, ld,
               mk3(cur.rad_r, cur.rad_g, cur.rad_b), cur.rad_a);
  return mk3(o.x * cur.w, o.y * cur.w, o.z * cur.w);
}

// the temporal path of indirect_lit_ambient (light.wgsl:1452-1497): the
// reservoir keeps the raw bounce radiance and shades the merged sample
template <bool TRACK>
__device__ f3 indirect_reuse(const Tables& tb, const Px& px, const Ind& ind,
                             const float* prev, long long base, long long pix,
                             int w, float* var_out, float* packed_out,
                             float* flags_out) {
  f3 s;
  float lum_s;
  float w_new = indirect_sample(px, ind, s, lum_s);
  Rsv r = rsv_load(prev, base, w);
  bool gate_miss = gates(r, px);
  Rsv smp = sample_of(mk3(ind.tot_r, ind.tot_g, ind.tot_b), ind.tot_a, px,
                      ind.bn, ind.first_p, ind.first_hit ? 1.0f : 0.0f,
                      ind.first_n);
  rsv_update(r, smp, w_new, px.valid);
  rsv_clamp(r, tb.params[P_MAXCNT]);
  f3 ld = rsqrt_n(mk3(r.spx - r.vpx, r.spy - r.vpy, r.spz - r.vpz));
  f3 o = shade(px.surf, px.amb, px.v, mk3(r.vnx, r.vny, r.vnz), ld,
               mk3(r.rad_r, r.rad_g, r.rad_b), r.rad_a);
  float tot2 = r.count * lum3(o.x, o.y, o.z);
  r.w = tot2 > 0.0f ? r.w_sum / fmaxf(tot2, 1e-30f) : 0.0f;
  var_out[pix] = finish(r, px, ind.bn);
  rsv_store(packed_out, base, w, r);
  if (TRACK) flags_out[pix] = (gate_miss && px.valid) ? 1.0f : 0.0f;
  return mk3(o.x * r.w, o.y * r.w, o.z * r.w);
}

__device__ __forceinline__ void put_render(float* out, long long pix, f3 o,
                                           bool valid) {
  reinterpret_cast<float4*>(out)[pix] =
      make_float4(valid ? o.x : 0.0f, valid ? o.y : 0.0f, valid ? o.z : 0.0f,
                  valid ? 1.0f : 0.0f);
}

template <bool TEMPORAL, bool VALIDATION, bool TRACK_DE, bool TRACK_IND>
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
             int n_alias, int bounces, LightIO io) {
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

  long long pix = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (pix >= (long long)h * w) return;
  // plane 0 of this pixel's reservoir in an [h,16,w] tensor
  long long y = pix / w, x = pix % w;
  long long base = y * 16 * w + x;

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

  Px px;
  float4 pos = reinterpret_cast<const float4*>(position)[pix];
  px.p = mk3(pos.x, pos.y, pos.z);
  px.depth = pos.w;
  px.n = mk3(normal[3 * pix], normal[3 * pix + 1], normal[3 * pix + 2]);
  px.nn = rsqrt_n(px.n);
  float2 im = reinterpret_cast<const float2*>(inst_mat)[pix];
  // ids as the TPU wrapper feeds them: truncated to int, material >= 0
  px.inst_f = (float)(int)im.x;
  float mat_f = (float)max((int)im.y, 0);
  float4 rnd = reinterpret_cast<const float4*>(rand)[pix];
  px.r0 = rnd.x;
  px.r1 = rnd.y;
  px.r2 = rnd.z;
  px.r3 = rnd.w;
  px.valid = px.depth >= HK_F32_EPS;
  px.amb = mk3(params[P_AMB], params[P_AMB + 1], params[P_AMB + 2]);
  px.surf = surface_of(mats, n_mats, mat_f);
  px.v = rsqrt_n(mk3(params[P_CAM] - px.p.x, params[P_CAM + 1] - px.p.y,
                     params[P_CAM + 2] - px.p.z));

  if (io.render[0] != nullptr) {
    f3 o;
    if (TEMPORAL) {
      o = reuse_channel<VALIDATION, TRACK_DE>(
          tb, true, px, io.prev[0], params[P_VAL], base, pix, w, io.var[0],
          io.packed[0], io.flags[0], io.scatter[0]);
    } else {
      Cand c = solar_candidate(params, px.r2, px.r3, px.p);
      o = shade_channel(tb, c, true, px);
    }
    float em_add = 255.0f * px.surf.em_a;
    put_render(io.render[0], pix,
               mk3(o.x + em_add * px.surf.em.x, o.y + em_add * px.surf.em.y,
                   o.z + em_add * px.surf.em.z),
               px.valid);
  }
  if (io.render[1] != nullptr) {
    f3 o;
    if (TEMPORAL) {
      o = reuse_channel<VALIDATION, TRACK_DE>(
          tb, false, px, io.prev[1], params[P_VAL + 1], base, pix, w,
          io.var[1], io.packed[1], io.flags[1], io.scatter[1]);
    } else {
      Cand c = emissive_candidate(tb, px.r0, px.r1, px.r2, px.r3, px.p, px.n,
                                  px.inst_f);
      o = shade_channel(tb, c, false, px);
    }
    put_render(io.render[1], pix, o, px.valid);
  }
  if (io.render[2] != nullptr) {
    Ind ind = indirect_bounces(tb, bounces, px);
    f3 o;
    if (TEMPORAL) {
      o = indirect_reuse<TRACK_IND>(tb, px, ind, io.prev[2], base, pix, w,
                                    io.var[2], io.packed[2], io.flags[2]);
    } else {
      f3 s;
      float lum_s;
      float w_new = indirect_sample(px, ind, s, lum_s);
      float w2d =
          (px.valid && lum_s > 0.0f) ? w_new / fmaxf(lum_s, 1e-30f) : 0.0f;
      o = mk3(s.x * w2d, s.y * w2d, s.z * w2d);
    }
    put_render(io.render[2], pix, o, px.valid);
  }
}

template <bool T, bool V, bool D, bool I>
static int launch(size_t smem, cudaStream_t st, const float* params,
                  const float* tris, const float* tri_attr, int n_tris,
                  const float* em_tris, const float* em_attr, int n_em_tris,
                  const float* mats, int n_mats, const float* position,
                  const float* normal, const float* inst_mat,
                  const float* rand, int h, int w, int n_em, int n_alias,
                  int bounces, const LightIO& io) {
  cudaError_t err = cudaFuncSetAttribute(
      light_kernel<T, V, D, I>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  int threads = 128;
  long long blocks = ((long long)h * w + threads - 1) / threads;
  light_kernel<T, V, D, I><<<(unsigned)blocks, threads, smem, st>>>(
      params, tris, tri_attr, n_tris, em_tris, em_attr, n_em_tris, mats,
      n_mats, position, normal, inst_mat, rand, h, w, n_em, n_alias, bounces,
      io);
  return (int)cudaGetLastError();
}

// io: host array of 18 pointers in LightIO's field order (render, var,
// packed, flags, scatter, prev; d, e, i each).
extern "C" int hk_light_fused(const float* params, const float* tris,
                              const float* tri_attr, int n_tris,
                              const float* em_tris, const float* em_attr,
                              int n_em_tris, const float* mats, int n_mats,
                              const float* position, const float* normal,
                              const float* inst_mat, const float* rand, int h,
                              int w, int n_em, int n_alias, int bounces,
                              const void* const* io_ptrs, int temporal,
                              int validation, int track_de, int track_ind,
                              void* stream) {
  LightIO io;
  for (int c = 0; c < 3; c++) {
    io.render[c] = (float*)io_ptrs[c];
    io.var[c] = (float*)io_ptrs[3 + c];
    io.packed[c] = (float*)io_ptrs[6 + c];
    io.flags[c] = (float*)io_ptrs[9 + c];
    io.scatter[c] = (float*)io_ptrs[12 + c];
    io.prev[c] = (const float*)io_ptrs[15 + c];
  }
  size_t smem = sizeof(float) * (P_COUNT + 2 * HK_TRI * n_tris +
                                 2 * HK_TRI * n_em_tris + HK_MAT * n_mats);
  cudaStream_t st = (cudaStream_t)stream;
#define HK_ARGS                                                            \
  smem, st, params, tris, tri_attr, n_tris, em_tris, em_attr, n_em_tris,   \
      mats, n_mats, position, normal, inst_mat, rand, h, w, n_em, n_alias, \
      bounces, io
  if (!temporal) return launch<false, false, false, false>(HK_ARGS);
  switch ((validation ? 4 : 0) + (track_de ? 2 : 0) + (track_ind ? 1 : 0)) {
    case 0: return launch<true, false, false, false>(HK_ARGS);
    case 1: return launch<true, false, false, true>(HK_ARGS);
    case 2: return launch<true, false, true, false>(HK_ARGS);
    case 3: return launch<true, false, true, true>(HK_ARGS);
    case 4: return launch<true, true, false, false>(HK_ARGS);
    case 5: return launch<true, true, false, true>(HK_ARGS);
    case 6: return launch<true, true, true, false>(HK_ARGS);
    default: return launch<true, true, true, true>(HK_ARGS);
  }
#undef HK_ARGS
}
