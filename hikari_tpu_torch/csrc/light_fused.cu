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
// Design. Most of the time goes to the triangle sweeps: five or more per
// pixel over the whole table (the box: 40 rows, 36 triangles), each test
// ~60 instructions at --fmad=false; kernel 4's reservoir work (two 64 B
// reservoirs read and up to four written per pixel, with their IEEE
// divisions) adds a third. So:
// * each block (one tile of pixels) stages the scene's triangles, the
//   emissive triangles, the materials and the parameter vector (with the
//   emissive leaves and alias slots) in dynamic shared memory, a thread
//   per row; the sweeps read triangle rows of three float4s, the first
//   vertex with the instance id, then the edges v1 - v0 and v2 - v0,
//   subtracted once at staging (the same words the per-test subtraction
//   gave), so a test loads three vectors and skips six subtractions; the
//   occluder loop takes |det| and flips signs by selection, as
//   sgnf(det) * x does for det != 0 (for det = 0 or NaN no test passes
//   either way). The normal and material rows stay in global memory: a
//   sweep reads only its winner's;
// * kernel B skips work no output word depends on, each case with its
//   proof beside the code: it returns at an invalid pixel after writing
//   its zeros (on the box at 1080p a third of the warps hold no valid
//   pixel), and skips the shadow sweep of a candidate whose trace_ok is
//   false where shade_ignores_l holds;
// * a temporal thread starts copying its pixel's previous reservoirs (16
//   words per channel) into shared memory (cp.async) before it stages and
//   traces, so their latency passes under the sweeps; it reads them after
//   this frame's candidate is traced, and the validation retrace follows
//   the merge (retracing first holds its 12 results across the candidate's
//   sweep and spills);
// * the sweeps are not unrolled. Kernel 4's instances (light_kernel) run
//   4 blocks of 128 threads per SM within 128 registers. Kernel B has a
//   kernel of its own (light_kernel_b, no reservoir stash): 4 blocks of
//   256 threads per SM, so 64 registers and ~260 B of spills, which beats
//   119 registers and half the warps (the extra warps hide more latency
//   than the spills add; PERF.md).
// Tried on the card and dropped: a persistent grid that stages the tables
// once per resident block (its static tiling leaves a tail); for kernel 4
// 5 or 6 blocks per SM (every instance spills hundreds of bytes and runs
// slower); for kernel B several tiles a block after one staging (a block
// holds its registers until its last warp ends, so the invalid warps'
// slots stay taken), its sweeps unrolled twice, kernel A's sign skip in
// the closest-hit test, the division skipped where num and det do not
// share a strict sign (1.5-4% slower: the warp still divides unless all
// 32 lanes skip, and the per-lane branch costs more than it saves), and
// skipping the emissive probe without a pick above the surface and the
// bounce's NEE where it cannot reach the sum (exact, but on the box no
// warp skips them whole: B 1.5% and kernel 4 3-4% slower with them).
// The TPU kernel's per-lane select-sweeps become indexed loads, its
// unrolled emissive-leaf walk a loop over n_em. The G-buffer is read from
// the interleaved [h,w,C] tensors, the reservoirs from and to the [h,16,w]
// channel planes (threads of a warp on neighbouring x of one plane). The
// variants are template instances picked on the host from Python
// integers, never from a device value. Each expression keeps the plain
// version's operation order, so with --fmad=false every word equals it.
//
// Bound on the H100 (chip_smoke.light_work): the larger of the bytes (the
// G-buffer and noise in, per active channel the render out; with TEMPORAL
// the 64 B reservoir in and the render, variance and 64 B reservoir out per
// channel, plus the tracked flags and scatter) over 3.35 TB/s and the
// operations (60 per triangle test, 400 per channel's shading, 300 per
// channel's reservoir algebra) over 67 TFLOP/s, kernel B's over its valid
// pixels only. Both kernels run several times their bound: the operations
// count omits the compares, selects and shared-memory loads a test issues.

#include <cuda_pipeline.h>

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

#define EDGE_ROW 12

// trace_pallas.shadow_sweep over staged edge rows, for rays that include
// every instance. ads = |det| and the signs flipped by selection: for det
// != 0 the words of sgnf(det) * x; for det = 0 or NaN no row passes
// (ads >= eps fails) either way. The sweeps are not unrolled: unrolled,
// kernel 4's instances spill and kernel B spills more (PERF.md).
__device__ __forceinline__ Shadow edge_shadow(const float4* rows, int n, f3 o,
                                              f3 d, float maxt, float excl) {
  Occluder b = occluder_none();
#pragma unroll 1
  for (int i = 0; i < n; i++) {
    float4 a = rows[3 * i];
    float inst = a.w;
    if (!mt_accepts(inst, excl, -1.0f)) continue;
    MT m = edge_terms(a, rows[3 * i + 1], rows[3 * i + 2], o, d);
    bool neg = m.det < 0.0f;
    float ads = fabsf(m.det);
    float ud = neg ? -m.uu : m.uu;
    float vd = neg ? -m.vv : m.vv;
    float td = neg ? -m.dist : m.dist;
    bool ok = ads >= HK_F32_EPS && ud >= 0.0f && vd >= 0.0f &&
              ud + vd <= ads && td > HK_F32_EPS * ads && td < maxt * ads &&
              td * b.ads < b.td * ads;
    if (ok) {
      b.td = td;
      b.ads = ads;
      b.inst = inst;
    }
  }
  return shadow_result(b);
}

// trace_pallas.trace_full_sweep over staged edge rows: closest_accept on
// edge_terms, then the winner's normal and material from its attribute row
// (17 floats in global memory: the 9 vertex normals, the material at 16).
__device__ __forceinline__ Hit edge_trace_full(const float4* rows,
                                               const float* attrs, int n,
                                               f3 o, f3 d, float maxt,
                                               float excl, float incl) {
  Closest c = closest_miss();
#pragma unroll 1
  for (int i = 0; i < n; i++) {
    float4 a = rows[3 * i];
    float inst = a.w;
    if (!mt_accepts(inst, excl, incl)) continue;
    MT m = edge_terms(a, rows[3 * i + 1], rows[3 * i + 2], o, d);
    float inv_det = fabsf(m.det) < HK_F32_EPS ? 0.0f : 1.0f / m.det;
    float u = m.uu * inv_det;
    float v = m.vv * inv_det;
    float dist = m.dist * inv_det;
    bool ok = fabsf(m.det) >= HK_F32_EPS && u >= 0.0f && u <= 1.0f &&
              v >= 0.0f && u + v <= 1.0f && dist > HK_F32_EPS &&
              dist < maxt && dist < c.t;
    if (ok) {
      c.t = dist;
      c.u = u;
      c.v = v;
      c.prim = i;
      c.inst = inst;
    }
  }
  Hit hit;
  hit.t = c.t;
  hit.inst = c.inst;
  hit.n = mk3(0.0f, 0.0f, 0.0f);
  hit.mat = -1.0f;
  if (c.prim >= 0) {
    const float* at = attrs + 17 * c.prim;
    hit.n = mk3(interp(__ldg(at), __ldg(at + 3), __ldg(at + 6), c.u, c.v),
                interp(__ldg(at + 1), __ldg(at + 4), __ldg(at + 7), c.u, c.v),
                interp(__ldg(at + 2), __ldg(at + 5), __ldg(at + 8), c.u, c.v));
    hit.mat = __ldg(at + 16);
  }
  return hit;
}

struct Cand {
  f3 d;
  float p, maxd, em_inst, info_inst, info_mat;
  f3 sp;
  float spw;  // 1 when the sample point lies on a surface
  f3 sn;      // the sample point's normal
};

// The tables of a block. Staged in shared memory: tris / em_edges,
// EDGE_ROW-float rows of three float4s (v0 + instance id, v1 - v0,
// v2 - v0); em_tris, the emissive triangles' HK_TRI-float rows as given
// (the sample point on the picked triangle needs its vertices); params and
// mats. In global memory (a sweep reads only its winner's row): attrs /
// em_attrs, 17-float rows (the 9 vertex normals, the material at 16).
struct Tables {
  const float* params;
  const float4* tris;
  const float* attrs;
  int n_tris;
  const float4* em_edges;
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
  Hit ph = edge_trace_full(tb.em_edges, tb.em_attrs, tb.n_em_tris, ro, rd,
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

// candidate -> shadow -> input radiance, occluders overriding the probe.
// With `skip_dead` (kernel B's shade_channel, where shade_ignores_l
// holds) a candidate whose trace_ok is false skips its shadow sweep: its
// radiance is zeroed below whatever the sweep finds, and what the sweep
// also moves (the sample point, so the shading's light direction) reaches
// no output word there (shade_ignores_l).
__device__ Traced trace_candidate(const Tables& tb, const Cand& c,
                                  bool directional, f3 p, f3 n,
                                  bool skip_dead = false) {
  bool trace_ok = (dot3(c.d, n) > 0.0f) && (c.p > 0.0f);
  if (!directional) trace_ok = trace_ok && (c.em_inst >= 0.0f);
  f3 ro = mk3(p.x + n.x * HK_RAY_BIAS, p.y + n.y * HK_RAY_BIAS,
              p.z + n.z * HK_RAY_BIAS);
  Shadow sh = shadow_result(occluder_none());
  if (trace_ok || !skip_dead)
    sh = edge_shadow(tb.tris, tb.n_tris, ro, c.d, c.maxd, c.em_inst);
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

// True where the words shade_channel returns for a candidate whose
// trace_ok is false cannot depend on the light direction l, so on the
// shadow sweep that moves it. There rad = 0, rad_a = 0, lum = +0, w_f = +0
// and w2d = +0, and shade() gives o.c = lit_c * 0 + am_c * 1 with
// lit_c = Y_c * 0 * nol, Y_c = dv * f_c + diff.c * fd, and am_c =
// (da.c + sa.c) * amb.c, which does not depend on l. l enters only
// through nol, noh and loh, and clip01 holds those in [0, 1] for every
// input, NaN and infinities included. So, for every l:
// * rough = clamped^2 with clamped in [0.089, 1] (NaN gives 0.089), the
//   GGX term k = rough / (1 - noh^2 + (noh rough)^2) <= ~1 / rough and
//   d = k^2 / pi are finite; vis = 0.5 / fmaxf(lam, 1e-7) lies in
//   [0, 5e6] for any lam (NaN gives 1e-7); so dv = d * vis is finite;
// * with |f0.c| <= 2^60, f_c = f0.c + (fr90 - f0.c) * sch (fr90 and sch
//   in [0, 1]) is finite and dv * f_c too;
// * with nov <= 2 (nov >= 1e-4 by its fmaxf), both factors of fd lie in
//   [-0.5, 2.5] (f90 in [0.5, 2.5], the pow5 terms in [-1, 1]), so with
//   |diff.c| <= 2^60, diff.c * fd is finite;
// so Y_c is finite, lit_c * 0 is a zero, and zero + am_c is am_c's word
// unless am_c is -0 (then the zero's sign, which depends on Y_c, decides).
// With those bounds and no am_c equal to -0, o and o * w2d are the same
// words whatever the sweep returns.
__device__ __forceinline__ bool shade_ignores_l(const Px& px) {
  const Surface& s = px.surf;
  const float big = 0x1p60f;
  bool bounded = fabsf(s.f0.x) <= big && fabsf(s.f0.y) <= big &&
                 fabsf(s.f0.z) <= big && fabsf(s.diff.x) <= big &&
                 fabsf(s.diff.y) <= big && fabsf(s.diff.z) <= big;
  float nov = fmaxf(dot3(px.n, px.v), 0.0001f);
  f3 da = env_brdf_approx(s.diff, 1.0f, nov);
  f3 sa = env_brdf_approx(s.f0, s.rough, nov);
  const uint32_t neg0 = 0x80000000u;
  bool no_neg0 = __float_as_uint((da.x + sa.x) * px.amb.x) != neg0 &&
                 __float_as_uint((da.y + sa.y) * px.amb.y) != neg0 &&
                 __float_as_uint((da.z + sa.z) * px.amb.z) != neg0;
  return bounded && nov <= 2.0f && no_neg0;
}

// direct_lit's no-reuse path: candidate -> shadow -> input radiance ->
// shading * w (restir.py:318-370)
__device__ f3 shade_channel(const Tables& tb, const Cand& c, bool directional,
                            const Px& px) {
  Traced t = trace_candidate(tb, c, directional, px.p, px.n,
                             shade_ignores_l(px));
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
    Hit h = edge_trace_full(tb.tris, tb.attrs, tb.n_tris, ro, rd, HK_F32_MAX,
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
    Shadow sh = edge_shadow(tb.tris, tb.n_tris, ro2, c.d, c.maxd, c.em_inst);
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

// The validation retrace's results (light.wgsl:1156-1213): the radiance
// found towards the remembered sample, the surface point and normal the
// ray ends on, and the re-selected candidate's pdf.
struct Retrace {
  f3 rad;
  float rad_a;
  f3 sp;
  float spw;
  f3 sn;
  float p;
};

#define LIGHT_THREADS 128

// The gated previous reservoir of this pixel (check_previous_reservoir on
// the gathered planes), from the thread's copy in shared memory (`stash`:
// its 16 words LIGHT_THREADS apart, see prefetch_prev); sets its miss.
__device__ __forceinline__ Rsv prev_reservoir(const float* stash,
                                              const Px& px, bool& miss) {
  __pipeline_wait_prior(0);
  Rsv r = rsv_load(stash, 0, LIGHT_THREADS);
  miss = gates(r, px);
  return r;
}

// retrace of the remembered sample: candidate re-select at the stored
// point, shadow ray from this frame's point towards the stored sample
__device__ Retrace retrace(const Tables& tb, bool directional, const Px& px,
                           const Rsv& r) {
  Cand cv = channel_candidate(tb, directional, r.rnd0, r.rnd1, r.rnd2,
                              r.rnd3, mk3(r.vpx, r.vpy, r.vpz),
                              mk3(r.vnx, r.vny, r.vnz), px.inst_f);
  f3 rv = rsqrt_n(mk3(r.spx - px.p.x, r.spy - px.p.y, r.spz - px.p.z));
  bool trace_ok =
      (dot3(cv.d, mk3(r.vnx, r.vny, r.vnz)) > 0.0f) && (cv.p > 0.0f);
  if (!directional) trace_ok = trace_ok && (cv.em_inst >= 0.0f);
  f3 ro = mk3(px.p.x + px.n.x * HK_RAY_BIAS, px.p.y + px.n.y * HK_RAY_BIAS,
              px.p.z + px.n.z * HK_RAY_BIAS);
  Shadow sh = edge_shadow(tb.tris, tb.n_tris, ro, rv, cv.maxd, cv.em_inst);
  float vi_inst = sh.occluded ? sh.inst : cv.info_inst;
  float vi_mat = sh.occluded ? -1.0f : cv.info_mat;
  Retrace v;
  v.sp = sh.occluded ? ray_at(ro, rv, sh.t) : cv.sp;
  v.spw = sh.occluded ? 1.0f : cv.spw;
  v.sn = sh.occluded ? mk3(0.0f, 0.0f, 0.0f) : cv.sn;
  input_radiance(tb, directional, rv, vi_inst, vi_mat, cv.em_inst, v.rad,
                 v.rad_a);
  if (!trace_ok) {
    v.rad = mk3(0.0f, 0.0f, 0.0f);
    v.rad_a = 0.0f;
  }
  v.p = cv.p;
  return v;
}

// the temporal path of direct_lit (light.wgsl:1045-1261) for the direct
// or emissive channel; returns the shaded rgb * w. The previous reservoir
// (its prefetched copy) is read after this frame's candidate is traced;
// on validation frames the retrace of its remembered sample follows the
// merge.
template <bool VALIDATION, bool TRACK>
__device__ f3 reuse_channel(const Tables& tb, bool directional, const Px& px,
                            const float* stash, float is_val, long long base,
                            long long pix, int w, float* var_out,
                            float* packed_out, float* flags_out,
                            float* scatter_out) {
  bool validate = VALIDATION && is_val > 0.5f;
  Cand c = channel_candidate(tb, directional, px.r0, px.r1, px.r2, px.r3,
                             px.p, px.n, px.inst_f);
  Traced t = trace_candidate(tb, c, directional, px.p, px.n);
  bool gate_miss;
  Rsv r = prev_reservoir(stash, px, gate_miss);
  Rsv s2 = sample_of(t.rad, t.rad_a, px, px.n, t.sp, t.spw, t.sn);
  bool gate = px.valid && ((is_val < 0.5f) || (r.count < 4.0f));
  Rsv cur = r;
  rsv_update(cur, s2, t.w_new, gate);
  rsv_clamp(cur, tb.params[P_MAXCNT]);
  if (TRACK) rsv_store(scatter_out, base, w, cur);
  bool val_miss = false;
  if (validate) {
    Retrace v = retrace(tb, directional, px, r);
    Rsv s2v = s2;
    if (r.count >= 4.0f) {
      s2v.rnd0 = r.rnd0;
      s2v.rnd1 = r.rnd1;
      s2v.rnd2 = r.rnd2;
      s2v.rnd3 = r.rnd3;
      s2v.spx = v.sp.x;
      s2v.spy = v.sp.y;
      s2v.spz = v.sp.z;
      s2v.spw = v.spw;
      s2v.snx = v.sn.x;
      s2v.sny = v.sn.y;
      s2v.snz = v.sn.z;
      s2v.rad_r = v.rad.x;
      s2v.rad_g = v.rad.y;
      s2v.rad_b = v.rad.z;
      s2v.rad_a = v.rad_a;
    }
    float lum_ratio = lum3(v.rad.x, v.rad.y, v.rad.z) /
                      fmaxf(lum3(r.rad_r, r.rad_g, r.rad_b), 1e-4f);
    bool take_v = ((lum_ratio > 1.25f) || (lum_ratio < 0.8f)) && px.valid;
    float w_new_v =
        v.p > 0.0f
            ? lum3(s2v.rad_r, s2v.rad_g, s2v.rad_b) / fmaxf(v.p, 1e-30f)
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
                             const float* stash, long long base,
                             long long pix, int w, float* var_out,
                             float* packed_out, float* flags_out) {
  f3 s;
  float lum_s;
  float w_new = indirect_sample(px, ind, s, lum_s);
  bool gate_miss;
  Rsv r = prev_reservoir(stash, px, gate_miss);
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

// One launch's arguments, as ops/light_fused.py LIGHT_TABLE packs them.
// io: per channel d, e, i the render [h,w,4], variance [h,w], packed
// reservoir [h,16,w], flags [h,w], scatter reservoir [h,16,w] and gathered
// previous reservoir [h,16,w] (null where the variant or the channel has
// none).
struct LightCall {
  const float* params;
  const float* tris;      // [n_tris, 10]
  const float* attrs;     // [n_tris, 17]
  const float* em_tris;   // [n_em_tris, 10]
  const float* em_attrs;  // [n_em_tris, 17]
  const float* mats;      // [n_mats, 15]
  const float* position;  // [h,w,4]
  const float* normal;    // [h,w,3]
  const float* inst_mat;  // [h,w,2]
  const float* rand;      // [h,w,4]
  LightIO io;
  int n_tris, n_em_tris, n_mats, h, w, n_em, n_alias, bounces;
  int temporal, validation, track_de, track_ind;
};
static_assert(sizeof(LightCall) == 272, "LightCall: ops/light_fused.py");

// blocks of LIGHT_THREADS per SM: __launch_bounds__ then allows each
// thread 128 registers, which every instance uses without spilling
#define LIGHT_MIN_BLOCKS 4

// Shared-memory floats of a launch's tables (stage_tables' layout): the
// edge rows first (16-byte aligned), then params, the raw emissive rows
// and the materials.
__host__ __device__ inline int table_floats(int n_tris, int n_em_tris,
                                            int n_mats) {
  return EDGE_ROW * (n_tris + n_em_tris) + P_COUNT + HK_TRI * n_em_tris +
         HK_MAT * n_mats;
}

// edge rows: (v0, instance id), v1 - v0, v2 - v0; a thread per row
__device__ __forceinline__ void stage_edges(float4* dst, const float* src,
                                            int rows) {
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    const float* t = src + r * HK_TRI;
    float4* q = dst + 3 * r;
    q[0] = make_float4(t[0], t[1], t[2], t[9]);
    q[1] = make_float4(t[3] - t[0], t[4] - t[1], t[5] - t[2], 0.0f);
    q[2] = make_float4(t[6] - t[0], t[7] - t[1], t[8] - t[2], 0.0f);
  }
}

// n contiguous floats
__device__ __forceinline__ void stage_flat(float* dst, const float* src,
                                           int n) {
  for (int k = threadIdx.x; k < n; k += blockDim.x) dst[k] = src[k];
}

__device__ Tables stage_tables(const LightCall& c, float* smem) {
  float4* tris = reinterpret_cast<float4*>(smem);
  float4* em_edges = tris + 3 * c.n_tris;
  float* params = reinterpret_cast<float*>(em_edges + 3 * c.n_em_tris);
  float* em_tris = params + P_COUNT;
  float* mats = em_tris + HK_TRI * c.n_em_tris;
  stage_edges(tris, c.tris, c.n_tris);
  stage_edges(em_edges, c.em_tris, c.n_em_tris);
  stage_flat(params, c.params, P_COUNT);
  stage_flat(em_tris, c.em_tris, HK_TRI * c.n_em_tris);
  // the first HK_MAT of each material's 15 floats, a thread per row
  for (int r = threadIdx.x; r < c.n_mats; r += blockDim.x)
    for (int k = 0; k < HK_MAT; k++) mats[HK_MAT * r + k] = c.mats[15 * r + k];
  __syncthreads();
  Tables tb;
  tb.params = params;
  tb.tris = tris;
  tb.attrs = c.attrs;
  tb.n_tris = c.n_tris;
  tb.em_edges = em_edges;
  tb.em_tris = em_tris;
  tb.em_attrs = c.em_attrs;
  tb.n_em_tris = c.n_em_tris;
  tb.mats = mats;
  tb.n_mats = c.n_mats;
  tb.n_em = c.n_em;
  tb.n_alias = c.n_alias;
  return tb;
}

// Starts copying the 16 words of this pixel's previous reservoir of each
// channel that has one into the thread's stash in shared memory (channel
// k of the present ones at stash[(16 k + plane) * LIGHT_THREADS]); the
// copies run while the thread traces, and prev_reservoir waits for them.
__device__ __forceinline__ void prefetch_prev(const LightIO& io, float* stash,
                                              long long base, int w) {
  int k = 0;
  for (int ch = 0; ch < 3; ch++) {
    if (io.prev[ch] == nullptr) continue;
    for (int q = 0; q < 16; q++)
      __pipeline_memcpy_async(stash + (16 * k + q) * LIGHT_THREADS,
                              io.prev[ch] + base + (long long)q * w, 4);
    k++;
  }
  __pipeline_commit();
}

template <bool TEMPORAL, bool VALIDATION, bool TRACK_DE,
          bool TRACK_IND>
__device__ __forceinline__ void light_pixel(const LightCall& c,
                                            const Tables& tb, long long pix,
                                            long long base,
                                            const float* stash) {
  const float* params = tb.params;
  const LightIO& io = c.io;
  int w = c.w;
  // the stash of each channel's previous reservoir (see prefetch_prev)
  const float* stash_d = stash;
  const float* stash_e = stash_d + (io.prev[0] ? 16 * LIGHT_THREADS : 0);
  const float* stash_i = stash_e + (io.prev[1] ? 16 * LIGHT_THREADS : 0);

  Px px;
  float4 pos = reinterpret_cast<const float4*>(c.position)[pix];
  px.p = mk3(pos.x, pos.y, pos.z);
  px.depth = pos.w;
  px.valid = px.depth >= HK_F32_EPS;
  if (!TEMPORAL && !px.valid) {
    // kernel B writes only renders, and put_render zeroes every word of an
    // invalid pixel's: nothing else of the pixel reaches an output
    for (int ch = 0; ch < 3; ch++)
      if (io.render[ch] != nullptr)
        put_render(io.render[ch], pix, mk3(0.0f, 0.0f, 0.0f), false);
    return;
  }
  px.n = mk3(c.normal[3 * pix], c.normal[3 * pix + 1], c.normal[3 * pix + 2]);
  px.nn = rsqrt_n(px.n);
  float2 im = reinterpret_cast<const float2*>(c.inst_mat)[pix];
  // ids as the TPU wrapper feeds them: truncated to int, material >= 0
  px.inst_f = (float)(int)im.x;
  float mat_f = material_id(im.y);
  float4 rnd = reinterpret_cast<const float4*>(c.rand)[pix];
  px.r0 = rnd.x;
  px.r1 = rnd.y;
  px.r2 = rnd.z;
  px.r3 = rnd.w;
  px.amb = mk3(params[P_AMB], params[P_AMB + 1], params[P_AMB + 2]);
  px.surf = surface_of(tb.mats, tb.n_mats, mat_f);
  px.v = rsqrt_n(mk3(params[P_CAM] - px.p.x, params[P_CAM + 1] - px.p.y,
                     params[P_CAM + 2] - px.p.z));

  if (io.render[0] != nullptr) {
    f3 o;
    if (TEMPORAL) {
      o = reuse_channel<VALIDATION, TRACK_DE>(
          tb, true, px, stash_d, params[P_VAL], base, pix, w, io.var[0],
          io.packed[0], io.flags[0], io.scatter[0]);
    } else {
      Cand cd = solar_candidate(params, px.r2, px.r3, px.p);
      o = shade_channel(tb, cd, true, px);
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
          tb, false, px, stash_e, params[P_VAL + 1], base, pix, w,
          io.var[1], io.packed[1], io.flags[1], io.scatter[1]);
    } else {
      Cand cd = emissive_candidate(tb, px.r0, px.r1, px.r2, px.r3, px.p,
                                   px.n, px.inst_f);
      o = shade_channel(tb, cd, false, px);
    }
    put_render(io.render[1], pix, o, px.valid);
  }
  if (io.render[2] != nullptr) {
    Ind ind = indirect_bounces(tb, c.bounces, px);
    f3 o;
    if (TEMPORAL) {
      o = indirect_reuse<TRACK_IND>(tb, px, ind, stash_i, base, pix, w,
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

// Kernel 4: one LIGHT_THREADS-pixel tile per block.
template <bool VALIDATION, bool TRACK_DE, bool TRACK_IND>
__global__ void __launch_bounds__(LIGHT_THREADS, LIGHT_MIN_BLOCKS)
light_kernel(const __grid_constant__ LightCall c) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  long long pix = (long long)blockIdx.x * LIGHT_THREADS + threadIdx.x;
  bool in = pix < (long long)c.h * c.w;
  // plane 0 of this pixel's reservoir in an [h,16,w] tensor
  long long base = (pix / c.w) * 16 * c.w + pix % c.w;
  float* stash = smem + table_floats(c.n_tris, c.n_em_tris, c.n_mats) +
                 threadIdx.x;
  if (in) prefetch_prev(c.io, stash, base, c.w);
  Tables tb = stage_tables(c, smem);
  if (!in) return;
  light_pixel<true, VALIDATION, TRACK_DE, TRACK_IND>(c, tb, pix, base,
                                                     stash);
}

// Kernel B's launch shape (it keeps no reservoir stash): 256-pixel tiles,
// 4 blocks per SM, so __launch_bounds__ caps it at 64 registers: it spills
// (~260 B) and runs faster so than at 119 registers and half the warps.
#define B_THREADS 256
#define B_MIN_BLOCKS 4

__global__ void __launch_bounds__(B_THREADS, B_MIN_BLOCKS)
light_kernel_b(const __grid_constant__ LightCall c) {
  extern __shared__ float4 smem4[];
  Tables tb = stage_tables(c, reinterpret_cast<float*>(smem4));
  long long pix = (long long)blockIdx.x * B_THREADS + threadIdx.x;
  if (pix >= (long long)c.h * c.w) return;
  light_pixel<false, false, false, false>(c, tb, pix, 0, nullptr);
}

// The shared memory a launch staged: the tables and, with previous
// reservoirs, 16 words per thread for each.
static int light_smem(const LightCall& c) {
  int n_prev = (c.io.prev[0] != nullptr) + (c.io.prev[1] != nullptr) +
               (c.io.prev[2] != nullptr);
  return (int)sizeof(float) *
         (table_floats(c.n_tris, c.n_em_tris, c.n_mats) +
          16 * LIGHT_THREADS * (c.temporal ? n_prev : 0));
}

template <bool V, bool D, bool I>
static int launch(const LightCall& c, cudaStream_t st) {
  // the dynamic shared memory each device allows the instance so far
  static int allowed[HK_MAX_DEVICES];
  int smem = light_smem(c);
  cudaError_t err = allow_smem(light_kernel<V, D, I>, smem, allowed);
  if (err != cudaSuccess) return (int)err;
  long long tiles = ((long long)c.h * c.w + LIGHT_THREADS - 1) / LIGHT_THREADS;
  if (tiles < 1) return 0;
  light_kernel<V, D, I><<<(unsigned)tiles, LIGHT_THREADS, smem, st>>>(c);
  return (int)cudaGetLastError();
}

static int launch_b(const LightCall& c, cudaStream_t st) {
  static int allowed[HK_MAX_DEVICES];
  int smem = light_smem(c);
  cudaError_t err = allow_smem(light_kernel_b, smem, allowed);
  if (err != cudaSuccess) return (int)err;
  long long blocks = ((long long)c.h * c.w + B_THREADS - 1) / B_THREADS;
  if (blocks < 1) return 0;
  light_kernel_b<<<(unsigned)blocks, B_THREADS, smem, st>>>(c);
  return (int)cudaGetLastError();
}

extern "C" int hk_light_fused(const LightCall* call, void* stream) {
  const LightCall& c = *call;
  cudaStream_t st = (cudaStream_t)stream;
  if (!c.temporal) return launch_b(c, st);
  switch ((c.validation ? 4 : 0) + (c.track_de ? 2 : 0) +
          (c.track_ind ? 1 : 0)) {
    case 0: return launch<false, false, false>(c, st);
    case 1: return launch<false, false, true>(c, st);
    case 2: return launch<false, true, false>(c, st);
    case 3: return launch<false, true, true>(c, st);
    case 4: return launch<true, false, false>(c, st);
    case 5: return launch<true, false, true>(c, st);
    case 6: return launch<true, true, false>(c, st);
    default: return launch<true, true, true>(c, st);
  }
}
