// Kernel 13: the tracer of scenes above 768 triangles, a per-thread BVH
// walk in three modes.
//
// It replaces hikari_tpu/ops/trace_cull.py: _make_kernel (launched by
// _run_tiles' pallas_call, engine cull_trace) in its modes
// * hit    (hk_bvh_closest): the nearest accepted hit's t, u, v, triangle
//   index and instance;
// * full   (hk_bvh_full): the same hit plus the winner's interpolated
//   normal and uv and its material;
// * shadow (hk_bvh_shadow): the nearest occluder (t, instance) below
//   max_t, division-free as _shadow_tri.
//
// The TPU engine culls 64-triangle clusters per 1024-ray tile and sweeps
// the survivors with DMA double buffers, because the TPU has no per-lane
// gather. On Hopper each thread gathers freely, so ray i is thread i and
// walks a BVH. The contract is the reference's stackless walk of the world
// BVH (light.wgsl:400-486, ops/trace_cull.py walk_plain over bvh_packed):
// a node is visited when its slab entry t (make_ray's safe inverse) is
// below the bound; a leaf tests its one triangle; the bound is te < max_t
// and te < t_best in the hit modes (t_best falls with every accept), and
// te < max_t and te * |det|_best < t_d,best in shadow mode, so the walk
// divides nowhere. Ties go to the first triangle in walk order.
//
// Why another tree gives the same words. The walk's state (t_best, or the
// pair t_d, |det|) changes only when a leaf's triangle is accepted. Under
// one state the visit rule is monotone in te: x -> fl(x * |det|) is
// monotone for |det| > 0 (rounding is monotone), and te < max_t does not
// depend on the state. A box B' that contains B as floats (min <=, max >=)
// has te(B') <= te(B), and a hit on B implies one on B': every slab bound
// (b - o) * inv moves outwards, rounded monotonically. Take a leaf L whose
// own test passes under the state s(L) just before it, and an ancestor A,
// tested earlier. If some triangle was accepted between A's test and L,
// it lies in A's subtree (the walk is depth-first), so A was entered: it
// passed. Otherwise A was tested under s(L), and te(A) <= te(L) passes
// too. By induction from the root, L is reached and tested. So a walk
// tests exactly the leaves, in DFS order, whose own slab test passes under
// the state of that moment, and its outputs depend only on (1) the leaves'
// order, (2) their boxes, (3) inner boxes containing their leaves' boxes.
// A tree may also drop leaves whose triangle the ray's masks can never
// accept: their tests never change the state. This holds for shadow mode's
// rule as it stands (no monotonicity across states is needed), so that
// rule is unchanged.
//
// The tables (models/walk_tables.py) keep those three properties:
// * bvh_nodes: bvh_packed's rows as two float4s (min xyz + ref, max xyz +
//   exit; ref: the first child, or a leaf's -(triangle + 1)), one vector
//   load each instead of nine scalar loads;
// * bvh_wide: the binary world BVH collapsed into nodes of 3 slots (each
//   a binary node: its two children, then the slot with the most leaves
//   replaced by its two children, in DFS order), a slot two float4s: min
//   xyz + ref, max xyz + 0 (ref: a wide node > 0, a leaf's -(triangle +
//   1), 0 empty). The world slots' boxes are bvh_packed's rows;
// * one subtree per emissive instance in bvh_wide: the world nodes that
//   hold one of its triangles, single-child chains collapsed, each box the
//   union of its kept leaves. A ray included to that instance (incl >= 0,
//   the light probes) starts at its root (bvh_sub_root), and walks the
//   emitter's own tree, as the reference's probe walks the emitter's BLAS
//   (hikari_tpu/ops/trace.py:22-24);
// * tri_edges: v0 + instance, v1 - v0, v2 - v0 in three float4s
//   (edge_terms: mt_terms' subtractions done once, the same words);
//   tri_attr_pad: tri_attr padded to 5 float4s for the full epilogue.
//
// The walks. A warp in which some ray has an emitter's subtree walks
// bvh_wide: that ray from its subtree's root, the others (the probe's -2
// "no pick" rays among them) from the world's root. Expanding a node
// loads its 3 slots (6 independent float4 loads) and slab-tests them
// together; the passing slots (hit modes: below the bound of that moment;
// shadow mode: below max_t, the part of the rule no state changes) are
// taken in slot order: the first at once, the others pushed on a
// per-thread stack with their entry t, the last slot deepest. A popped
// slot is tested again against the bound of that moment (its te does not
// change), which is the binary walk's test of that node when it reaches
// it; a leaf then tests its triangle, an inner slot is expanded. The hit
// modes' push filter is exact because their bound only falls. HK_STACK
// bounds the stack; the tables raise when a tree could need more
// (walk_tables.plan). Every other warp walks bvh_nodes stackless, in
// walk_plain's own order. One walk per warp keeps a warp's lanes in one
// loop; per call, on the city's calls, it beat every ray on bvh_wide and
// each ray choosing by itself (PERF.md).
//
// Bound on the H100: the work depends on the data (slab tests and
// triangle tests of each ray), ~30 flops per slab test and 60 per triangle
// test; chip_smoke.walk_record counts both for the world walk and for this
// one on the same rays. Coherent rays (the 1080p primary) are issue-bound,
// incoherent ones (bounces, probes) wait on divergence and L1/L2 latency.

#include "common.cuh"

#define HK_WIDTH 3    // slots per node (walk_tables.WIDTH)
#define HK_STACK 64   // per-thread stack entries (walk_tables.WALK_STACK)

enum { MODE_HIT = 0, MODE_FULL = 1, MODE_SHADOW = 2 };

struct WalkTables {
  const float4* bin;      // [N][2]: bvh_packed as min xyz + ref, max xyz + exit
  int n_bin;
  const float4* nodes;    // [3 W][2]: min xyz + ref, max xyz + 0
  const int* sub_root;    // [n_inst]: each instance's subtree, 0 for none
  int n_inst;
  const float4* tris;     // [P][3]: v0 + instance, v1 - v0, v2 - v0
  const float4* attrs;    // [P][5]: tri_attr's 17 floats + 3 zeros
};

// make_ray's safe inverse direction (trace.py:44-48)
__device__ __forceinline__ float safe_inv(float d) {
  float s = fabsf(d) < 1e-20f ? (d < 0.0f ? -1e-20f : 1e-20f) : d;
  return 1.0f / s;
}

// intersects_aabb (light.wgsl:344-362): the entry t, F32_MAX on a miss
__device__ __forceinline__ float slab_entry(float4 lo, float4 hi, f3 o,
                                            f3 inv) {
  float t1x = (lo.x - o.x) * inv.x;
  float t1y = (lo.y - o.y) * inv.y;
  float t1z = (lo.z - o.z) * inv.z;
  float t2x = (hi.x - o.x) * inv.x;
  float t2y = (hi.y - o.y) * inv.y;
  float t2z = (hi.z - o.z) * inv.z;
  float t_min = fmaxf(fmaxf(fminf(t1x, t2x), fminf(t1y, t2y)),
                      fminf(t1z, t2z));
  float t_max = fminf(fminf(fmaxf(t1x, t2x), fmaxf(t1y, t2y)),
                      fmaxf(t1z, t2z));
  bool hit = t_max >= t_min && t_max >= 0.0f;
  return hit ? t_min : HK_F32_MAX;
}

// trace_pallas.closest_accept on an edge row
__device__ __forceinline__ void closest_edge(float4 a, float4 b, float4 e,
                                             int i, f3 o, f3 d, float maxt,
                                             float excl, float incl,
                                             Closest& c) {
  float inst = a.w;
  if (!mt_accepts(inst, excl, incl)) return;
  MT m = edge_terms(a, b, e, o, d);
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

// trace_pallas.shadow_accept on an edge row
__device__ __forceinline__ void shadow_edge(float4 a, float4 b, float4 e,
                                            f3 o, f3 d, float maxt,
                                            float excl, float incl,
                                            Occluder& oc) {
  float inst = a.w;
  if (!mt_accepts(inst, excl, incl)) return;
  MT m = edge_terms(a, b, e, o, d);
  float s = sgnf(m.det);
  float ads = m.det * s;
  float ud = m.uu * s;
  float vd = m.vv * s;
  float td = m.dist * s;
  bool ok = ads >= HK_F32_EPS && ud >= 0.0f && vd >= 0.0f &&
            ud + vd <= ads && td > HK_F32_EPS * ads && td < maxt * ads &&
            td * oc.ads < oc.td * ads;
  if (ok) {
    oc.td = td;
    oc.ads = ads;
    oc.inst = inst;
  }
}

// One ray and its running result.
struct Ray {
  f3 o, d, inv;
  float maxt, excl, incl;
  Closest c;   // hit modes
  Occluder b;  // shadow mode
};

// The walk's visit rule for a node with slab entry te, under the current
// state (the bound of that moment).
template <int MODE>
__device__ __forceinline__ bool visit(float te, const Ray& r) {
  return MODE == MODE_SHADOW ? (te < r.maxt && te * r.b.ads < r.b.td)
                             : (te < r.maxt && te < r.c.t);
}

// A visited leaf: its triangle's test.
template <int MODE>
__device__ __forceinline__ void test_leaf(const WalkTables& tb, int prim,
                                          Ray& r) {
  const float4* row = tb.tris + 3 * (long long)prim;
  float4 r0 = __ldg(row), r1 = __ldg(row + 1), r2 = __ldg(row + 2);
  if (MODE == MODE_SHADOW)
    shadow_edge(r0, r1, r2, r.o, r.d, r.maxt, r.excl, r.incl, r.b);
  else
    closest_edge(r0, r1, r2, prim, r.o, r.d, r.maxt, r.excl, r.incl, r.c);
}

// The stackless walk of the world's binary rows (bvh_nodes: bvh_packed
// with its nodes in two float4s), walk_plain's own order and tests.
template <int MODE>
__device__ __forceinline__ void walk_binary(const WalkTables& tb, Ray& r) {
  int idx = 0;
  while (idx < tb.n_bin) {
    float4 lo = __ldg(tb.bin + 2 * idx), hi = __ldg(tb.bin + 2 * idx + 1);
    bool v = visit<MODE>(slab_entry(lo, hi, r.o, r.inv), r);
    int ref = __float2int_rn(lo.w);
    int exit_ = __float2int_rn(hi.w);
    if (ref >= 0) {
      idx = v ? ref : exit_;
      continue;
    }
    idx = exit_;
    if (v) test_leaf<MODE>(tb, -ref - 1, r);
  }
}

// The walk of the 3-slot nodes (bvh_wide) from `node`: a node's passing
// slots are taken in slot order, the first at once and the others from
// the stack, each tested again against the bound when it is taken.
template <int MODE>
__device__ __forceinline__ void walk_wide(const WalkTables& tb, int node,
                                          Ray& r) {
  int2 stack[HK_STACK];
  int sp = 0;
  for (;;) {
    int cur = 0;
    float cur_te = 0.0f;
    bool held = false;
    if (node >= 0) {
      const float4* nd = tb.nodes + 2 * HK_WIDTH * node;
      float4 lo[HK_WIDTH], hi[HK_WIDTH];
#pragma unroll
      for (int k = 0; k < HK_WIDTH; k++) {
        lo[k] = __ldg(nd + 2 * k);
        hi[k] = __ldg(nd + 2 * k + 1);
      }
#pragma unroll
      for (int k = HK_WIDTH - 1; k >= 0; k--) {
        int ref = __float2int_rn(lo[k].w);
        float te = slab_entry(lo[k], hi[k], r.o, r.inv);
        bool pass = ref != 0 && te < r.maxt &&
                    (MODE == MODE_SHADOW || te < r.c.t);
        if (pass) {
          if (held) stack[sp++] = make_int2(cur, __float_as_int(cur_te));
          cur = ref;
          cur_te = te;
          held = true;
        }
      }
      node = -1;
    }
    if (!held) {
      if (sp == 0) return;
      sp--;
      cur = stack[sp].x;
      cur_te = __int_as_float(stack[sp].y);
    }
    if (!visit<MODE>(cur_te, r)) continue;
    if (cur > 0)
      node = cur;
    else
      test_leaf<MODE>(tb, -cur - 1, r);
  }
}

template <int MODE>
__global__ void __launch_bounds__(128)
bvh_kernel(WalkTables tb, const float* __restrict__ ro,
           const float* __restrict__ rd, const float* __restrict__ maxt_in,
           const int* __restrict__ excl_in, const int* __restrict__ incl_in,
           long long n, float* __restrict__ t_out, float* __restrict__ u_out,
           float* __restrict__ v_out, int* __restrict__ prim_out,
           int* __restrict__ inst_out, float* __restrict__ nrm_out,
           float* __restrict__ uv_out, float* __restrict__ mat_out) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Ray r;
  r.o = mk3(ro[3 * i], ro[3 * i + 1], ro[3 * i + 2]);
  r.d = mk3(rd[3 * i], rd[3 * i + 1], rd[3 * i + 2]);
  r.inv = mk3(safe_inv(r.d.x), safe_inv(r.d.y), safe_inv(r.d.z));
  r.maxt = maxt_in[i];
  int incl_i = incl_in[i];
  r.excl = (float)excl_in[i];
  r.incl = (float)incl_i;
  r.c = closest_miss();
  r.b = occluder_none();
  int root = incl_i >= 0 && incl_i < tb.n_inst ? __ldg(tb.sub_root + incl_i)
                                               : 0;
  // one walk per warp: the 3-slot nodes when a ray of the warp has an
  // emitter's subtree (its other rays walk the world's 3-slot nodes from
  // node 0), else the binary rows
  if (__any_sync(__activemask(), root > 0))
    walk_wide<MODE>(tb, root, r);
  else
    walk_binary<MODE>(tb, r);
  const Closest& c = r.c;
  const Occluder& b = r.b;
  if (MODE == MODE_SHADOW) {
    Shadow sh = shadow_result(b);
    t_out[i] = sh.t;
    inst_out[i] = (int)rintf(sh.inst);
    return;
  }
  t_out[i] = c.t;
  prim_out[i] = c.prim;
  inst_out[i] = (int)rintf(c.inst);
  if (MODE == MODE_HIT) {
    u_out[i] = c.u;
    v_out[i] = c.v;
    return;
  }
  f3 nrm = mk3(0.0f, 0.0f, 0.0f);
  float uvx = 0.0f, uvy = 0.0f, mat = -1.0f;
  if (c.prim >= 0) {
    // floats 0-8 normals, 9-14 uvs, 15 instance, 16 material
    const float4* a = tb.attrs + 5 * (long long)c.prim;
    float4 a0 = __ldg(a), a1 = __ldg(a + 1), a2 = __ldg(a + 2),
           a3 = __ldg(a + 3), a4 = __ldg(a + 4);
    nrm = mk3(interp(a0.x, a0.w, a1.z, c.u, c.v),
              interp(a0.y, a1.x, a1.w, c.u, c.v),
              interp(a0.z, a1.y, a2.x, c.u, c.v));
    uvx = interp(a2.y, a2.w, a3.y, c.u, c.v);
    uvy = interp(a2.z, a3.x, a3.z, c.u, c.v);
    mat = a4.x;
  }
  nrm_out[3 * i] = nrm.x;
  nrm_out[3 * i + 1] = nrm.y;
  nrm_out[3 * i + 2] = nrm.z;
  uv_out[2 * i] = uvx;
  uv_out[2 * i + 1] = uvy;
  mat_out[i] = mat;
}

static const int kThreads = 128;

template <int MODE>
static int launch(WalkTables tb, const float* ro, const float* rd,
                  const float* maxt, const int* excl, const int* incl, int n,
                  float* t, float* u, float* v, int* prim, int* inst,
                  float* nrm, float* uv, float* mat, void* stream) {
  if (n == 0) return 0;
  unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  bvh_kernel<MODE><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      tb, ro, rd, maxt, excl, incl, n, t, u, v, prim, inst, nrm, uv, mat);
  return (int)cudaGetLastError();
}

static WalkTables tables(const float* bin, int n_bin, const float* nodes,
                         const int* sub_root, int n_inst, const float* tris,
                         const float* attrs) {
  WalkTables tb;
  tb.bin = reinterpret_cast<const float4*>(bin);
  tb.n_bin = n_bin;
  tb.nodes = reinterpret_cast<const float4*>(nodes);
  tb.sub_root = sub_root;
  tb.n_inst = n_inst;
  tb.tris = reinterpret_cast<const float4*>(tris);
  tb.attrs = reinterpret_cast<const float4*>(attrs);
  return tb;
}

extern "C" int hk_bvh_closest(const float* bin, int n_bin,
                              const float* nodes, const int* sub_root,
                              int n_inst, const float* tris, const float* ro,
                              const float* rd, const float* maxt,
                              const int* excl, const int* incl, int n,
                              float* t, float* u, float* v, int* prim,
                              int* inst, void* stream) {
  return launch<MODE_HIT>(
      tables(bin, n_bin, nodes, sub_root, n_inst, tris, nullptr), ro, rd,
      maxt, excl, incl, n, t, u, v, prim, inst, nullptr, nullptr, nullptr,
      stream);
}

extern "C" int hk_bvh_full(const float* bin, int n_bin, const float* nodes,
                           const int* sub_root, int n_inst, const float* tris,
                           const float* attrs, const float* ro,
                           const float* rd, const float* maxt,
                           const int* excl, const int* incl, int n, float* t,
                           int* prim, float* nrm, float* uv, float* mat,
                           int* inst, void* stream) {
  return launch<MODE_FULL>(
      tables(bin, n_bin, nodes, sub_root, n_inst, tris, attrs), ro, rd, maxt,
      excl, incl, n, t, nullptr, nullptr, prim, inst, nrm, uv, mat, stream);
}

extern "C" int hk_bvh_shadow(const float* bin, int n_bin, const float* nodes,
                             const int* sub_root, int n_inst,
                             const float* tris, const float* ro,
                             const float* rd, const float* maxt,
                             const int* excl, const int* incl, int n,
                             float* t, int* inst, void* stream) {
  return launch<MODE_SHADOW>(
      tables(bin, n_bin, nodes, sub_root, n_inst, tris, nullptr), ro, rd,
      maxt, excl, incl, n, t, nullptr, nullptr, nullptr, inst, nullptr,
      nullptr, nullptr, stream);
}
