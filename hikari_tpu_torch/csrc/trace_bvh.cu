// Kernel 13: the tracer of scenes above 768 triangles, a per-thread
// stackless walk of the world BVH, in three modes.
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
// gather. On Hopper each thread gathers freely, so this is the reference's
// own walk (light.wgsl:400-486, hikari_tpu/ops/trace.py:traverse_bvh): ray i
// is thread i and walks the rows of bvh_packed [min3, max3, is_leaf,
// payload, exit] from node 0. A node is visited when its slab entry t (with
// make_ray's safe inverse, +-1e-20) is below the current bound; a leaf tests
// its one triangle `payload`; the next node is the first child `payload`
// after an inner node's hit, else `exit`. The bound is min(max_t, nearest
// t) in the hit modes (t_best starts at F32_MAX and every test also needs t
// < max_t), and in shadow mode aabb_t < max_t and aabb_t * |det|_best <
// t_d,best, so the walk divides nowhere. Ties go to the first triangle in
// walk order.
//
// Triangles are tested by common.cuh's closest_tri / shadow_tri, the
// Moller-Trumbore routine of kernels A, 8, B, 4, 5, 6 and 7; the full mode
// interpolates the winner's attribute row once after the walk with kernel
// 6's expressions.
//
// Bound on the H100: the work depends on the data (node visits and
// triangle tests of each ray), ~30 flops per slab test and 60 per
// triangle test; on the city (5,235 nodes) a 1080p primary call of
// 2,073,600 rays is bound by its operations. This first version reads the
// tables (bvh 188 KB, triangles 105 KB, attributes 178 KB on the city)
// through the read-only cache, one node row per step; shared-memory
// staging, a float4 node layout and ray sorting are later work.

#include "common.cuh"

#define HK_NODE 9   // bvh_packed row: min3 max3 is_leaf payload exit
#define HK_ATTR 17  // tri_attr row: normals 9, uvs 6, instance, material

enum { MODE_HIT = 0, MODE_FULL = 1, MODE_SHADOW = 2 };

// make_ray's safe inverse direction (trace.py:44-48)
__device__ __forceinline__ float safe_inv(float d) {
  float s = fabsf(d) < 1e-20f ? (d < 0.0f ? -1e-20f : 1e-20f) : d;
  return 1.0f / s;
}

// intersects_aabb (light.wgsl:344-362): the entry t, F32_MAX on a miss
__device__ __forceinline__ float slab_entry(const float* nd, f3 o, f3 inv) {
  float t1x = (__ldg(nd + 0) - o.x) * inv.x;
  float t1y = (__ldg(nd + 1) - o.y) * inv.y;
  float t1z = (__ldg(nd + 2) - o.z) * inv.z;
  float t2x = (__ldg(nd + 3) - o.x) * inv.x;
  float t2y = (__ldg(nd + 4) - o.y) * inv.y;
  float t2z = (__ldg(nd + 5) - o.z) * inv.z;
  float t_min = fmaxf(fmaxf(fminf(t1x, t2x), fminf(t1y, t2y)),
                      fminf(t1z, t2z));
  float t_max = fminf(fminf(fmaxf(t1x, t2x), fmaxf(t1y, t2y)),
                      fmaxf(t1z, t2z));
  bool hit = t_max >= t_min && t_max >= 0.0f;
  return hit ? t_min : HK_F32_MAX;
}

template <int MODE>
__global__ void __launch_bounds__(128)
bvh_kernel(const float* __restrict__ bvh, int n_nodes,
           const float* __restrict__ tris, const float* __restrict__ attrs,
           const float* __restrict__ ro, const float* __restrict__ rd,
           const float* __restrict__ maxt_in, const int* __restrict__ excl_in,
           const int* __restrict__ incl_in, long long n,
           float* __restrict__ t_out, float* __restrict__ u_out,
           float* __restrict__ v_out, int* __restrict__ prim_out,
           int* __restrict__ inst_out, float* __restrict__ nrm_out,
           float* __restrict__ uv_out, float* __restrict__ mat_out) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  f3 o = mk3(ro[3 * i], ro[3 * i + 1], ro[3 * i + 2]);
  f3 d = mk3(rd[3 * i], rd[3 * i + 1], rd[3 * i + 2]);
  f3 inv = mk3(safe_inv(d.x), safe_inv(d.y), safe_inv(d.z));
  float maxt = maxt_in[i];
  float excl = (float)excl_in[i];
  float incl = (float)incl_in[i];
  Closest c = closest_miss();
  Occluder b = occluder_none();
  float r[HK_TRI];
  int idx = 0;
  while (idx < n_nodes) {
    const float* nd = bvh + (long long)HK_NODE * idx;
    float te = slab_entry(nd, o, inv);
    bool visit = MODE == MODE_SHADOW
                     ? (te < maxt && te * b.ads < b.td)
                     : (te < maxt && te < c.t);
    bool leaf = __ldg(nd + 6) > 0.5f;
    int payload = (int)rintf(__ldg(nd + 7));
    int exit_ = (int)rintf(__ldg(nd + 8));
    if (leaf) {
      if (visit) {
        const float* row = tris + (long long)HK_TRI * payload;
#pragma unroll
        for (int k = 0; k < HK_TRI; k++) r[k] = __ldg(row + k);
        if (MODE == MODE_SHADOW)
          shadow_tri(r, o, d, maxt, excl, incl, b);
        else
          closest_tri(r, payload, o, d, maxt, excl, incl, c);
      }
      idx = exit_;
    } else {
      idx = visit ? payload : exit_;
    }
  }
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
    const float* a = attrs + (long long)HK_ATTR * c.prim;
    nrm = mk3(interp(__ldg(a + 0), __ldg(a + 3), __ldg(a + 6), c.u, c.v),
              interp(__ldg(a + 1), __ldg(a + 4), __ldg(a + 7), c.u, c.v),
              interp(__ldg(a + 2), __ldg(a + 5), __ldg(a + 8), c.u, c.v));
    uvx = interp(__ldg(a + 9), __ldg(a + 11), __ldg(a + 13), c.u, c.v);
    uvy = interp(__ldg(a + 10), __ldg(a + 12), __ldg(a + 14), c.u, c.v);
    mat = __ldg(a + 16);
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
static int launch(const float* bvh, int n_nodes, const float* tris,
                  const float* attrs, const float* ro, const float* rd,
                  const float* maxt, const int* excl, const int* incl, int n,
                  float* t, float* u, float* v, int* prim, int* inst,
                  float* nrm, float* uv, float* mat, void* stream) {
  if (n == 0) return 0;
  unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  bvh_kernel<MODE><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      bvh, n_nodes, tris, attrs, ro, rd, maxt, excl, incl, n, t, u, v, prim,
      inst, nrm, uv, mat);
  return (int)cudaGetLastError();
}

extern "C" int hk_bvh_closest(const float* bvh, int n_nodes,
                              const float* tris, const float* ro,
                              const float* rd, const float* maxt,
                              const int* excl, const int* incl, int n,
                              float* t, float* u, float* v, int* prim,
                              int* inst, void* stream) {
  return launch<MODE_HIT>(bvh, n_nodes, tris, nullptr, ro, rd, maxt, excl,
                          incl, n, t, u, v, prim, inst, nullptr, nullptr,
                          nullptr, stream);
}

extern "C" int hk_bvh_full(const float* bvh, int n_nodes, const float* tris,
                           const float* attrs, const float* ro,
                           const float* rd, const float* maxt,
                           const int* excl, const int* incl, int n, float* t,
                           int* prim, float* nrm, float* uv, float* mat,
                           int* inst, void* stream) {
  return launch<MODE_FULL>(bvh, n_nodes, tris, attrs, ro, rd, maxt, excl,
                           incl, n, t, nullptr, nullptr, prim, inst, nrm, uv,
                           mat, stream);
}

extern "C" int hk_bvh_shadow(const float* bvh, int n_nodes,
                             const float* tris, const float* ro,
                             const float* rd, const float* maxt,
                             const int* excl, const int* incl, int n,
                             float* t, int* inst, void* stream) {
  return launch<MODE_SHADOW>(bvh, n_nodes, tris, nullptr, ro, rd, maxt,
                             excl, incl, n, t, nullptr, nullptr, nullptr,
                             inst, nullptr, nullptr, nullptr, stream);
}
