"""Brute-force ray-triangle intersection: kernels 5, 6 and 7
(csrc/trace.cu) and their plain versions.

The port of hikari_tpu/ops/trace_pallas.py, the small-scene engine of the
modular lighting path:

* kernel 5, `trace_closest` (pallas_brute_force): the nearest accepted hit
  (t, u, v, triangle index, instance);
* kernel 6, `trace_full` (pallas_brute_force_full): the same hit with the
  winner's interpolated normal, uv and material;
* kernel 7, `trace_shadow` (pallas_shadow): the nearest occluder (t,
  instance) below max_t, division-free in the loop.

The contract: Moller-Trumbore over the triangle rows [P,10] (v0 v1 v2,
instance; padding rows carry instance -1; any P, as the TPU kernels
stream any table) in index order, a triangle
winning only when strictly nearer, so the lowest index wins a tie; the
masks compare float instance ids: inst >= 0, inst != exclude, and
(include < 0) | (inst == include), so the probe's "no pick" include of -2
accepts every triangle. Kernel 7 multiplies every test by |det| and
compares t_d * |det|_best < t_d,best * |det|, starting from (F32_MAX, 1);
its products overflow to inf as the TPU's do.

The kernel wrappers return the raw per-ray results; `brute_force`,
`brute_force_full` and `shadow` add the TPU wrappers' tails (miss
handling, the hit position, the normalized normal, rounded ids) in
PyTorch, the same for both. The plain versions (`closest_plain`,
`full_plain`, `shadow_plain`) loop over the table one whole-ray operation
at a time in the kernels' order; `closest_sweep` and `shadow_sweep` are
also the triangle loops of light_fused's plain version, so one plain
source serves kernels 5, 6, 7, B and 4. A wrapper runs the plain version
for CPU tensors and launches its kernel for CUDA tensors.
"""

from __future__ import annotations

import struct

import torch

from hikari_tpu_torch.ops._kernel import (bind, check, check_launch, div,
                                          on_cpu, stream)
from hikari_tpu_torch.utils.math import F32_EPSILON, F32_MAX, normalize

DISTANCE_MAX = 65535.0
# the rows each block of kernels 5, 6 and 7 stages at once (csrc/trace.cu
# HK_CHUNK); a larger table is swept chunk by chunk, the running best
# carried across the chunks in index order
CHUNK_ROWS = 768
# csrc/trace.cu TraceCall, kernels 5, 6 and 7's argument table: tris,
# attrs (0 for kernels 5 and 7), ro, rd, max_t, excl, incl, the output
# allocation (pointers); n_tris, n (ints)
TRACE_TABLE = struct.Struct("<8Q2i")
# the output words a ray of kernels 5, 6 and 7 (t, u, v, prim, inst; t,
# prim, normal 3, uv 2, mat, inst; t, inst): the planes of one allocation
CLOSEST_WORDS = 5
FULL_WORDS = 9
SHADOW_WORDS = 2


def _tri_scalars(r):
    """Per-triangle float32 constants of the Moller-Trumbore loop."""
    v0 = r[0:3]
    ab = r[3:6] - v0
    ac = r[6:9] - v0
    return [float(x) for x in (*v0, *ab, *ac)]


def mt_terms(o, d, v0, ab, ac):
    """Moller-Trumbore terms (common.cuh edge_terms): (det, u numerator, v
    numerator, t numerator). o, d: (x, y, z) ray planes; v0, ab, ac:
    (x, y, z) of the first vertex and the two edges, floats or planes."""
    v0x, v0y, v0z = v0
    abx, aby, abz = ab
    acx, acy, acz = ac
    ox, oy, oz = o
    dx, dy, dz = d
    ux = dy * acz - dz * acy
    uy = dz * acx - dx * acz
    uz = dx * acy - dy * acx
    det = ux * abx + uy * aby + uz * abz
    aox, aoy, aoz = ox - v0x, oy - v0y, oz - v0z
    uu = aox * ux + aoy * uy + aoz * uz
    vx = aoy * abz - aoz * aby
    vy = aoz * abx - aox * abz
    vz = aox * aby - aoy * abx
    vv = dx * vx + dy * vy + dz * vz
    dist = vx * acx + vy * acy + vz * acz
    return det, uu, vv, dist


def _mt(o, d, r):
    """mt_terms of one numpy f32 triangle row over whole ray planes."""
    s = _tri_scalars(r)
    return mt_terms(o, d, s[0:3], s[3:6], s[6:9])


def _accepts(inst_i, excl, incl):
    """The instance masks of a triangle (inst_i >= 0 is checked by the
    caller): a bool plane, or True when no mask applies."""
    ok = excl != inst_i
    if incl is not None:
        ok = ok & ((incl < 0.0) | (incl == inst_i))
    return ok


def closest_accept(terms, maxt, t_best):
    """The nearest-hit test of one triangle (csrc/trace.cu near_test, in
    the form proved there): (accepted, u, v, t). A hit is taken only when
    strictly nearer."""
    det, uu, vv, dist = terms
    inv_det = torch.where(torch.abs(det) < F32_EPSILON, 0.0, div(1.0, det))
    u = uu * inv_det
    v = vv * inv_det
    dist = dist * inv_det
    ok = ((torch.abs(det) >= F32_EPSILON)
          & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0)
          & (dist > F32_EPSILON) & (dist < maxt) & (dist < t_best))
    return ok, u, v, dist


def shadow_accept(terms, maxt, td_best, ads_best):
    """The division-free occluder test of one triangle (csrc/trace.cu
    occluder_test): (accepted, t numerator * sign, |det|)."""
    det, uu, vv, dist = terms
    s = torch.sign(det)
    ads = det * s
    ud = uu * s
    vd = vv * s
    td = dist * s
    ok = ((ads >= F32_EPSILON) & (ud >= 0.0) & (vd >= 0.0)
          & (ud + vd <= ads) & (td > F32_EPSILON * ads)
          & (td < maxt * ads) & (td * ads_best < td_best * ads))
    return ok, td, ads


def closest_sweep(tris, o, d, maxt, excl, incl=None):
    """Nearest accepted hit over numpy f32 rows tris [P,10] in index order.
    o, d: (x, y, z) ray planes; maxt, excl, incl: planes or scalars (incl
    None accepts every instance). Returns float planes (t, u, v, prim,
    inst); a miss has t = F32_MAX, u = v = 0, prim = inst = -1."""
    shape, dev = o[0].shape, o[0].device
    t_best = torch.full(shape, F32_MAX, device=dev)
    u_best = torch.zeros(shape, device=dev)
    v_best = torch.zeros(shape, device=dev)
    prim = torch.full(shape, -1.0, device=dev)
    inst = torch.full(shape, -1.0, device=dev)
    for i, r in enumerate(tris):
        inst_i = float(r[9])
        if not inst_i >= 0.0:
            continue
        ok, u, v, dist = closest_accept(_mt(o, d, r), maxt, t_best)
        ok = ok & _accepts(inst_i, excl, incl)
        t_best = torch.where(ok, dist, t_best)
        u_best = torch.where(ok, u, u_best)
        v_best = torch.where(ok, v, v_best)
        prim = torch.where(ok, float(i), prim)
        inst = torch.where(ok, inst_i, inst)
    return t_best, u_best, v_best, prim, inst


def interpolate(attrs, prim, u, v):
    """The winner's attributes from attrs [P,17] (normals 0:9, uvs 9:15,
    material 16) at the triangle indices `prim` (-1: a miss): (normal xyz
    unnormalized, uv, material), zeros and material -1 on a miss (a0 + u *
    (a1 - a0) + v * (a2 - a0), as kernel 6)."""
    hit = prim >= 0
    a = attrs[torch.clamp(prim.long(), min=0)]

    def lerp(c0, c1, c2):
        return torch.where(hit, a[..., c0] + u * (a[..., c1] - a[..., c0])
                           + v * (a[..., c2] - a[..., c0]), 0.0)

    normal = tuple(lerp(c, c + 3, c + 6) for c in range(3))
    uv = (lerp(9, 11, 13), lerp(10, 12, 14))
    return normal, uv, torch.where(hit, a[..., 16], -1.0)


def trace_full_sweep(tris, attrs, o, d, maxt, excl, incl=None):
    """Nearest hit with normal and material over numpy f32 tables tris
    [P,10], attrs [P,17]. Returns (t, (nx, ny, nz) unnormalized, mat, inst);
    a miss has inst -1."""
    t, u, v, prim, inst = closest_sweep(tris, o, d, maxt, excl, incl)
    attrs_t = torch.as_tensor(attrs, device=t.device)
    normal, _, mat = interpolate(attrs_t, prim, u, v)
    return t, normal, mat, inst


def shadow_sweep(tris, o, d, maxt, excl, incl=None):
    """The division-free nearest-occluder loop over numpy f32 rows tris
    [P,10]. Returns (occluded, t, inst): t = t_d / |det| of the nearest
    accepted hit, F32_MAX and inst -1 where none."""
    shape, dev = o[0].shape, o[0].device
    td_best = torch.full(shape, F32_MAX, device=dev)
    ads_best = torch.ones(shape, device=dev)
    inst_best = torch.full(shape, -1.0, device=dev)
    for r in tris:
        inst_i = float(r[9])
        if not inst_i >= 0.0:
            continue
        ok, td, ads = shadow_accept(_mt(o, d, r), maxt, td_best, ads_best)
        ok = ok & _accepts(inst_i, excl, incl)
        td_best = torch.where(ok, td, td_best)
        ads_best = torch.where(ok, ads, ads_best)
        inst_best = torch.where(ok, inst_i, inst_best)
    occluded = inst_best >= 0.0
    t = torch.where(occluded, div(td_best, ads_best), F32_MAX)
    return occluded, t, inst_best


# ---------------------------------------------------------------------------
# kernels 5, 6, 7: plain versions and wrappers (raw per-ray results)
# ---------------------------------------------------------------------------

def _rays(ro, rd, max_t, excl, incl):
    return (ro.unbind(-1), rd.unbind(-1), max_t, excl.to(torch.float32),
            incl.to(torch.float32))


def _ids(f):
    return torch.round(f).to(torch.int32)


def closest_plain(tris, ro, rd, max_t, excl, incl):
    """Kernel 5's plain version: {t, u, v, prim, inst} (ids int32)."""
    t, u, v, prim, inst = closest_sweep(tris.cpu().numpy(),
                                        *_rays(ro, rd, max_t, excl, incl))
    return {"t": t, "u": u, "v": v, "prim": prim.to(torch.int32),
            "inst": _ids(inst)}


def full_plain(tris, attrs, ro, rd, max_t, excl, incl):
    """Kernel 6's plain version: {t, prim, normal [N,3] unnormalized, uv
    [N,2], mat (float id, -1 on a miss), inst}."""
    t, u, v, prim, inst = closest_sweep(tris.cpu().numpy(),
                                        *_rays(ro, rd, max_t, excl, incl))
    normal, uv, mat = interpolate(attrs, prim, u, v)
    return {"t": t, "prim": prim.to(torch.int32),
            "normal": torch.stack(normal, -1), "uv": torch.stack(uv, -1),
            "mat": mat, "inst": _ids(inst)}


def shadow_plain(tris, ro, rd, max_t, excl, incl):
    """Kernel 7's plain version: {t, inst}."""
    _, t, inst = shadow_sweep(tris.cpu().numpy(),
                              *_rays(ro, rd, max_t, excl, incl))
    return {"t": t, "inst": _ids(inst)}


def _check_rays(tris, ro, rd, max_t, excl, incl, attrs=None):
    """(device, n) of a tracer call (attrs: kernel 6's table, or None), or
    raises naming the first bad argument. The common case is one
    expression (host time counts)."""
    dev = ro.device
    n = ro.shape[0]
    f32 = torch.float32
    if ((attrs is None or (attrs.dtype == f32
                           and attrs.shape == (tris.shape[0], 17)
                           and attrs.device == dev
                           and attrs.is_contiguous()))
            and ro.dtype == rd.dtype == max_t.dtype == tris.dtype == f32
            and excl.dtype == incl.dtype == torch.int32
            and ro.shape == rd.shape == (n, 3)
            and max_t.shape == excl.shape == incl.shape == (n,)
            and tris.dim() == 2 and tris.shape[1] == 10
            and tris.shape[0] * 17 < 2 ** 31
            and tris.device == rd.device == max_t.device == excl.device
            == incl.device == dev
            and tris.is_contiguous() and ro.is_contiguous()
            and rd.is_contiguous() and max_t.is_contiguous()
            and excl.is_contiguous() and incl.is_contiguous()):
        return dev, n
    check("tris", tris, torch.float32, (tris.shape[0], 10), dev)
    if tris.shape[0] * 17 >= 2 ** 31:
        raise ValueError(f"{tris.shape[0]} triangles: the kernels index "
                         "them in 32 bits")
    check("ro", ro, torch.float32, (n, 3), dev)
    check("rd", rd, torch.float32, (n, 3), dev)
    check("max_t", max_t, torch.float32, (n,), dev)
    check("excl", excl, torch.int32, (n,), dev)
    check("incl", incl, torch.int32, (n,), dev)
    if attrs is not None:
        check("attrs", attrs, torch.float32, (tris.shape[0], 17), dev)
    return dev, n


def _load():
    from hikari_tpu_torch.build import load_cuda

    return load_cuda("trace")


def closest_views(buf, n):
    """Kernel 5's outputs as views of its allocation buf [5 n] f32 (the
    kernel's planes, in order): {t, u, v, prim (int32), inst (int32)}."""
    f, i = buf.as_strided, buf.view(torch.int32).as_strided
    return {"t": f((n,), (1,), 0), "u": f((n,), (1,), n),
            "v": f((n,), (1,), 2 * n), "prim": i((n,), (1,), 3 * n),
            "inst": i((n,), (1,), 4 * n)}


def full_views(buf, n):
    """Kernel 6's outputs as views of its allocation buf [9 n] f32 (the
    kernel's planes, in order): {t, prim (int32), normal [n,3], uv [n,2],
    mat, inst (int32)}. as_strided, the cheapest view on the host."""
    f, i = buf.as_strided, buf.view(torch.int32).as_strided
    return {"t": f((n,), (1,), 0), "prim": i((n,), (1,), n),
            "normal": f((n, 3), (3, 1), 2 * n),
            "uv": f((n, 2), (2, 1), 5 * n), "mat": f((n,), (1,), 7 * n),
            "inst": i((n,), (1,), 8 * n)}


def shadow_views(buf, n):
    """Kernel 7's outputs as views of its allocation buf [2 n] f32: {t,
    inst (int32)}."""
    return {"t": buf.as_strided((n,), (1,), 0),
            "inst": buf.view(torch.int32).as_strided((n,), (1,), n)}


def _launch(name, tris, attrs, ro, rd, max_t, excl, incl, words, views):
    """Kernels 5, 6 and 7's CUDA branch: one output allocation of `words` a
    ray, one packed table (TRACE_TABLE); n = 0 launches nothing. Returns
    views(allocation, n)."""
    dev, n = _check_rays(tris, ro, rd, max_t, excl, incl, attrs)
    if n * FULL_WORDS >= 2 ** 31:
        raise ValueError(f"{n} rays: the kernels index them in 32 bits")
    buf = torch.empty(words * n, dtype=torch.float32, device=dev)
    if n:
        table = TRACE_TABLE.pack(
            tris.data_ptr(), 0 if attrs is None else attrs.data_ptr(),
            ro.data_ptr(), rd.data_ptr(), max_t.data_ptr(), excl.data_ptr(),
            incl.data_ptr(), buf.data_ptr(), tris.shape[0], n)
        check_launch(bind(_load(), name, "tp")(table, stream(dev)), name)
    return views(buf, n)


def trace_closest(tris, ro, rd, max_t, excl, incl):
    """Kernel 5: tris [P,10] f32, ro/rd [N,3] f32, max_t [N] f32,
    excl/incl [N] int32. Returns closest_plain's dict; runs it for CPU
    tensors and launches hk_trace_closest for CUDA tensors (its outputs
    views of one allocation, closest_views)."""
    if on_cpu(ro):
        return closest_plain(tris, ro, rd, max_t, excl, incl)
    out = _launch("hk_trace_closest", tris, None, ro, rd, max_t, excl, incl,
                  CLOSEST_WORDS, closest_views)
    if ro.shape[0]:
        trace_closest.launches += 1
    return out


trace_closest.launches = 0


def trace_full(tris, attrs, ro, rd, max_t, excl, incl):
    """Kernel 6: as kernel 5 with attrs [P,17] f32. Returns full_plain's
    dict; runs it for CPU tensors and launches hk_trace_full for CUDA
    tensors (its outputs views of one allocation, full_views)."""
    if on_cpu(ro):
        return full_plain(tris, attrs, ro, rd, max_t, excl, incl)
    out = _launch("hk_trace_full", tris, attrs, ro, rd, max_t, excl, incl,
                  FULL_WORDS, full_views)
    if ro.shape[0]:
        trace_full.launches += 1
    return out


trace_full.launches = 0


def trace_shadow(tris, ro, rd, max_t, excl, incl):
    """Kernel 7: the arguments of kernel 5. Returns shadow_plain's dict;
    runs it for CPU tensors and launches hk_trace_shadow for CUDA tensors
    (its outputs views of one allocation, shadow_views)."""
    if on_cpu(ro):
        return shadow_plain(tris, ro, rd, max_t, excl, incl)
    out = _launch("hk_trace_shadow", tris, None, ro, rd, max_t, excl, incl,
                  SHADOW_WORDS, shadow_views)
    if ro.shape[0]:
        trace_shadow.launches += 1
    return out


trace_shadow.launches = 0


# ---------------------------------------------------------------------------
# the TPU wrappers' contracts
# ---------------------------------------------------------------------------

def brute_force(tris, ro, rd, max_t, excl, incl):
    """pallas_brute_force: {t (F32_MAX on a miss), u, v, prim, instance}
    (ids int32, -1 on a miss)."""
    raw = trace_closest(tris, ro, rd, max_t, excl, incl)
    return {"t": raw["t"], "u": raw["u"], "v": raw["v"], "prim": raw["prim"],
            "instance": raw["inst"]}


def hit_position(ro, rd, t, miss):
    """[N,4]: ro + rd * t (DISTANCE_MAX on a miss), w = 1 on a hit."""
    tt = torch.where(miss, DISTANCE_MAX, t)
    pos = ro + rd * tt[:, None]
    return torch.cat([pos, torch.where(miss, 0.0, 1.0)[:, None]], -1)


def full_info(raw, ro, rd):
    """The hit-info contract of a full-mode trace's raw outputs (kernels 6
    and 13): {t, prim, instance, position [N,4], normal (normalized), uv,
    material} (zeros and -1 on a miss)."""
    miss = raw["prim"] < 0
    return {
        "t": raw["t"], "prim": raw["prim"], "instance": raw["inst"],
        "position": hit_position(ro, rd, raw["t"], miss),
        # a miss's raw normal and uv are zeros, and stay zeros
        "normal": normalize(raw["normal"]), "uv": raw["uv"],
        "material": torch.where(miss, -1, _ids(raw["mat"])),
    }


def brute_force_full(tris, attrs, ro, rd, max_t, excl, incl):
    """pallas_brute_force_full: full_info of kernel 6's hit."""
    return full_info(trace_full(tris, attrs, ro, rd, max_t, excl, incl),
                     ro, rd)


def shadow(tris, ro, rd, max_t, excl, incl):
    """pallas_shadow: {t (F32_MAX where nothing occludes), instance}; the
    TPU wrapper's u/v/prim placeholders are left out (no consumer reads
    them)."""
    raw = trace_shadow(tris, ro, rd, max_t, excl, incl)
    return {"t": raw["t"], "instance": raw["inst"]}
