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
source serves kernels 5, 6, 7, B and 4. A wrapper runs the plain version.
"""

from __future__ import annotations

import torch

from portbench.reference.hk.ops._kernel import div
from portbench.reference.hk.utils.math import F32_EPSILON, F32_MAX, normalize

DISTANCE_MAX = 65535.0


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


def trace_closest(tris, ro, rd, max_t, excl, incl):
    """Kernel 5: tris [P,10] f32, ro/rd [N,3] f32, max_t [N] f32,
    excl/incl [N] int32. Returns closest_plain's dict."""
    return closest_plain(tris, ro, rd, max_t, excl, incl)


def trace_full(tris, attrs, ro, rd, max_t, excl, incl):
    """Kernel 6: as kernel 5 with attrs [P,17] f32. Returns full_plain's
    dict."""
    return full_plain(tris, attrs, ro, rd, max_t, excl, incl)


def trace_shadow(tris, ro, rd, max_t, excl, incl):
    """Kernel 7: the arguments of kernel 5. Returns shadow_plain's
    dict."""
    return shadow_plain(tris, ro, rd, max_t, excl, incl)


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
