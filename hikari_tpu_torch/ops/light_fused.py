"""No-reuse lighting: kernel B (csrc/light_fused.cu) and its plain version.

The port of hikari_tpu/ops/light_fused.py with temporal=False: for every
pixel, the direct (solar NEE), emissive (emissive-BVH walk, alias pick,
probe, shadow) and indirect (cosine bounces with NEE) channels, shaded
with the Burley/GGX chain of light.wgsl. `fused_lighting` keeps the TPU
wrapper's contract: render-res G-buffer dict + [h,w,4] blue noise in,
{d,e,i}_render [h,w,4] (rgb + valid alpha) out, for the channels present.

`lighting_plain` is the kernel body transcribed to whole-plane tensor
operations, one operation at a time in the kernel's order. The wrapper
`lighting_kernel` runs it for CPU tensors and launches the CUDA kernel for
CUDA tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from hikari_tpu_torch.ops._kernel import (bind, check, check_launch, div, f32,
                                          host_values, on_cpu, ptr, stream)
from hikari_tpu_torch.utils.math import (F32_EPSILON, F32_MAX, GOLDEN_RATIO,
                                         INV_TAU, PI, TAU)

DISTANCE_MAX = 65535.0
RAY_BIAS = 0.02
_TWO_INV_TAU = f32(2.0 * INV_TAU)
_INV_PI = f32(1.0 / PI)

# eligibility caps of hikari_tpu's fused kernels
MAX_TRIS = 768
MAX_EMISSIVES = 8
MAX_ALIAS_SLOTS = 64
MAX_EM_TRIS = 32
MAX_MATERIALS = 16

# ---- parameter vector layout (hikari_tpu's _P_* offsets, without the
# 128-lane rows: alias slots follow the emissive blocks)
_P_DIRL = 0        # dir_to_light xyz
_P_DIRC = 3        # dir_color rgb
_P_AMB = 6         # ambient rgb
_P_COS_SOLAR = 9
_P_CAM = 10        # camera world position xyz
_P_MAX_IND = 13    # max_indirect_luminance
_P_ADV = 14        # frame_number * GOLDEN_RATIO
#                    (15: the temporal kernel's reuse cap; unused here)
_P_EM = 16         # per-emissive stride-10 block (leaf order):
#                    cx cy cz radius inst alias_off alias_count area tri_off 0
_EM_STRIDE = 10
_P_ALIAS = 96      # alias slots (prob, alias) pairs
_P_COUNT = 224


def lighting_caps_error(scene, num_emissives: int):
    """The reason the scene exceeds the kernel's caps, or None."""
    if scene["tri_pos_flat"].shape[0] > MAX_TRIS:
        return f"{scene['tri_pos_flat'].shape[0]} triangles > {MAX_TRIS}"
    if scene["mat_packed"].shape[0] > MAX_MATERIALS:
        return f"{scene['mat_packed'].shape[0]} materials > {MAX_MATERIALS}"
    if num_emissives > 0:
        if scene["em_packed"].shape[0] > MAX_EMISSIVES:
            return f"{scene['em_packed'].shape[0]} emissives > {MAX_EMISSIVES}"
        if scene["alias_packed"].shape[0] > MAX_ALIAS_SLOTS:
            return (f"{scene['alias_packed'].shape[0]} alias slots > "
                    f"{MAX_ALIAS_SLOTS}")
        if scene["em_tri_pos_flat"].shape[0] > MAX_EM_TRIS:
            return (f"{scene['em_tri_pos_flat'].shape[0]} emissive "
                    f"triangles > {MAX_EM_TRIS}")
    return None


def pack_params(scene, view, frame, n_em: int) -> torch.Tensor:
    """[224] f32 parameter vector on the scene's device."""
    dev = scene["dir_to_light"].device
    cos_solar = np.cos(np.float32(frame["solar_angle"]))
    adv = np.float32(frame["number"]) * np.float32(GOLDEN_RATIO)
    host = host_values([cos_solar, frame["max_indirect_luminance"], adv,
                        0.0], dev)
    head = torch.cat([
        scene["dir_to_light"][:3], scene["dir_color"][:3],
        scene["ambient_color"][:3], host[:1], view["world_position"][:3],
        host[1:]])
    em = torch.zeros(_P_ALIAS - _P_EM, dtype=torch.float32, device=dev)
    alias = torch.zeros(_P_COUNT - _P_ALIAS, dtype=torch.float32, device=dev)
    if n_em > 0:
        order = scene["em_leaf_order"][:n_em].long()
        rows = scene["em_packed"][order]                # [E,12] leaf order
        inst = torch.round(rows[:, 8]).long()
        tri_off = scene["em_inst_tri_offset_f"][inst]
        block = torch.stack([rows[:, 4], rows[:, 5], rows[:, 6], rows[:, 7],
                             rows[:, 8], rows[:, 9], rows[:, 10], rows[:, 11],
                             tri_off, torch.zeros_like(tri_off)], 1)
        em[:_EM_STRIDE * n_em] = block.reshape(-1)
        flat = scene["alias_packed"].reshape(-1)
        alias[:flat.numel()] = flat
    return torch.cat([head, em, alias])


# ---------------------------------------------------------------------------
# plain version: component-form tensor math (same operand order as the
# kernel; scalars from the tables are float32 values)
# ---------------------------------------------------------------------------

def _rsqrt_n(x, y, z):
    inv = torch.rsqrt(torch.clamp(x * x + y * y + z * z, min=1e-20))
    return x * inv, y * inv, z * inv


def _dot(ax, ay, az, bx, by, bz):
    return ax * bx + ay * by + az * bz


def _lum(r, g, b):
    return 0.2126 * r + 0.7152 * g + 0.0722 * b


def _pow5(x):
    x2 = x * x
    return x2 * x2 * x


def _onb_apply(nx, ny, nz, lx, ly, lz):
    """apply_normal_basis (utils.wgsl:42-50), component form."""
    s = torch.clamp(torch.sign(nz) * 2.0 + 1.0, max=1.0)
    u = div(-1.0, s + nz)
    v = nx * ny * u
    tx = 1.0 + s * nx * nx * u
    ty = s * v
    tz = -s * nx
    bx = v
    by = s + ny * ny * u
    bz = -ny
    return (tx * lx + bx * ly + nx * lz,
            ty * lx + by * ly + ny * lz,
            tz * lx + bz * ly + nz * lz)


def _env_brdf_approx(f0r, f0g, f0b, pr, nov):
    """Karis EnvBRDFApprox, component form."""
    r0 = 1.0 - pr
    r1 = 0.0425 - 0.0275 * pr
    r2 = 1.04 - 0.572 * pr
    r3 = 0.022 * pr - 0.04
    a004 = torch.minimum(r0 * r0, torch.exp2(-9.28 * nov)) * r0 + r1
    ab_x = -1.04 * a004 + r2
    ab_y = 1.04 * a004 + r3
    return f0r * ab_x + ab_y, f0g * ab_x + ab_y, f0b * ab_x + ab_y


def _row_index(f, n: int):
    """Row of a float id in an n-row table: the id itself when it is an
    integer in [0, n), else 0 (hikari_tpu's select-sweep default)."""
    i = f.to(torch.int64)
    ok = (i >= 0) & (i < n) & (i.to(f.dtype) == f)
    return torch.where(ok, i, torch.zeros_like(i))


class _Surface:
    """Per-pixel surface fields + derived f0/diffuse from material rows."""

    def __init__(self, mats, mat_f):
        row = mats[_row_index(mat_f, mats.shape[0])]
        br, bg, bb = row[..., 0], row[..., 1], row[..., 2]
        self.em = (row[..., 4], row[..., 5], row[..., 6], row[..., 7])
        clamped = torch.clamp(row[..., 8], 0.089, 1.0)
        self.rough = clamped * clamped
        metal, refl = row[..., 9], row[..., 10]
        f = 0.16 * refl * refl * (1.0 - metal)
        self.f0 = (f + br * metal, f + bg * metal, f + bb * metal)
        self.diff = (br * (1.0 - metal), bg * (1.0 - metal),
                     bb * (1.0 - metal))


def _shade(surf, amb, vx, vy, vz, nx, ny, nz, lx, ly, lz,
           rad_r, rad_g, rad_b, rad_a):
    """shading() (light.wgsl:869-888): lit*a + ambient*(1-a)."""
    hx, hy, hz = _rsqrt_n(lx + vx, ly + vy, lz + vz)
    nol = torch.clamp(_dot(nx, ny, nz, lx, ly, lz), 0.0, 1.0)
    noh = torch.clamp(_dot(nx, ny, nz, hx, hy, hz), 0.0, 1.0)
    loh = torch.clamp(_dot(lx, ly, lz, hx, hy, hz), 0.0, 1.0)
    nov = torch.clamp(_dot(nx, ny, nz, vx, vy, vz), min=0.0001)
    rough = surf.rough
    f90 = 0.5 + 2.0 * rough * loh * loh
    fd = ((1.0 + (f90 - 1.0) * _pow5(1.0 - nol))
          * (1.0 + (f90 - 1.0) * _pow5(1.0 - nov)) * _INV_PI)
    one_minus = 1.0 - noh * noh
    a_ = noh * rough
    k = div(rough, one_minus + a_ * a_)
    d = k * k * _INV_PI
    a2 = rough * rough
    lam_v = nol * torch.sqrt((nov - a2 * nov) * nov + a2)
    lam_l = nov * torch.sqrt((nol - a2 * nol) * nol + a2)
    vis = div(0.5, torch.clamp(lam_v + lam_l, min=1e-7))
    dv = d * vis
    f0r, f0g, f0b = surf.f0
    fr90 = torch.clamp((f0r + f0g + f0b) * 16.5, 0.0, 1.0)
    sch = _pow5(1.0 - loh)
    fr = f0r + (fr90 - f0r) * sch
    fg = f0g + (fr90 - f0g) * sch
    fb = f0b + (fr90 - f0b) * sch
    dr, dg, db = surf.diff
    lit_r = (dv * fr + dr * fd) * rad_r * nol
    lit_g = (dv * fg + dg * fd) * rad_g * nol
    lit_b = (dv * fb + db * fd) * rad_b * nol
    da_r, da_g, da_b = _env_brdf_approx(dr, dg, db, torch.ones_like(nov), nov)
    sa_r, sa_g, sa_b = _env_brdf_approx(f0r, f0g, f0b, rough, nov)
    am_r = (da_r + sa_r) * amb[0]
    am_g = (da_g + sa_g) * amb[1]
    am_b = (da_b + sa_b) * amb[2]
    one_m = 1.0 - rad_a
    return (lit_r * rad_a + am_r * one_m,
            lit_g * rad_a + am_g * one_m,
            lit_b * rad_a + am_b * one_m)


def _tri_scalars(r):
    """Per-triangle float32 constants of the Moller-Trumbore loop."""
    v0 = r[0:3]
    ab = r[3:6] - v0
    ac = r[6:9] - v0
    return [float(x) for x in (*v0, *ab, *ac)]


def _mt(o, d, r):
    """Shared Moller-Trumbore terms for one triangle row (numpy f32)."""
    v0x, v0y, v0z, abx, aby, abz, acx, acy, acz = _tri_scalars(r)
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


def trace_full_sweep(tris, attrs, o, d, maxt, excl, incl):
    """Nearest hit with normal/material interpolation over numpy f32 rows
    tris [T,10], attrs [T,17]. Returns (t, (nx, ny, nz) unnormalized, mat,
    inst); a miss has inst -1."""
    shape, dev = o[0].shape, o[0].device
    t_best = torch.full(shape, F32_MAX, device=dev)
    nx = torch.zeros(shape, device=dev)
    ny = torch.zeros(shape, device=dev)
    nz = torch.zeros(shape, device=dev)
    mat = torch.full(shape, -1.0, device=dev)
    inst = torch.full(shape, -1.0, device=dev)
    for r, a in zip(tris, attrs):
        inst_i = float(r[9])
        if not inst_i >= 0.0:
            continue
        det, uu, vv, dist = _mt(o, d, r)
        inv_det = torch.where(torch.abs(det) < F32_EPSILON, 0.0, div(1.0, det))
        u = uu * inv_det
        v = vv * inv_det
        dist = dist * inv_det
        ok = ((torch.abs(det) >= F32_EPSILON)
              & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0)
              & (dist > F32_EPSILON) & (dist < maxt) & (dist < t_best)
              & (excl != inst_i) & ((incl < 0.0) | (incl == inst_i)))
        a = [float(x) for x in a]
        d1 = [f32(np.float32(a[c + 3]) - np.float32(a[c])) for c in range(3)]
        d2 = [f32(np.float32(a[c + 6]) - np.float32(a[c])) for c in range(3)]
        t_best = torch.where(ok, dist, t_best)
        nx = torch.where(ok, a[0] + u * d1[0] + v * d2[0], nx)
        ny = torch.where(ok, a[1] + u * d1[1] + v * d2[1], ny)
        nz = torch.where(ok, a[2] + u * d1[2] + v * d2[2], nz)
        mat = torch.where(ok, a[16], mat)
        inst = torch.where(ok, inst_i, inst)
    return t_best, (nx, ny, nz), mat, inst


def shadow_sweep(tris, o, d, maxt, excl):
    """Division-free occlusion loop. Returns (occluded, t, inst)."""
    shape, dev = o[0].shape, o[0].device
    td_best = torch.full(shape, F32_MAX, device=dev)
    ads_best = torch.ones(shape, device=dev)
    inst_best = torch.full(shape, -1.0, device=dev)
    for r in tris:
        inst_i = float(r[9])
        if not inst_i >= 0.0:
            continue
        det, uu, vv, dist = _mt(o, d, r)
        s = torch.sign(det)
        ads = det * s
        ud = uu * s
        vd = vv * s
        td = dist * s
        ok = ((ads >= F32_EPSILON) & (ud >= 0.0) & (vd >= 0.0)
              & (ud + vd <= ads) & (td > F32_EPSILON * ads)
              & (td < maxt * ads) & (td * ads_best < td_best * ads)
              & (excl != inst_i))
        td_best = torch.where(ok, td, td_best)
        ads_best = torch.where(ok, ads, ads_best)
        inst_best = torch.where(ok, inst_i, inst_best)
    occluded = inst_best >= 0.0
    t = torch.where(occluded, div(td_best, ads_best), F32_MAX)
    return occluded, t, inst_best


class _Tables:
    """The kernel's tables: numpy f32 copies for the triangle loops, the
    material table as a tensor for per-pixel lookups, params as floats."""

    def __init__(self, params, tris, attrs, em_tris, em_attrs, mats, n_em,
                 n_alias):
        self.p = params.cpu().numpy()
        self.tris = tris.cpu().numpy()
        self.attrs = attrs.cpu().numpy()
        self.em_tris = em_tris.cpu().numpy()
        self.em_attrs = em_attrs.cpu().numpy()
        self.mats = mats
        self.n_em = n_em
        self.n_alias = n_alias
        self.one_minus_cos_solar = float(np.float32(1.0)
                                         - self.p[_P_COS_SOLAR])

    def s(self, k):
        return float(self.p[k])


def _emissive_candidate(tb, rand, px, py, pz, nx, ny, nz, excl):
    """select_light_candidate(sample_emissive=True) over whole planes."""
    r0, r1, r2, r3 = rand
    cz = 1.0 - tb.one_minus_cos_solar * r2
    theta = TAU * r3
    cr = torch.sqrt(torch.clamp(1.0 - cz * cz, min=0.0))
    dl = [torch.full_like(r0, tb.s(_P_DIRL + i)) for i in range(3)]
    rdx0, rdy0, rdz0 = _onb_apply(*dl, cr * torch.cos(theta),
                                  cr * torch.sin(theta), cz)
    if tb.n_em == 0:
        return {"d": (rdx0, rdy0, rdz0), "p": torch.ones_like(r0),
                "maxd": torch.full_like(r0, F32_MAX),
                "em_inst": torch.full_like(r0, -1.0),
                "info_inst": torch.full_like(r0, -1.0),
                "info_mat": torch.full_like(r0, -1.0),
                "sp": (px + rdx0 * DISTANCE_MAX, py + rdy0 * DISTANCE_MAX,
                       pz + rdz0 * DISTANCE_MAX)}

    picked = torch.full_like(r0, -1.0)
    count = torch.zeros_like(r0)
    rand_w = r0
    for e in range(tb.n_em):
        o = _P_EM + _EM_STRIDE * e
        c3, rad, inst_e = tb.p[o:o + 3], tb.p[o + 3], float(tb.p[o + 4])
        lo, hi = [float(x) for x in c3 - rad], [float(x) for x in c3 + rad]
        inside = ((px > lo[0]) & (px < hi[0]) & (py > lo[1]) & (py < hi[1])
                  & (pz > lo[2]) & (pz < hi[2]))
        take_leaf = inside & (excl != inst_e)
        new_rand = torch.fmod(rand_w + GOLDEN_RATIO, 1.0)
        rand_w = torch.where(take_leaf, new_rand, rand_w)
        count = torch.where(take_leaf, count + 1.0, count)
        take = take_leaf & (rand_w < div(1.0, torch.clamp(count, min=1.0)))
        picked = torch.where(take, float(e), picked)
    has_pick = picked >= 0.0

    em_rows = torch.as_tensor(
        tb.p[_P_EM:_P_EM + _EM_STRIDE * tb.n_em].reshape(tb.n_em, _EM_STRIDE),
        device=r0.device)[_row_index(picked, tb.n_em)]
    em_inst, a_off, a_cnt, area, tri_off = (em_rows[..., k]
                                            for k in (4, 5, 6, 7, 8))

    # alias-table triangle pick (light.wgsl:662-669)
    ai = torch.minimum(torch.floor(r0 * a_cnt),
                       torch.clamp(a_cnt - 1.0, min=0.0))
    slot = a_off + ai
    alias = torch.as_tensor(
        tb.p[_P_ALIAS:_P_ALIAS + 2 * tb.n_alias].reshape(tb.n_alias, 2),
        device=r0.device)
    si = slot.to(torch.int64)
    s_ok = (si >= 0) & (si < tb.n_alias) & (si.to(slot.dtype) == slot)
    arow = alias[torch.where(s_ok, si, torch.zeros_like(si))]
    prob = torch.where(s_ok, arow[..., 0], 0.0)
    alias_v = torch.where(s_ok, arow[..., 1], 0.0)
    prim_local = torch.where(r1 < prob, alias_v, ai)
    em_prim = tri_off + prim_local
    et = torch.as_tensor(tb.em_tris[:, :9], device=r0.device)
    ti = em_prim.to(torch.int64)
    t_ok = (ti >= 0) & (ti < et.shape[0]) & (ti.to(em_prim.dtype) == em_prim)
    tv = torch.where(t_ok[..., None],
                     et[torch.where(t_ok, ti, torch.zeros_like(ti))], 0.0)

    srx = torch.sqrt(r2)
    b0 = 1.0 - srx
    b1 = r3 * srx
    b2 = 1.0 - b0 - b1
    tx = b0 * tv[..., 0] + b1 * tv[..., 3] + b2 * tv[..., 6]
    ty = b0 * tv[..., 1] + b1 * tv[..., 4] + b2 * tv[..., 7]
    tz = b0 * tv[..., 2] + b1 * tv[..., 5] + b2 * tv[..., 8]
    rox = px + nx * RAY_BIAS
    roy = py + ny * RAY_BIAS
    roz = pz + nz * RAY_BIAS
    rdx, rdy, rdz = _rsqrt_n(tx - px, ty - py, tz - pz)

    # probe ray restricted to the picked emitter (light.wgsl:672-687)
    incl = torch.where(has_pick, em_inst, -2.0)
    pt, pn, pmat, pinst = trace_full_sweep(
        tb.em_tris, tb.em_attrs, (rox, roy, roz), (rdx, rdy, rdz),
        F32_MAX, -1.0, incl)
    pnx, pny, pnz = _rsqrt_n(*pn)
    probe_hit = pinst >= 0.0
    probe_ok = has_pick & (_dot(rdx, rdy, rdz, nx, ny, nz) > 0.0) & probe_hit
    ptt = torch.where(probe_hit, pt, DISTANCE_MAX)
    hpx = rox + rdx * ptt
    hpy = roy + rdy * ptt
    hpz = roz + rdz * ptt
    dx_, dy_, dz_ = hpx - px, hpy - py, hpz - pz
    d2 = dx_ * dx_ + dy_ * dy_ + dz_ * dz_
    denom = torch.abs(_dot(rdx, rdy, rdz, pnx, pny, pnz) * area)
    p_em = div(div(d2, torch.clamp(denom, min=1e-20)),
               torch.clamp(count, min=1.0))
    sel = probe_ok
    return {
        "d": (torch.where(sel, rdx, rdx0), torch.where(sel, rdy, rdy0),
              torch.where(sel, rdz, rdz0)),
        "p": torch.where(sel, p_em, 1.0),
        "maxd": torch.where(sel, pt, F32_MAX),
        "em_inst": torch.where(sel, em_inst, -1.0),
        "info_inst": torch.where(sel, pinst, -1.0),
        "info_mat": torch.where(sel, pmat, -1.0),
        "sp": (torch.where(sel, hpx, rox + rdx0 * DISTANCE_MAX),
               torch.where(sel, hpy, roy + rdy0 * DISTANCE_MAX),
               torch.where(sel, hpz, roz + rdz0 * DISTANCE_MAX)),
    }


def _shade_channel(tb, cand, directional, p, n, v, surf, amb, valid):
    """Candidate -> shadow -> input radiance -> shading * w."""
    px, py, pz = p
    nx, ny, nz = n
    rdx, rdy, rdz = cand["d"]
    trace_ok = (_dot(rdx, rdy, rdz, nx, ny, nz) > 0.0) & (cand["p"] > 0.0)
    if not directional:
        trace_ok = trace_ok & (cand["em_inst"] >= 0.0)
    rox = px + nx * RAY_BIAS
    roy = py + ny * RAY_BIAS
    roz = pz + nz * RAY_BIAS
    occluded, sh_t, sh_inst = shadow_sweep(
        tb.tris, (rox, roy, roz), (rdx, rdy, rdz), cand["maxd"],
        cand["em_inst"])
    info_inst = torch.where(occluded, sh_inst, cand["info_inst"])
    info_mat = torch.where(occluded, -1.0, cand["info_mat"])
    spx = torch.where(occluded, rox + rdx * sh_t, cand["sp"][0])
    spy = torch.where(occluded, roy + rdy * sh_t, cand["sp"][1])
    spz = torch.where(occluded, roz + rdz * sh_t, cand["sp"][2])
    miss = info_inst < 0.0
    zero = torch.zeros_like(px)
    if directional:
        cosdl = _dot(rdx, rdy, rdz, tb.s(_P_DIRL), tb.s(_P_DIRL + 1),
                     tb.s(_P_DIRL + 2))
        take_dir = miss & (cosdl >= tb.s(_P_COS_SOLAR))
        rad = [torch.where(take_dir, tb.s(_P_DIRC + i), zero)
               for i in range(3)]
        rad_a = 1.0 - (miss & ~take_dir).to(torch.float32)
    else:
        hsurf = _Surface(tb.mats, torch.clamp(info_mat, min=0.0))
        take_em = (~miss) & (info_inst == cand["em_inst"])
        s255 = 255.0 * hsurf.em[3]
        rad = [torch.where(take_em, s255 * hsurf.em[i], zero)
               for i in range(3)]
        rad_a = 1.0 - miss.to(torch.float32)
    rad = [torch.where(trace_ok, c, zero) for c in rad]
    rad_a = torch.where(trace_ok, rad_a, zero)
    lum = _lum(*rad)
    w_new = torch.where(cand["p"] > 0.0,
                        div(lum, torch.clamp(cand["p"], min=1e-30)), zero)
    w_f = torch.where(lum > 0.0, div(w_new, torch.clamp(lum, min=1e-30)),
                      zero)
    w2d = torch.where(valid, w_f, zero)
    lx, ly, lz = _rsqrt_n(spx - px, spy - py, spz - pz)
    o_r, o_g, o_b = _shade(surf, amb, *v, nx, ny, nz, lx, ly, lz, *rad,
                           rad_a)
    return o_r * w2d, o_g * w2d, o_b * w2d


def _indirect_channel(tb, bounces, rand, p, n, v, surf, amb, valid):
    """Cosine bounce(s) with per-bounce NEE (light.wgsl:1264-1498)."""
    px, py, pz = p
    r0 = rand[0]
    zero = torch.zeros_like(r0)
    bnx, bny, bnz = _rsqrt_n(*n)
    b_px, b_py, b_pz = px, py, pz
    b_nx, b_ny, b_nz = bnx, bny, bnz
    br0, br1, br2, br3 = rand
    transport = [torch.ones_like(r0)] * 3
    tot_r, tot_g, tot_b, tot_a = zero, zero, zero, zero
    alive = torch.ones_like(r0, dtype=torch.bool)
    first = (zero, zero, zero)
    pdf0 = zero
    adv = tb.s(_P_ADV)
    max_ind = tb.s(_P_MAX_IND)
    dirc = [tb.s(_P_DIRC + i) for i in range(3)]

    for n_b in range(bounces):
        rr = torch.sqrt(br0)
        th = TAU * br1
        hx_ = rr * torch.cos(th)
        hy_ = rr * torch.sin(th)
        hz_ = torch.sqrt(torch.clamp(1.0 - (hx_ * hx_ + hy_ * hy_), min=0.0))
        bpdf = _TWO_INV_TAU * hz_
        rdx, rdy, rdz = _onb_apply(b_nx, b_ny, b_nz, hx_, hy_, hz_)
        rox = b_px + b_nx * RAY_BIAS
        roy = b_py + b_ny * RAY_BIAS
        roz = b_pz + b_nz * RAY_BIAS
        ht, hn, hmat, hinst = trace_full_sweep(
            tb.tris, tb.attrs, (rox, roy, roz), (rdx, rdy, rdz), F32_MAX,
            -1.0, -1.0)
        hit_ok = hinst >= 0.0
        hnx, hny, hnz = _rsqrt_n(*hn)
        htt = torch.where(hit_ok, ht, DISTANCE_MAX)
        hpx = rox + rdx * htt
        hpy = roy + rdy * htt
        hpz = roz + rdz * htt
        hnx = torch.where(hit_ok, hnx, zero)
        hny = torch.where(hit_ok, hny, zero)
        hnz = torch.where(hit_ok, hnz, zero)
        if n_b == 0:
            first = (hpx, hpy, hpz)
            pdf0 = bpdf
        hsurf = _Surface(tb.mats, torch.where(hit_ok, hmat, zero))
        hsurf.rough = torch.ones_like(r0)  # roughness := 1 at bounces

        cand = _emissive_candidate(tb, (br0, br1, br2, br3), hpx, hpy, hpz,
                                   hnx, hny, hnz, hinst)
        sample_directional = cand["em_inst"] < 0.0
        bvx, bvy, bvz = _rsqrt_n(b_px - hpx, b_py - hpy, b_pz - hpz)
        cdx, cdy, cdz = cand["d"]
        nee_ok = (_dot(cdx, cdy, cdz, hnx, hny, hnz) > 0.0) & (cand["p"] > 0.0)
        ro2 = (hpx + hnx * RAY_BIAS, hpy + hny * RAY_BIAS,
               hpz + hnz * RAY_BIAS)
        occ2, _, sh_inst2 = shadow_sweep(tb.tris, ro2, (cdx, cdy, cdz),
                                         cand["maxd"], cand["em_inst"])
        ci_inst = torch.where(occ2, sh_inst2, cand["info_inst"])
        ci_mat = torch.where(occ2, -1.0, cand["info_mat"])
        miss2 = ci_inst < 0.0
        cosdl = _dot(cdx, cdy, cdz, tb.s(_P_DIRL), tb.s(_P_DIRL + 1),
                     tb.s(_P_DIRL + 2))
        take_dir = miss2 & (cosdl >= tb.s(_P_COS_SOLAR))
        nsurf = _Surface(tb.mats, torch.clamp(ci_mat, min=0.0))
        take_em = (~miss2) & (ci_inst == cand["em_inst"])
        s255 = 255.0 * nsurf.em[3]
        ir = [torch.where(take_dir, dirc[i],
                          torch.where(take_em, s255 * nsurf.em[i], zero))
              for i in range(3)]
        ir_a = 1.0 - (miss2 & ~take_dir).to(torch.float32)
        keep = sample_directional | (ci_inst == cand["em_inst"])
        ir = [torch.where(keep, c, zero) for c in ir]
        o = _shade(hsurf, amb, bvx, bvy, bvz, hnx, hny, hnz, cdx, cdy, cdz,
                   *ir, ir_a)
        inv_p = div(1.0, torch.clamp(cand["p"], min=1e-30))
        o = [c * inv_p for c in o]
        if n_b > 0:
            kill = bpdf < 0.01
            inv_b = div(1.0, torch.clamp(bpdf, min=1e-30))
            o = [torch.where(kill, zero, c * inv_b) for c in o]
        lum_b = _lum(*o)
        scale = torch.where(lum_b > max_ind,
                            div(max_ind, torch.clamp(lum_b, min=1e-30)), 1.0)
        o = [c * scale for c in o]
        add = alive & hit_ok & nee_ok
        tot_r = torch.where(add, tot_r + transport[0] * o[0], tot_r)
        tot_g = torch.where(add, tot_g + transport[1] * o[1], tot_g)
        tot_b = torch.where(add, tot_b + transport[2] * o[2], tot_b)
        tot_a = torch.where(add, tot_a + 1.0, tot_a)
        add_m = alive & ~hit_ok
        tot_r = torch.where(add_m, tot_r + transport[0] * amb[0], tot_r)
        tot_g = torch.where(add_m, tot_g + transport[1] * amb[1], tot_g)
        tot_b = torch.where(add_m, tot_b + transport[2] * amb[2], tot_b)
        nov_t = torch.clamp(_dot(hnx, hny, hnz, bvx, bvy, bvz), min=0.0001)
        da = _env_brdf_approx(*hsurf.diff, torch.ones_like(r0), nov_t)
        sa = _env_brdf_approx(*hsurf.f0, hsurf.rough, nov_t)
        upd = alive & hit_ok
        transport = [torch.where(upd, transport[i] * (da[i] + sa[i]),
                                 transport[i]) for i in range(3)]
        alive = alive & hit_ok & ((transport[0] > 0.01)
                                  | (transport[1] > 0.01)
                                  | (transport[2] > 0.01))
        br0 = torch.fmod(br0 + adv, 1.0)
        br1 = torch.fmod(br1 + adv, 1.0)
        br2 = torch.fmod(br2 + adv, 1.0)
        br3 = torch.fmod(br3 + adv, 1.0)
        b_px = torch.where(hit_ok, hpx, b_px)
        b_py = torch.where(hit_ok, hpy, b_py)
        b_pz = torch.where(hit_ok, hpz, b_pz)
        b_nx = torch.where(hit_ok, hnx, b_nx)
        b_ny = torch.where(hit_ok, hny, b_ny)
        b_nz = torch.where(hit_ok, hnz, b_nz)

    tot_a = torch.clamp(tot_a, max=1.0)
    lx, ly, lz = _rsqrt_n(first[0] - px, first[1] - py, first[2] - pz)
    s = _shade(surf, amb, *v, bnx, bny, bnz, lx, ly, lz, tot_r, tot_g, tot_b,
               tot_a)
    lum_s = _lum(*s)
    w_new = torch.where(pdf0 > 0.0, div(lum_s, torch.clamp(pdf0, min=1e-30)),
                        zero)
    w2d = torch.where(valid & (lum_s > 0.0),
                      div(w_new, torch.clamp(lum_s, min=1e-30)), zero)
    return tuple(c * w2d for c in s)


def lighting_plain(params, tris, attrs, em_tris, em_attrs, mats, position,
                   normal, inst_mat, rand, *, has_sun: bool, n_em: int,
                   n_alias: int, bounces: int):
    """The kernel body over whole planes. Returns (d, e, i) [h,w,4] renders
    (None for a channel that is off)."""
    tb = _Tables(params, tris, attrs, em_tris, em_attrs, mats, n_em, n_alias)
    px, py, pz, depth = position.unbind(-1)
    n = normal.unbind(-1)
    inst_f = inst_mat[..., 0].to(torch.int32).to(torch.float32)
    mat_f = torch.clamp(inst_mat[..., 1].to(torch.int32), min=0).to(
        torch.float32)
    rnd = rand.unbind(-1)
    valid = depth >= F32_EPSILON
    zero = torch.zeros_like(depth)
    alpha = valid.to(torch.float32)
    amb = [tb.s(_P_AMB + i) for i in range(3)]
    surf = _Surface(mats, mat_f)
    v = _rsqrt_n(tb.s(_P_CAM) - px, tb.s(_P_CAM + 1) - py,
                 tb.s(_P_CAM + 2) - pz)

    def render(rgb):
        return torch.stack([torch.where(valid, c, zero) for c in rgb]
                           + [alpha], -1)

    d_out = e_out = i_out = None
    if has_sun:
        cz = 1.0 - tb.one_minus_cos_solar * rnd[2]
        theta = TAU * rnd[3]
        cr = torch.sqrt(torch.clamp(1.0 - cz * cz, min=0.0))
        dl = [torch.full_like(depth, tb.s(_P_DIRL + i)) for i in range(3)]
        d = _onb_apply(*dl, cr * torch.cos(theta), cr * torch.sin(theta), cz)
        cand = {"d": d, "p": torch.ones_like(depth),
                "maxd": torch.full_like(depth, F32_MAX),
                "em_inst": torch.full_like(depth, -1.0),
                "info_inst": torch.full_like(depth, -1.0),
                "info_mat": torch.full_like(depth, -1.0),
                "sp": (px + d[0] * DISTANCE_MAX, py + d[1] * DISTANCE_MAX,
                       pz + d[2] * DISTANCE_MAX)}
        o = _shade_channel(tb, cand, True, (px, py, pz), n, v, surf, amb,
                           valid)
        em_add = 255.0 * surf.em[3]
        d_out = render([o[i] + em_add * surf.em[i] for i in range(3)])
    if n_em > 0:
        cand = _emissive_candidate(tb, rnd, px, py, pz, *n, inst_f)
        e_out = render(_shade_channel(tb, cand, False, (px, py, pz), n, v,
                                      surf, amb, valid))
    if bounces > 0:
        i_out = render(_indirect_channel(tb, bounces, rnd, (px, py, pz), n, v,
                                         surf, amb, valid))
    return d_out, e_out, i_out


def lighting_kernel(params, tris, attrs, em_tris, em_attrs, mats, position,
                    normal, inst_mat, rand, *, has_sun: bool, n_em: int,
                    n_alias: int, bounces: int):
    """Kernel B: runs `lighting_plain` for CPU tensors and launches
    csrc/light_fused.cu for CUDA tensors."""
    kw = dict(has_sun=has_sun, n_em=n_em, n_alias=n_alias, bounces=bounces)
    if on_cpu(position):
        return lighting_plain(params, tris, attrs, em_tris, em_attrs, mats,
                              position, normal, inst_mat, rand, **kw)
    from hikari_tpu_torch.build import load_cuda

    dev = position.device
    h, w = position.shape[:2]
    f = torch.float32
    check("params", params, f, (_P_COUNT,), dev)
    check("tris", tris, f, (tris.shape[0], 10), dev)
    check("attrs", attrs, f, (tris.shape[0], 17), dev)
    check("em_tris", em_tris, f, (em_tris.shape[0], 10), dev)
    check("em_attrs", em_attrs, f, (em_tris.shape[0], 17), dev)
    check("mats", mats, f, (mats.shape[0], 15), dev)
    check("position", position, f, (h, w, 4), dev)
    check("normal", normal, f, (h, w, 3), dev)
    check("inst_mat", inst_mat, f, (h, w, 2), dev)
    check("rand", rand, f, (h, w, 4), dev)
    if not 0 <= n_em <= MAX_EMISSIVES or not 0 <= n_alias <= MAX_ALIAS_SLOTS:
        raise ValueError(f"n_em={n_em}, n_alias={n_alias} beyond the caps")

    def out(on):
        return torch.empty((h, w, 4), dtype=f, device=dev) if on else None

    d_out, e_out, i_out = out(has_sun), out(n_em > 0), out(bounces > 0)
    fn = bind(load_cuda("light_fused"), "hk_light_fused",
              "pppippipippppiiiiipppp")
    rc = fn(ptr(params), ptr(tris), ptr(attrs), tris.shape[0], ptr(em_tris),
            ptr(em_attrs), em_tris.shape[0], ptr(mats), mats.shape[0],
            ptr(position), ptr(normal), ptr(inst_mat), ptr(rand), h, w, n_em,
            n_alias, bounces, ptr(d_out), ptr(e_out), ptr(i_out),
            stream(dev))
    check_launch(rc, "light_fused")
    lighting_kernel.launches += 1
    return d_out, e_out, i_out


lighting_kernel.launches = 0


def fused_lighting(scene, g, view, frame, rand, *, has_sun: bool,
                   num_emissives: int, bounces: int, render_size):
    """No-reuse lighting for every active channel. g: render-res G-buffer
    dict; rand: [h,w,4] blue noise. Returns {d,e,i}_render [h,w,4] for the
    active channels (their variance is identically zero on this path)."""
    h, w = render_size
    err = lighting_caps_error(scene, num_emissives)
    if err is not None:
        raise NotImplementedError(f"scene beyond the lighting kernel: {err}")
    n_em = num_emissives
    tris, attrs = scene["tri_pos_flat"], scene["tri_attr"]
    if n_em > 0:
        em_tris, em_attrs = scene["em_tri_pos_flat"], scene["em_tri_attr"]
        n_alias = scene["alias_packed"].shape[0]
    else:
        em_tris, em_attrs = tris[:1], attrs[:1]
        n_alias = 0
    params = pack_params(scene, view, frame, n_em)
    d, e, i = lighting_kernel(
        params, tris, attrs, em_tris, em_attrs, scene["mat_packed"],
        g["position"], g["normal"], g["instance_material"], rand,
        has_sun=has_sun, n_em=n_em, n_alias=n_alias, bounces=bounces)
    out = {}
    for slot, r in (("d", d), ("e", e), ("i", i)):
        if r is not None:
            out[f"{slot}_render"] = r
    return out
