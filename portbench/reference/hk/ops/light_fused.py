"""Lighting: kernels B (no reuse) and 4 (temporal reuse), both in
csrc/light_fused.cu, and their plain version.

The port of hikari_tpu/ops/light_fused.py: for every pixel, the direct
(solar NEE), emissive (emissive-BVH walk, alias pick, probe, shadow) and
indirect (cosine bounces with NEE) channels, shaded with the Burley/GGX
chain of light.wgsl. With temporal reuse each channel also merges its
reprojected previous reservoir in the kernel (gates, WRS, the validation
retrace on validation frames, finalize, 64 B repack), and can emit the
flags and scatter reservoirs the spatial pass needs. `fused_lighting`
keeps the TPU wrapper's contract: render-res G-buffer dict + [h,w,4] blue
noise (+ gathered previous reservoirs) in, {d,e,i}_render [h,w,4] (rgb +
valid alpha) (+ variance, packed reservoir, flags, scatter) out, for the
channels present.

`lighting_plain` is the kernel body transcribed to whole-plane tensor
operations, one operation at a time in the kernel's order. The wrapper
`lighting_kernel` runs it.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference.hk.config import validates
from portbench.reference.hk.ops import reservoir as rsv
from portbench.reference.hk.ops._kernel import (
    const_values,
    div,
    dynamic,
    exp2,
    f32,
    frame_value)
from portbench.reference.hk.ops.noise import frame_advance
from portbench.reference.hk.ops.trace_pallas import (DISTANCE_MAX, shadow_sweep,
                                               trace_full_sweep)
from portbench.reference.hk.utils.math import (F32_EPSILON, F32_MAX, GOLDEN_RATIO,
                                         INV_TAU, PI, TAU)

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
_P_MAXCNT = 15     # max_temporal_reuse_count (temporal reuse)
_P_EM = 16         # per-emissive stride-10 block (leaf order):
#                    cx cy cz radius inst alias_off alias_count area tri_off 0
_EM_STRIDE = 10
_P_ALIAS = 96      # alias slots (prob, alias) pairs
_P_VAL = 224       # validation flags of this frame: direct, emissive (0/1)


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


def validation_flags(frame, has_sun: bool, n_em: int):
    """(direct, emissive) validation flags of this frame, from host
    integers: number % max(interval, 1) == 0, for active channels only
    (they pick the kernel variant, so an absent channel never forces the
    retrace)."""
    num = frame["number"]
    d = validates(num, frame["direct_validate_interval"])
    e = validates(num, frame["emissive_validate_interval"])
    return float(d and has_sun), float(e and n_em > 0)


def pack_params(scene, view, frame, n_em: int, has_sun: bool = True,
                temporal: bool = True) -> torch.Tensor:
    """[228] f32 parameter vector on the scene's device, every word on the
    device: the scene's and the view's tensors, the frame's advance (its
    device word `advance`), the settings' dynamic values (the frame's
    words: cos(solar angle), the indirect clamp, the temporal cap) and
    constants of the frame's branch (the validation flags, zeros without
    temporal reuse, which reads none)."""
    dev = scene["dir_to_light"].device
    adv = frame_value(frame, "advance",
                      lambda: [frame_advance(frame["number"])], dev)
    flags = (validation_flags(frame, has_sun, n_em) if temporal
             else (0.0, 0.0))
    val = const_values(list(flags) + [0.0, 0.0], dev)
    head = torch.cat([
        scene["dir_to_light"][:3], scene["dir_color"][:3],
        scene["ambient_color"][:3], dynamic(frame, "cos_solar", dev),
        view["world_position"][:3],
        dynamic(frame, "max_indirect_luminance", dev), adv.reshape(1),
        dynamic(frame, "temporal_cap", dev)])
    em = torch.zeros(_P_ALIAS - _P_EM, dtype=torch.float32, device=dev)
    alias = torch.zeros(_P_VAL - _P_ALIAS, dtype=torch.float32, device=dev)
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
    return torch.cat([head, em, alias, val])


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
    a004 = torch.minimum(r0 * r0, exp2(-9.28 * nov)) * r0 + r1
    ab_x = -1.04 * a004 + r2
    ab_y = 1.04 * a004 + r3
    return f0r * ab_x + ab_y, f0g * ab_x + ab_y, f0b * ab_x + ab_y


def _row_index(f, n: int):
    """Row of a float id in an n-row table: the id itself when it is an
    integer in [0, n), else 0 (hikari_tpu's select-sweep default)."""
    i = f.to(torch.int64)
    ok = (i >= 0) & (i < n) & (i.to(f.dtype) == f)
    return torch.where(ok, i, torch.zeros_like(i))


def material_ids(inst_mat):
    """The material ids a pass shades with, from the G-buffer's
    instance_material [..., 2]: clamp(int(.y), 0) as float32 (the kernels
    form the same id from the word: common.cuh material_id)."""
    return torch.clamp(inst_mat[..., 1].to(torch.int32), min=0).to(
        torch.float32)


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
                       pz + rdz0 * DISTANCE_MAX),
                "spw": torch.zeros_like(r0),
                "sn": (torch.zeros_like(r0),) * 3}

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
        "spw": sel.to(torch.float32),
        "sn": (torch.where(sel, pnx, 0.0), torch.where(sel, pny, 0.0),
               torch.where(sel, pnz, 0.0)),
    }


def _solar_candidate(tb, rand, pos):
    """The solar-cone candidate (sampling.py:157): p = 1, no emitter, the
    sample point DISTANCE_MAX along the direction from `pos`."""
    cz = 1.0 - tb.one_minus_cos_solar * rand[2]
    theta = TAU * rand[3]
    cr = torch.sqrt(torch.clamp(1.0 - cz * cz, min=0.0))
    dl = [torch.full_like(cz, tb.s(_P_DIRL + i)) for i in range(3)]
    d = _onb_apply(*dl, cr * torch.cos(theta), cr * torch.sin(theta), cz)
    zero = torch.zeros_like(cz)
    return {"d": d, "p": torch.ones_like(cz),
            "maxd": torch.full_like(cz, F32_MAX),
            "em_inst": torch.full_like(cz, -1.0),
            "info_inst": torch.full_like(cz, -1.0),
            "info_mat": torch.full_like(cz, -1.0),
            "sp": (pos[0] + d[0] * DISTANCE_MAX, pos[1] + d[1] * DISTANCE_MAX,
                   pos[2] + d[2] * DISTANCE_MAX),
            "spw": zero, "sn": (zero, zero, zero)}


def _input_radiance(tb, directional, d, info_inst, info_mat, em_inst):
    """input_radiance (sample_ambient=False): the sun through the solar
    cone, or the emission of the emitter the ray was aimed at."""
    miss = info_inst < 0.0
    zero = torch.zeros_like(info_inst)
    if directional:
        cosdl = _dot(*d, tb.s(_P_DIRL), tb.s(_P_DIRL + 1), tb.s(_P_DIRL + 2))
        take_dir = miss & (cosdl >= tb.s(_P_COS_SOLAR))
        rad = [torch.where(take_dir, tb.s(_P_DIRC + i), zero)
               for i in range(3)]
        rad_a = 1.0 - (miss & ~take_dir).to(torch.float32)
    else:
        hsurf = _Surface(tb.mats, torch.clamp(info_mat, min=0.0))
        take_em = (~miss) & (info_inst == em_inst)
        s255 = 255.0 * hsurf.em[3]
        rad = [torch.where(take_em, s255 * hsurf.em[i], zero)
               for i in range(3)]
        rad_a = 1.0 - miss.to(torch.float32)
    return rad, rad_a


def _trace_candidate(tb, cand, directional, p, n):
    """Candidate -> shadow -> input radiance. Returns (rad rgba, lum,
    w_new, sample point, sample flag, sample normal), occluders
    overriding the probe's hit."""
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
    sp = (torch.where(occluded, rox + rdx * sh_t, cand["sp"][0]),
          torch.where(occluded, roy + rdy * sh_t, cand["sp"][1]),
          torch.where(occluded, roz + rdz * sh_t, cand["sp"][2]))
    spw = torch.where(occluded, 1.0, cand["spw"])
    sn = tuple(torch.where(occluded, 0.0, c) for c in cand["sn"])
    rad, rad_a = _input_radiance(tb, directional, cand["d"], info_inst,
                                 info_mat, cand["em_inst"])
    zero = torch.zeros_like(px)
    rad = [torch.where(trace_ok, c, zero) for c in rad]
    rad_a = torch.where(trace_ok, rad_a, zero)
    lum = _lum(*rad)
    w_new = torch.where(cand["p"] > 0.0,
                        div(lum, torch.clamp(cand["p"], min=1e-30)), zero)
    return (*rad, rad_a), lum, w_new, sp, spw, sn


def _shade_channel(tb, cand, directional, p, n, v, surf, amb, valid):
    """Candidate -> shadow -> input radiance -> shading * w (no reuse)."""
    px, py, pz = p
    rad, lum, w_new, sp, _, _ = _trace_candidate(tb, cand, directional, p, n)
    zero = torch.zeros_like(px)
    w_f = torch.where(lum > 0.0, div(w_new, torch.clamp(lum, min=1e-30)),
                      zero)
    w2d = torch.where(valid, w_f, zero)
    lx, ly, lz = _rsqrt_n(sp[0] - px, sp[1] - py, sp[2] - pz)
    o_r, o_g, o_b = _shade(surf, amb, *v, *n, lx, ly, lz, *rad)
    return o_r * w2d, o_g * w2d, o_b * w2d


def _indirect_bounces(tb, bounces, rand, p, n, amb):
    """Cosine bounce(s) with per-bounce NEE (light.wgsl:1264-1498): the
    gathered radiance and the first bounce's hit, before shading at the
    visible point."""
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
    first_n = (zero, zero, zero)
    first_hit = torch.zeros_like(r0, dtype=torch.bool)
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
            first_n = (hnx, hny, hnz)
            first_hit = hit_ok
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

    return {"tot": (tot_r, tot_g, tot_b, torch.clamp(tot_a, max=1.0)),
            "first": first, "first_n": first_n, "first_hit": first_hit,
            "pdf0": pdf0, "bn": (bnx, bny, bnz)}


def _indirect_sample(px, ind):
    """Shading of the gathered radiance at the visible point, and its
    resampling weight."""
    l = _rsqrt_n(ind["first"][0] - px.p[0], ind["first"][1] - px.p[1],
                 ind["first"][2] - px.p[2])
    s = _shade(px.surf, px.amb, *px.v, *ind["bn"], *l, *ind["tot"])
    lum_s = _lum(*s)
    zero = torch.zeros_like(lum_s)
    w_new = torch.where(ind["pdf0"] > 0.0,
                        div(lum_s, torch.clamp(ind["pdf0"], min=1e-30)), zero)
    return s, lum_s, w_new


class _Pixel:
    """The visible point of every pixel, shared by the channels."""

    def __init__(self, tb, position, normal, inst_mat, rand):
        px, py, pz, self.depth = position.unbind(-1)
        self.p = (px, py, pz)
        self.n = normal.unbind(-1)
        self.nrm_n = _rsqrt_n(*self.n)
        self.inst_f = inst_mat[..., 0].to(torch.int32).to(torch.float32)
        self.mat_f = material_ids(inst_mat)
        self.rnd = rand.unbind(-1)
        self.valid = self.depth >= F32_EPSILON
        self.amb = [tb.s(_P_AMB + i) for i in range(3)]
        self.surf = _Surface(tb.mats, self.mat_f)
        self.v = _rsqrt_n(tb.s(_P_CAM) - px, tb.s(_P_CAM + 1) - py,
                          tb.s(_P_CAM + 2) - pz)


# ---- temporal reservoirs (light.wgsl:917-952, 1156-1259) over field dicts

def _gates(prev, px):
    """check_previous_reservoir (light.wgsl:917-935): the gated reservoir
    and the miss mask."""
    depth = px.depth
    ratio = div(prev["vpd"], torch.where(depth == 0.0, 1e-30, depth))
    ratio = torch.where(ratio < 1.0,
                        div(1.0, torch.where(ratio == 0.0, 1e-30, ratio)),
                        ratio)
    depth_miss = ratio > 1.05 * (1.0 + 0.5 * px.rnd[0])
    inst_miss = prev["vinst"] != px.inst_f
    normal_miss = _dot(*px.nrm_n, prev["vnx"], prev["vny"],
                       prev["vnz"]) < 0.9
    miss = depth_miss | inst_miss | normal_miss
    return rsv.zero_fields_where(miss, prev), miss


def _sample(rad, rnd, p, depth, n, inst_f, sp, spw, sn):
    return {"rad_r": rad[0], "rad_g": rad[1], "rad_b": rad[2],
            "rad_a": rad[3],
            "rnd0": rnd[0], "rnd1": rnd[1], "rnd2": rnd[2], "rnd3": rnd[3],
            "vpx": p[0], "vpy": p[1], "vpz": p[2], "vpd": depth,
            "vnx": n[0], "vny": n[1], "vnz": n[2], "vinst": inst_f,
            "spx": sp[0], "spy": sp[1], "spz": sp[2], "spw": spw,
            "snx": sn[0], "sny": sn[1], "snz": sn[2]}


def _rsv_update(r, s, w_new, mask):
    """WRS update (reservoir.update_reservoir, light.wgsl:146-173)."""
    w_sum = r["w_sum"] + w_new
    w2_sum = r["w2_sum"] + w_new * w_new
    count = r["count"] + 1.0
    rand = torch.fmod(s["rnd0"] + s["rnd1"] + s["rnd2"] + s["rnd3"], 1.0)
    replace = mask & (rand < div(w_new, torch.clamp(w_sum, min=1e-30)))
    out = dict(r)
    out["w_sum"] = torch.where(mask, w_sum, r["w_sum"])
    out["w2_sum"] = torch.where(mask, w2_sum, r["w2_sum"])
    out["count"] = torch.where(mask, count, r["count"])
    for k in rsv.SAMPLE_KEYS:
        out[k] = torch.where(replace, s[k], r[k])
    return out


def rsv_clamp(r, max_count: float):
    """History clamp (light.wgsl:944-951, 1645-1651)."""
    over = r["count"] > max_count
    scale = torch.where(over, div(max_count,
                                  torch.clamp(r["count"], min=1e-30)), 1.0)
    out = dict(r)
    out["w_sum"] = r["w_sum"] * scale
    out["w2_sum"] = r["w2_sum"] * scale
    out["count"] = torch.clamp(r["count"], max=max_count)
    return out


def rsv_variance(r):
    """Stored variance (light.wgsl:1224-1227), before the 10 cap."""
    cnt = torch.clamp(r["count"], min=1e-30)
    mean = div(r["w_sum"], cnt)
    var = div(r["w2_sum"], cnt) - mean * mean
    return torch.where(r["count"] < 1.0, var, div(var, cnt))


def _finish(r, px, normal):
    """Visible point := this frame's, life + 1, the capped variance, and
    the empty reservoir on invalid pixels."""
    r = dict(r)
    for k, v in zip(("vpx", "vpy", "vpz", "vpd", "vnx", "vny", "vnz"),
                    (*px.p, px.depth, *normal)):
        r[k] = v
    r["life"] = r["life"] + 1.0
    var = torch.where(px.valid, torch.clamp(rsv_variance(r), max=10.0), 0.0)
    return rsv.zero_fields_where(~px.valid, r), var


def _reuse_channel(tb, px, cand_fn, prev_planes, directional, is_val,
                   validation):
    """The temporal path of direct_lit (light.wgsl:1045-1261) for the
    direct or emissive channel. Returns (rgb, variance, reservoir,
    (gate miss, validation miss, scatter reservoir))."""
    r, gate_miss = _gates(rsv.unpack_fields(prev_planes), px)
    cand = cand_fn(px.rnd, px.p, px.n)
    rad, _, w_new, sp, spw, sn = _trace_candidate(tb, cand, directional,
                                                  px.p, px.n)
    s2 = _sample(rad, px.rnd, px.p, px.depth, px.n, px.inst_f, sp, spw, sn)
    gate = px.valid if is_val < 0.5 else px.valid & (r["count"] < 4.0)
    rcur = rsv_clamp(_rsv_update(r, s2, w_new, gate), tb.s(_P_MAXCNT))
    r_scatter = dict(rcur)
    val_miss = torch.zeros_like(px.valid)
    if validation and is_val > 0.5:
        # retrace of the reservoir's remembered sample (light.wgsl:
        # 1156-1213): candidate re-select at the stored point, shadow ray
        # from this frame's point towards the stored sample
        cand_v = cand_fn((r["rnd0"], r["rnd1"], r["rnd2"], r["rnd3"]),
                         (r["vpx"], r["vpy"], r["vpz"]),
                         (r["vnx"], r["vny"], r["vnz"]))
        rv = _rsqrt_n(r["spx"] - px.p[0], r["spy"] - px.p[1],
                      r["spz"] - px.p[2])
        trace_ok = ((_dot(*cand_v["d"], r["vnx"], r["vny"], r["vnz"]) > 0.0)
                    & (cand_v["p"] > 0.0))
        if not directional:
            trace_ok = trace_ok & (cand_v["em_inst"] >= 0.0)
        ro = tuple(px.p[i] + px.n[i] * RAY_BIAS for i in range(3))
        occ, sh_t, sh_inst = shadow_sweep(tb.tris, ro, rv, cand_v["maxd"],
                                          cand_v["em_inst"])
        vi_inst = torch.where(occ, sh_inst, cand_v["info_inst"])
        vi_mat = torch.where(occ, -1.0, cand_v["info_mat"])
        vsp = [torch.where(occ, ro[i] + rv[i] * sh_t, cand_v["sp"][i])
               for i in range(3)]
        vspw = torch.where(occ, 1.0, cand_v["spw"])
        vsn = [torch.where(occ, 0.0, c) for c in cand_v["sn"]]
        vrad, vrad_a = _input_radiance(tb, directional, rv, vi_inst, vi_mat,
                                       cand_v["em_inst"])
        zero = torch.zeros_like(vi_inst)
        vrad = [torch.where(trace_ok, c, zero) for c in vrad + [vrad_a]]
        reuse_validate = r["count"] >= 4.0
        s2v = dict(s2)
        for k, v in zip(("rnd0", "rnd1", "rnd2", "rnd3", "spx", "spy", "spz",
                         "spw", "snx", "sny", "snz", "rad_r", "rad_g",
                         "rad_b", "rad_a"),
                        (r["rnd0"], r["rnd1"], r["rnd2"], r["rnd3"], *vsp,
                         vspw, *vsn, *vrad)):
            s2v[k] = torch.where(reuse_validate, v, s2[k])
        lum_ratio = div(_lum(*vrad[:3]),
                        torch.clamp(_lum(r["rad_r"], r["rad_g"], r["rad_b"]),
                                    min=1e-4))
        take_v = ((lum_ratio > 1.25) | (lum_ratio < 0.8)) & px.valid
        w_new_v = torch.where(
            cand_v["p"] > 0.0,
            div(_lum(s2v["rad_r"], s2v["rad_g"], s2v["rad_b"]),
                torch.clamp(cand_v["p"], min=1e-30)), zero)
        fresh = dict(s2v, count=torch.ones_like(zero), life=zero, w=zero,
                     w_sum=w_new_v, w2_sum=w_new_v * w_new_v)
        rcur = {k: torch.where(take_v, fresh[k], v) for k, v in rcur.items()}
        val_miss = take_v
    # finalize (light.wgsl:1216-1259)
    tot = rcur["count"] * _lum(rcur["rad_r"], rcur["rad_g"], rcur["rad_b"])
    rcur["w"] = torch.where(tot > 0.0, div(rcur["w_sum"],
                                           torch.clamp(tot, min=1e-30)), 0.0)
    rcur, var = _finish(rcur, px, px.n)
    ld = _rsqrt_n(rcur["spx"] - rcur["vpx"], rcur["spy"] - rcur["vpy"],
                  rcur["spz"] - rcur["vpz"])
    o = _shade(px.surf, px.amb, *px.v, *px.n, *ld, rcur["rad_r"],
               rcur["rad_g"], rcur["rad_b"], rcur["rad_a"])
    o = [c * rcur["w"] for c in o]
    return o, var, rcur, (gate_miss & px.valid, val_miss, r_scatter)


def _indirect_reuse(tb, px, ind, prev_planes):
    """The temporal path of indirect_lit_ambient (light.wgsl:1452-1497):
    the reservoir keeps the raw bounce radiance and shades the merged
    sample. Returns (rgb, variance, reservoir, gate miss)."""
    _, _, w_new = _indirect_sample(px, ind)
    r, gate_miss = _gates(rsv.unpack_fields(prev_planes), px)
    s = _sample(ind["tot"], px.rnd, px.p, px.depth, ind["bn"], px.inst_f,
                ind["first"], ind["first_hit"].to(torch.float32),
                ind["first_n"])
    r = rsv_clamp(_rsv_update(r, s, w_new, px.valid), tb.s(_P_MAXCNT))
    ld = _rsqrt_n(r["spx"] - r["vpx"], r["spy"] - r["vpy"],
                  r["spz"] - r["vpz"])
    o = _shade(px.surf, px.amb, *px.v, r["vnx"], r["vny"], r["vnz"], *ld,
               r["rad_r"], r["rad_g"], r["rad_b"], r["rad_a"])
    tot2 = r["count"] * _lum(*o)
    r["w"] = torch.where(tot2 > 0.0, div(r["w_sum"],
                                         torch.clamp(tot2, min=1e-30)), 0.0)
    r, var = _finish(r, px, ind["bn"])
    return [c * r["w"] for c in o], var, r, gate_miss & px.valid


def lighting_plain(params, tris, attrs, em_tris, em_attrs, mats, position,
                   normal, inst_mat, rand, prev=(), *, has_sun: bool,
                   n_em: int, n_alias: int, bounces: int,
                   temporal: bool = False, validation: bool = True,
                   track_de: bool = False, track_ind: bool = False):
    """The kernel body over whole planes. prev: with temporal, the gathered
    previous reservoir planes [h,16,w] of the active channels in d/e/i
    order. Returns {d,e,i}_render [h,w,4] for the active channels, and
    with temporal {d,e,i}_var, {d,e,i}_packed, and when tracking
    {d,e}_flags, {d,e}_scatter, i_flags (fused_lighting's contract)."""
    tb = _Tables(params, tris, attrs, em_tris, em_attrs, mats, n_em, n_alias)
    px = _Pixel(tb, position, normal, inst_mat, rand)
    valid = px.valid
    zero = torch.zeros_like(px.depth)
    alpha = valid.to(torch.float32)
    prev = list(prev)
    out = {}

    def render(rgb):
        return torch.stack([torch.where(valid, c, zero) for c in rgb]
                           + [alpha], -1)

    def reuse(slot, cand_fn, directional, is_val, add):
        o, var, r, (gate_miss, val_miss, r_scatter) = _reuse_channel(
            tb, px, cand_fn, prev.pop(0), directional, is_val, validation)
        out[f"{slot}_render"] = render([o[i] + add[i] for i in range(3)])
        out[f"{slot}_var"] = var
        out[f"{slot}_packed"] = rsv.pack_fields(r)
        if track_de:
            out[f"{slot}_flags"] = (gate_miss.to(torch.float32)
                                    + 2.0 * val_miss.to(torch.float32))
            out[f"{slot}_scatter"] = rsv.pack_fields(r_scatter)

    if has_sun:
        def solar(rand4, pos, nrm):
            return _solar_candidate(tb, rand4, pos)

        em_add = 255.0 * px.surf.em[3]
        add = [em_add * px.surf.em[i] for i in range(3)]
        if temporal:
            reuse("d", solar, True, tb.s(_P_VAL), add)
        else:
            o = _shade_channel(tb, solar(px.rnd, px.p, px.n), True, px.p,
                               px.n, px.v, px.surf, px.amb, valid)
            out["d_render"] = render([o[i] + add[i] for i in range(3)])
    if n_em > 0:
        def emissive(rand4, pos, nrm):
            return _emissive_candidate(tb, rand4, *pos, *nrm, px.inst_f)

        if temporal:
            reuse("e", emissive, False, tb.s(_P_VAL + 1), (0.0,) * 3)
        else:
            out["e_render"] = render(_shade_channel(
                tb, emissive(px.rnd, px.p, px.n), False, px.p, px.n, px.v,
                px.surf, px.amb, valid))
    if bounces > 0:
        ind = _indirect_bounces(tb, bounces, px.rnd, px.p, px.n, px.amb)
        if temporal:
            o, var, r, gate_miss = _indirect_reuse(tb, px, ind, prev.pop(0))
            out["i_render"] = render(o)
            out["i_var"] = var
            out["i_packed"] = rsv.pack_fields(r)
            if track_ind:
                out["i_flags"] = gate_miss.to(torch.float32)
        else:
            s, lum_s, w_new = _indirect_sample(px, ind)
            w2d = torch.where(valid & (lum_s > 0.0),
                              div(w_new, torch.clamp(lum_s, min=1e-30)), zero)
            out["i_render"] = render([c * w2d for c in s])
    return out


_IO_KEYS = ("render", "var", "packed", "flags", "scatter", "prev")
# {(io key, channel): its index among the io pointers}
_IO_SLOTS = {(k, c): 3 * i + c for i, k in enumerate(_IO_KEYS)
             for c in range(3)}
# {(h, w, active channels, temporal, track_de, track_ind): plan}, see _plan
_plans = {}


def _plan(h, w, active, temporal, track_de, track_ind):
    """The outputs of a launch as groups of one shape, each one allocation:
    [(shape [n, ...], [(output name, io pointer index)] * n)]. The renders,
    variances and flags, packed reservoirs and scatter reservoirs of the
    active channels d/e/i; the packed reservoirs (which the frame carries
    on) in an allocation of their own."""
    groups = {"render": (h, w, 4), "var": (h, w), "flags": (h, w),
              "packed": (h, 16, w), "scatter": (h, 16, w)}
    members = {k: [] for k in groups}
    for c, slot in enumerate("dei"):
        if not active[c]:
            continue
        keys = ["render"]
        if temporal:
            keys += ["var", "packed"]
            if (slot != "i" and track_de) or (slot == "i" and track_ind):
                keys.append("flags")
            if slot != "i" and track_de:
                keys.append("scatter")
        for k in keys:
            group = "var" if k == "flags" else k
            members[group].append((f"{slot}_{k}", _IO_SLOTS[k, c]))
    plan = [((len(m),) + groups[k], m) for k, m in members.items() if m]
    _plans[h, w, active, temporal, track_de, track_ind] = plan
    return plan


def lighting_kernel(params, tris, attrs, em_tris, em_attrs, mats, position,
                    normal, inst_mat, rand, prev=(), *, has_sun: bool,
                    n_em: int, n_alias: int, bounces: int,
                    temporal: bool = False, validation: bool = True,
                    track_de: bool = False, track_ind: bool = False):
    """Kernels B (no reuse) and 4 (temporal reuse): runs `lighting_plain`.
    The variant (temporal, validation retrace, tracking outputs) is chosen
    from these Python values, never from a device value."""
    return lighting_plain(
        params, tris, attrs, em_tris, em_attrs, mats, position, normal,
        inst_mat, rand, prev, has_sun=has_sun, n_em=n_em,
        n_alias=n_alias, bounces=bounces, temporal=temporal,
        validation=validation, track_de=track_de, track_ind=track_ind)


def fused_lighting(scene, g, view, frame, rand, *, has_sun: bool,
                   num_emissives: int, bounces: int, render_size,
                   temporal: bool = False, prev_planes=None,
                   track_de: bool = False, track_ind: bool = False):
    """Lighting of every active channel in one launch. g: render-res
    G-buffer dict; rand: [h,w,4] blue noise. Returns {d,e,i}_render [h,w,4]
    (their variance is identically zero without reuse). temporal=True
    also takes prev_planes, the gathered [h,16,w] reservoirs of the active
    channels in d/e/i order, and returns {d,e,i}_var, {d,e,i}_packed and,
    when tracking spatial reuse, {d,e}_flags, {d,e}_scatter, i_flags. The
    validation retrace runs only on frames where an active channel's
    validate interval fires."""
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
    params = pack_params(scene, view, frame, n_em, has_sun, temporal)
    validation = temporal and sum(validation_flags(frame, has_sun, n_em)) > 0
    tables = (params, tris, attrs, em_tris, em_attrs, scene["mat_packed"])
    planes = (g["position"], g["normal"], g["instance_material"], rand)
    prev = list(prev_planes) if temporal else []
    kw = dict(has_sun=has_sun, n_em=n_em, n_alias=n_alias, bounces=bounces,
              temporal=temporal, validation=validation, track_de=track_de,
              track_ind=track_ind)
    return lighting_kernel(*tables, *planes, prev, **kw)
