"""Spatial ReSTIR: kernel 10 (csrc/spatial_fused.cu) and its plain version.

The port of hikari_tpu/ops/spatial_fused.py (light.wgsl:1500-1676 in one
pass) for one channel:

* start reservoir: the reprojected previous spatial reservoir where the
  temporal lifetime is within max_reservoir_lifetime, else the temporal
  reservoir (light.wgsl:1529-1541);
* merge this pixel's temporal reservoir (count-weighted WRS);
* per spiral tap: the in-bounds gate, a screen-space depth ray-march, the
  depth-ratio / normal / forward gates, the clamped GRIS Jacobian, WRS
  (light.wgsl:1566-1643);
* the winner-plane epilogue (the visible point and normal stay the
  centre's unless a tap won), the history clamp, shading at the visible
  point, finalize w, lifetime + 1, the variance (NaN where the frame keeps
  the temporal variance) and the 64 B repack.

The spiral rotates once per frame, so every pixel of a frame uses the same
integer tap offsets. They are computed once per frame on the host in numpy
float32, in the operation order of hikari_tpu's _tap_geometry and kernel
(tap_table), staged with the frame's device words (frame.frame_words) and
handed to the kernel and to the plain version in the parameter vector:
both use identical integers.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from portbench.reference.hk.ops import reservoir as rsv
from portbench.reference.hk.ops._kernel import (
    const_values,
    div,
    dynamic,
    frame_value)
from portbench.reference.hk.ops.light_fused import (MAX_MATERIALS, _Surface, _dot,
                                              _lum, _rsqrt_n, _shade,
                                              material_ids, rsv_clamp,
                                              rsv_variance)
from portbench.reference.hk.utils.math import (F32_EPSILON, GOLDEN_RATIO, TAU,
                                         random_float)

# light.wgsl:1505-1515 constants
SPATIAL_TAPS = 4
SPATIAL_VARIANCE_SAMPLE_THRESHOLD = 4.0

# ---- parameter vector layout: the host's values first (one copy), then
# the scene's and the view's, which live on the device
_S_MAXLIFE = 0     # max reservoir lifetime (F32_MAX when disabled)
_S_MAXCNT = 1      # max_spatial_reuse_count
_S_TAPS = 2        # per tap: oy, ox, march count, then per march step
#                    (toy, tox, frac) for SPATIAL_TAPS + 1 steps
_TAP_STRIDE = 3 + 3 * (SPATIAL_TAPS + 1)
MAX_TAPS = 16
_S_AMB = _S_TAPS + _TAP_STRIDE * MAX_TAPS   # ambient rgb
_S_CAM = _S_AMB + 3                          # camera world position xyz
_S_COUNT = _S_CAM + 3


def channel_taps(emissive_lit: bool):
    """(tap count, reuse range) of a channel (light.wgsl:1505-1515)."""
    return (8, 10) if emissive_lit else (16, 20)


def spatial_fused_eligible(scene) -> bool:
    """The kernel shades every tap from the material table, so it takes the
    lighting kernel's material cap. Textures and the per-pixel tap scramble
    are rejected for the whole frame (frame.unsupported_*)."""
    return scene["mat_packed"].shape[0] <= MAX_MATERIALS


@functools.lru_cache(maxsize=None)
def _tap_geometry(count_taps: int, reuse_range: float):
    """Per-tap spiral geometry independent of the frame (radius by tap
    index), numpy float32 in hikari_tpu's operation order."""
    f32 = np.float32
    taps = []
    for i in range(1, count_taps + 1):
        fi = f32(i)
        radius = f32(np.sqrt(fi / f32(count_taps))) * f32(reuse_range)
        tap_interval = np.maximum(f32(1.0), radius / f32(SPATIAL_TAPS + 1))
        tap_count = int(radius / tap_interval)
        inv_len = f32(1.0) / np.maximum(radius, f32(1e-5))
        fi_gr = fi * f32(GOLDEN_RATIO)
        march = tuple((f32(j) * tap_interval,
                       f32(j) / (f32(tap_count) + f32(1.0)))
                      for j in range(1, SPATIAL_TAPS + 2) if j <= tap_count)
        taps.append((fi_gr, radius, inv_len, march))
    return tuple(taps)


@functools.lru_cache(maxsize=None)
def _tap_arrays(count_taps: int, reuse_range: float):
    """_tap_geometry as float32 arrays: per tap fi_gr, radius, inv_len and
    its march count, per tap and march step the distance and the fraction
    (zeros past the tap's count)."""
    geo = _tap_geometry(count_taps, reuse_range)
    steps = SPATIAL_TAPS + 1
    tdist = np.zeros((count_taps, steps), np.float32)
    frac = np.zeros((count_taps, steps), np.float32)
    for i, (_, _, _, march) in enumerate(geo):
        for j, (td, fr) in enumerate(march):
            tdist[i, j], frac[i, j] = td, fr
    return (np.array([g[0] for g in geo], np.float32),
            np.array([g[1] for g in geo], np.float32),
            np.array([g[2] for g in geo], np.float32),
            np.array([len(g[3]) for g in geo], np.float32), tdist, frac)


def tap_table(count_taps: int, reuse_range: float, frame_number: int):
    """This frame's taps, the spiral rotated by random_float(frame_number):
    [count_taps, _TAP_STRIDE] float32 rows of oy, ox, the march count, then
    (toy, tox, frac) per march step, zeros past the count. Whole-array
    float32 operations, per tap in hikari_tpu's order (the offsets rounded
    half to even)."""
    fi_gr, radius, inv_len, count, tdist, frac = _tap_arrays(count_taps,
                                                             reuse_range)
    f32 = np.float32
    angle = f32(TAU) * np.mod(fi_gr + random_float(frame_number), f32(1.0))
    off_x = radius * np.cos(angle)
    off_y = radius * np.sin(angle)
    live = np.arange(SPATIAL_TAPS + 1) < count[:, None]
    rows = np.zeros((count_taps, _TAP_STRIDE), f32)
    # + 0 turns the -0.0 of a rounded small negative into 0.0
    rows[:, 0] = np.round(off_y) + f32(0.0)
    rows[:, 1] = np.round(off_x) + f32(0.0)
    rows[:, 2] = count
    for c, off in ((3, off_y), (4, off_x)):
        rows[:, c::3] = np.where(
            live, np.round(tdist * off[:, None] * inv_len[:, None]) + f32(0.0),
            f32(0.0))
    rows[:, 5::3] = frac
    return rows


def tap_offsets(count_taps: int, reuse_range: float, frame_number: int):
    """This frame's integer tap offsets: [(oy, ox, [(toy, tox, frac)...])]
    (tap_table's rows)."""
    out = []
    for row in tap_table(count_taps, reuse_range, frame_number):
        n = int(row[2])
        out.append((int(row[0]), int(row[1]),
                    [(int(row[3 + 3 * j]), int(row[4 + 3 * j]),
                      row[5 + 3 * j]) for j in range(n)]))
    return out


def frame_taps(frame, emissive_lit: bool, device) -> torch.Tensor:
    """This frame's tap_table of the channel on `device`: the frame's
    device words (`taps_e`, `taps_i`; frame.frame_words), or a fresh copy
    of the host's table (a caller outside the frame program)."""
    count_taps, reuse_range = channel_taps(emissive_lit)
    return frame_value(frame, "taps_e" if emissive_lit else "taps_i",
                       lambda: tap_table(count_taps, reuse_range,
                                         int(frame["number"])), device)


def pack_params(scene, view, frame, emissive_lit: bool) -> torch.Tensor:
    """[_S_COUNT] f32 parameter vector on the scene's device, every word on
    the device: the settings' lifetime limit and spatial cap (the frame's
    dynamic words), the frame's taps (frame_taps), zeros past them, the
    ambient colour and the camera position."""
    dev = scene["ambient_color"].device
    count_taps, _ = channel_taps(emissive_lit)
    parts = [dynamic(frame, "spatial_caps", dev),
             frame_taps(frame, emissive_lit, dev).reshape(-1)]
    if count_taps < MAX_TAPS:
        parts.append(const_values(
            np.zeros(_TAP_STRIDE * (MAX_TAPS - count_taps)), dev))
    return torch.cat(parts + [scene["ambient_color"][:3],
                              view["world_position"][:3]])


def _shifted(x, oy, ox):
    """x[y + oy, x + ox] with the coordinates clamped into the image
    (tap values outside it are masked by the caller); x [h,...,w]."""
    h, w = x.shape[0], x.shape[-1]
    yi = torch.clamp(torch.arange(h, device=x.device) + oy, 0, h - 1)
    xi = torch.clamp(torch.arange(w, device=x.device) + ox, 0, w - 1)
    return x.index_select(0, yi).index_select(x.dim() - 1, xi)


def spatial_plain(params, mats, temporal, prev, position, inst_mat, *,
                  emissive_lit: bool):
    """The kernel body over whole planes. Returns (render [h,w,4],
    variance [h,w], spatial planes [h,16,w])."""
    p = params.cpu().numpy()
    h, _, w = temporal.shape
    dev = temporal.device
    px, py, pz, depth = position.unbind(-1)
    valid = depth >= F32_EPSILON
    zero = torch.zeros_like(depth)
    amb = [float(p[_S_AMB + i]) for i in range(3)]
    max_cnt = float(p[_S_MAXCNT])
    v = _rsqrt_n(float(p[_S_CAM]) - px, float(p[_S_CAM + 1]) - py,
                 float(p[_S_CAM + 2]) - pz)
    surf = _Surface(mats, material_ids(inst_mat))

    q0 = rsv.unpack_fields(temporal)
    s_vp = (q0["vpx"], q0["vpy"], q0["vpz"])
    s_vn = (q0["vnx"], q0["vny"], q0["vnz"])
    keep = q0["life"] <= float(p[_S_MAXLIFE])
    win = torch.where(keep[:, None, :], prev, temporal)
    win_is_tap = torch.zeros_like(valid)
    p_cnt, _ = rsv.bf16_unpair(prev[:, 14])
    p_ws, p_w2 = rsv.bf16_unpair(prev[:, 15])
    p_life = (rsv._bits(prev[:, 12]) >> 24).to(torch.float32)
    st = {"w_sum": torch.where(keep, p_ws, q0["w_sum"]),
          "w2_sum": torch.where(keep, p_w2, q0["w2_sum"]),
          "count": torch.where(keep, p_cnt, q0["count"])}
    r_life = torch.where(keep, p_life, q0["life"])

    def shade_lum(ld, q):
        o = _shade(surf, amb, *v, *s_vn, *ld, q["rad_r"], q["rad_g"],
                   q["rad_b"], q["rad_a"])
        return _lum(*o)

    def wrs_step(planes, q, mw, mask, is_tap):
        """merge_reservoir (light.wgsl:175-179) on the running statistics,
        the sample kept as the winner's packed planes."""
        nonlocal win, win_is_tap
        w_new = mw * q["w"] * q["count"]
        ws_n = st["w_sum"] + w_new
        rand = torch.fmod(q["rnd0"] + q["rnd1"] + q["rnd2"] + q["rnd3"], 1.0)
        replace = mask & (rand < div(w_new, torch.clamp(ws_n, min=1e-30)))
        st["w_sum"] = torch.where(mask, ws_n, st["w_sum"])
        st["w2_sum"] = torch.where(mask, st["w2_sum"] + w_new * w_new,
                                   st["w2_sum"])
        st["count"] = torch.where(mask, st["count"] + q["count"],
                                  st["count"])
        win = torch.where(replace[:, None, :], planes, win)
        win_is_tap = (win_is_tap | replace) if is_tap else (
            win_is_tap & ~replace)

    if emissive_lit:
        merge_w0 = _lum(q0["rad_r"], q0["rad_g"], q0["rad_b"])
    else:
        merge_w0 = shade_lum(_rsqrt_n(q0["spx"] - s_vp[0],
                                      q0["spy"] - s_vp[1],
                                      q0["spz"] - s_vp[2]), q0)
    wrs_step(temporal, q0, merge_w0, valid, False)
    use_sp_var = q0["count"] <= SPATIAL_VARIANCE_SAMPLE_THRESHOLD

    yy = torch.arange(h, device=dev)[:, None]
    xx = torch.arange(w, device=dev)[None, :]
    n_taps = channel_taps(emissive_lit)[0]
    for t in range(n_taps):
        row = p[_S_TAPS + _TAP_STRIDE * t:_S_TAPS + _TAP_STRIDE * (t + 1)]
        oy, ox, n_march = int(row[0]), int(row[1]), int(row[2])
        tap = _shifted(temporal, oy, ox)
        q = rsv.unpack_fields(tap)
        sdep = _shifted(depth, oy, ox)
        in_b = ((yy + oy >= 0) & (yy + oy < h) & (xx + ox >= 0)
                & (xx + ox < w))
        # screen-space depth ray-march (light.wgsl:1608-1628)
        occluded = torch.zeros_like(valid)
        for j in range(n_march):
            toy, tox, frac = row[3 + 3 * j:6 + 3 * j]
            ref_depth = depth + (sdep - depth) * float(frac)
            occluded = occluded | (_shifted(depth, int(toy), int(tox))
                                   > ref_depth + 1e-5)
        ratio = div(depth, torch.where(sdep == 0.0, 1e-30, sdep))
        ok = in_b & (ratio >= 0.9) & (ratio <= 1.1)
        ok = ok & (q["count"] >= F32_EPSILON)
        ok = ok & (_dot(*s_vn, q["vnx"], q["vny"], q["vnz"]) >= 0.866)
        sd = _rsqrt_n(q["spx"] - s_vp[0], q["spy"] - s_vp[1],
                      q["spz"] - s_vp[2])
        ok = ok & (_dot(*sd, *s_vn) >= 0.0) & ~occluded
        # GRIS Jacobian (light.wgsl:985-1004)
        tr = _rsqrt_n(s_vp[0] - q["spx"], s_vp[1] - q["spy"],
                      s_vp[2] - q["spz"])
        tq = _rsqrt_n(q["vpx"] - q["spx"], q["vpy"] - q["spy"],
                      q["vpz"] - q["spz"])
        cos1 = torch.abs(_dot(*tr, q["snx"], q["sny"], q["snz"]))
        cos2 = torch.abs(_dot(*tq, q["snx"], q["sny"], q["snz"]))
        term1 = div(cos1, torch.clamp(cos2, min=1e-4))
        ax, ay, az = (q["vpx"] - q["spx"], q["vpy"] - q["spy"],
                      q["vpz"] - q["spz"])
        bx, by, bz = (s_vp[0] - q["spx"], s_vp[1] - q["spy"],
                      s_vp[2] - q["spz"])
        num = ax * ax + ay * ay + az * az
        den = bx * bx + by * by + bz * bz
        term2 = div(num, torch.clamp(den, min=1e-4))
        jac = torch.clamp(term1 * term2, 1.0, 50.0)
        jac = torch.where(q["spw"] > 0.5, jac, 1.0)
        if emissive_lit:
            mw = div(_lum(q["rad_r"], q["rad_g"], q["rad_b"]), jac)
        else:
            mw = div(shade_lum(sd, q), jac)
        wrs_step(tap, q, mw, ok & valid, True)

    # winner epilogue: the visible point and normal stay the centre's
    # unless a tap's sample won
    r = rsv.unpack_fields(win)
    r.update(st)
    r["life"] = r_life
    for k in ("vpx", "vpy", "vpz", "vpd", "vnx", "vny", "vnz"):
        r[k] = torch.where(win_is_tap, r[k], q0[k])
    r = rsv_clamp(r, max_cnt)
    ld = _rsqrt_n(r["spx"] - s_vp[0], r["spy"] - s_vp[1],
                  r["spz"] - s_vp[2])
    o = _shade(surf, amb, *v, *s_vn, *ld, r["rad_r"], r["rad_g"],
               r["rad_b"], r["rad_a"])
    target = (_lum(r["rad_r"], r["rad_g"], r["rad_b"]) if emissive_lit
              else _lum(*o))
    tot = r["count"] * target
    r["w"] = torch.where(tot > 0.0, div(r["w_sum"],
                                        torch.clamp(tot, min=1e-30)), 0.0)
    r["life"] = r["life"] + 1.0
    var = torch.clamp(rsv_variance(r), max=10.0)
    render = torch.stack([torch.where(valid, r["w"] * c, zero) for c in o]
                         + [valid.to(torch.float32)], -1)
    variance = torch.where(valid & use_sp_var, var, float("nan"))
    planes = rsv.pack_fields(rsv.zero_fields_where(~valid, r))
    return render, variance, planes


def spatial_kernel(params, mats, temporal, prev, position, inst_mat, *,
                   emissive_lit: bool):
    """Kernel 10: runs `spatial_plain`."""
    return spatial_plain(params, mats, temporal, prev, position,
                         inst_mat, emissive_lit=emissive_lit)


def spatial_fused(scene, g, view, frame, temporal_planes, prev_sp_planes, *,
                  emissive_lit: bool, render_size):
    """The spatial pass of one channel. temporal_planes: this frame's
    temporal reservoirs [h,16,w] (fused_lighting's {e,i}_packed);
    prev_sp_planes: the previous spatial reservoirs, reprojection-gathered
    and scatter-replaced by the caller. Returns {"render" [h,w,4],
    "variance" [h,w] (NaN where the temporal variance should remain),
    "spatial_planes" [h,16,w]}."""
    params = pack_params(scene, view, frame, emissive_lit)
    render, variance, planes = spatial_kernel(
        params, scene["mat_packed"], temporal_planes, prev_sp_planes,
        g["position"], g["instance_material"], emissive_lit=emissive_lit)
    return {"render": render, "variance": variance, "spatial_planes": planes}
