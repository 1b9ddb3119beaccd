"""The parts of hikari_tpu/ops/restir.py the ported frames use: the
jittered-deferred G-buffer lookup (the identity at upscale ratio 1, the
parity decimation at an exact ratio 2, a separable nearest take at any
other ratio), the primary surface, the full-screen albedo
of the non-fused prepass (textures through kernel 14), the sun-less
direct channel, the per-frame
reprojection (previous-frame coordinates) of the reuse paths, and the
modular lighting channels `direct_lit` and `indirect_lit_ambient` with
and without temporal reuse, with the spatial-reuse tracking, and
`spatial_reuse` with the per-pixel tap scramble (the path of scenes beyond
the fused lighting kernel, of textured scenes, of checkerboard lighting
with temporal reuse, of spatial reuse without temporal reuse and of the
tap scramble).

The modular channels are tensor passes over the flattened [h*w] pixels;
their rays go through the scene's tracer (ops/trace.py: kernels 5, 6, 7,
or kernel 13). Without temporal reuse or spatial tracking they take
hikari_tpu's static no-reuse specializations (plain NEE, zero variance,
the empty reservoir). The spatial buffers stay [h,16,w] channel planes
across the frame, and the cross-pixel invalidation scatters into them
resolve collisions by ops/reservoir.scatter_reservoir_planes' rule."""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.hk.config import frame_parity, validates
from portbench.reference.hk.ops import checkerboard as ckb_ops
from portbench.reference.hk.ops import reservoir as rsv
from portbench.reference.hk.ops import spatial_fused as _sf
from portbench.reference.hk.ops._kernel import div, dynamic, frame_value
from portbench.reference.hk.ops.noise import frame_advance
from portbench.reference.hk.ops.sampling import (RAY_BIAS, occlude_hit_info,
                                           select_light_candidate)
from portbench.reference.hk.ops.shading import (ALL_SLOTS, calculate_view,
                                          compute_emissive_radiance,
                                          env_brdf, input_radiance,
                                          retrieve_surface, shading)
from portbench.reference.hk.utils.math import (F32_EPSILON, F32_MAX,
                                         apply_normal_basis, dot3, luminance,
                                         normalize, sample_cosine_hemisphere)

VALIDATION_COUNT_THRESHOLD = 4.0
SPATIAL_VARIANCE_SAMPLE_THRESHOLD = 4.0


def pixel_uv(size, device=None):
    """Texel-centre uv [h,w,2] (u along x)."""
    h, w = size
    x = div(torch.arange(w, dtype=torch.float32, device=device) + 0.5,
            float(w))
    y = div(torch.arange(h, dtype=torch.float32, device=device) + 0.5,
            float(h))
    v, u = torch.meshgrid(y, x, indexing="ij")
    return torch.stack([u, v], -1)


def uv_to_coords(uv, size):
    """uv -> (y, x) int32 pixel coordinates, truncated and clamped."""
    h, w = size
    x = torch.clamp((uv[..., 0] * w).to(torch.int32), 0, w - 1)
    y = torch.clamp((uv[..., 1] * h).to(torch.int32), 0, h - 1)
    return y, x


def in_unit_box(uv, strict=True):
    d = torch.abs(uv - 0.5)
    return (d < 0.5).all(-1) if strict else (d <= 0.5).all(-1)


def _reprojection(uv, g, render_size):
    previous_uv = uv - g["velocity_uv"][..., :2]
    piy, pix = uv_to_coords(previous_uv, render_size)
    return {
        "uv": uv,
        "previous_uv": previous_uv,
        "piy": piy,
        "pix": pix,
        "in_strict": in_unit_box(previous_uv, strict=True),
        "in_loose": in_unit_box(previous_uv, strict=False),
    }


def reprojection(g, render_size):
    """Previous-frame uv, coordinates and bounds shared by every channel
    (light.wgsl:1089). g: render-res G-buffer."""
    return _reprojection(pixel_uv(render_size, g["velocity_uv"].device), g,
                         render_size)


def reprojection_ckb(g_c, render_size, par: int):
    """`reprojection` of the compressed checkerboard domain: uv are the
    lit pixels' true centres; piy / pix index the full render size."""
    return _reprojection(
        ckb_ops.pixel_uv(render_size, par, g_c["velocity_uv"].device), g_c,
        render_size)


def parity_decimate(planes, parity: int):
    """Full-size [H,W,...] planes at pixels (2y + s, 2x + s), s = the
    frame's parity: the ratio-2 selection of hikari_tpu's resample_deferred
    (restir.py:105-115), which both prepass routes take."""
    return [t[parity::2, parity::2].contiguous() for t in planes]


def deferred_index(n: int, n_full: int, frame_number: int, ratio: float,
                   device=None):
    """The generic branch's index map along one axis (hikari_tpu's
    restir.py:117-119): clip(int((i + 0.5) * ratio + sign), 0, n_full - 1)
    for i < n, sign -0.25 on even frames and +0.25 on odd ones, in float32
    (the ratio rounded to float32, as JAX's weak typing does) and
    truncated toward zero, not floored."""
    sign = -0.25 if frame_parity(frame_number) == 0 else 0.25
    i = torch.arange(n, dtype=torch.float32, device=device)
    x = (i + 0.5) * float(np.float32(ratio)) + sign
    return torch.clamp(x.to(torch.int32).to(torch.int64), 0, n_full - 1)


def resample_deferred(img, render_size, frame_number: int, ratio: float):
    """Jittered-deferred lookup of a full-res [H,W,...] buffer at render
    resolution (hikari_tpu's restir.py:93-120): the identity at ratio 1,
    the parity decimation at ratio 2 when the full size holds twice the
    render size, else the separable nearest take of `deferred_index`."""
    h, w = render_size
    H, W = img.shape[:2]
    if ratio == 1.0 and (H, W) == (h, w):
        return img
    if ratio == 2.0 and H >= 2 * h and W >= 2 * w:
        return parity_decimate([img[:2 * h, :2 * w]],
                               frame_parity(frame_number))[0]
    ys = deferred_index(h, H, frame_number, ratio, img.device)
    xs = deferred_index(w, W, frame_number, ratio, img.device)
    return img.index_select(0, ys).index_select(1, xs)


def resample_gbuffer(gbuf, render_size, frame_number: int, ratio: float):
    """Every G-buffer plane through resample_deferred."""
    return {k: resample_deferred(v, render_size, frame_number, ratio)
            for k, v in gbuf.items()}


def primary_surface(scene, g, no_texture: bool, slots=ALL_SLOTS):
    """The G-buffer pixel's material and texture surface
    (light.wgsl:729-781): its uv field is screen-coherent, so textures are
    sampled through kernel 14. Computed once per frame per G-buffer domain
    and shared by every consumer. `slots`: as retrieve_surface's."""
    material = g["instance_material"][..., 1].to(torch.int32)
    return retrieve_surface(scene, material, g["velocity_uv"][..., 2:4],
                            no_texture, coherent=True, slots=slots)


def full_screen_albedo(scene, gbuf, view, no_texture: bool, surface=None):
    """The env-BRDF albedo of the full-res G-buffer (light.wgsl:1020-1042):
    [H,W,4], alpha 1 on the valid pixels, zeros elsewhere."""
    depth = gbuf["position"][..., 3]
    valid = depth >= F32_EPSILON
    if surface is None:
        surface = primary_surface(scene, gbuf, no_texture)
    v = calculate_view(view, gbuf["position"])
    albedo = env_brdf(surface, v, gbuf["normal"])
    a = torch.cat([albedo, torch.ones_like(depth)[..., None]], -1)
    return torch.where(valid[..., None], a, 0.0)


def emissive_surface_channel(scene, g, no_texture: bool, render_size,
                             surface=None):
    """Direct channel of a scene with no directional light: only the
    surface-emission add of RENDER_EMISSIVE remains (light.wgsl:1237-1247),
    with zero variance. Returns {"render" [h,w,4], "variance" [h,w]}."""
    h, w = render_size
    depth = g["position"][..., 3]
    valid = depth >= F32_EPSILON
    if surface is None:
        surface = primary_surface(scene, g, no_texture)
    out = compute_emissive_radiance(surface["emissive"])
    render = torch.where(
        valid[..., None], torch.cat([out, torch.ones_like(depth)[..., None]],
                                    -1), 0.0)
    return {"render": render,
            "variance": torch.zeros((h, w), device=depth.device)}


# ---------------------------------------------------------------------------
# the modular lighting channels (light.wgsl:1045-1498)
# ---------------------------------------------------------------------------

def cos_solar(frame, device) -> torch.Tensor:
    """cos(solar angle) in float32, [1] on `device` (the frame's dynamic
    word)."""
    return dynamic(frame, "cos_solar", device)


def make_sample_from_gbuffer(g, noise_rand, render_size):
    h, w = render_size
    dev = noise_rand.device
    depth = g["position"][..., 3]
    return rsv.make_sample(
        radiance=torch.zeros((h, w, 4), device=dev),
        random=noise_rand,
        visible_position=torch.cat([g["position"][..., :3],
                                    depth[..., None]], -1),
        visible_normal=g["normal"],
        visible_instance=g["instance_material"][..., 0].to(torch.int32),
        sample_position=torch.zeros((h, w, 4), device=dev),
        sample_normal=torch.zeros((h, w, 3), device=dev))


def _flat(x):
    return x.reshape((-1,) + tuple(x.shape[2:]))


def _unflat(x, size):
    return x.reshape(tuple(size) + tuple(x.shape[1:]))


def _trace_radiance(scene, tracer, cand, info, ro, rd, trace_ok, frame,
                    directional: bool, no_texture: bool):
    """Shadow ray (kernel 7) -> occluded info -> input radiance, zero where
    the candidate cannot be traced. Returns (radiance [N,4], info)."""
    hit = tracer.shadow(scene, ro, rd, cand["max_distance"],
                        cand["emissive_instance"], None)
    info = occlude_hit_info(ro, rd, hit, info)
    rad = input_radiance(
        scene, rd, info["instance"], info["material"], info["uv"],
        sample_directional=directional,
        sample_emissive=cand["emissive_instance"], sample_ambient=False,
        cos_solar=cos_solar(frame, rd.device), no_texture=no_texture)
    return torch.where(trace_ok[:, None], rad, 0.0), info


def _finish_channel(r, s, valid):
    """Visible point := this frame's, lifetime + 1, the variance, and the
    empty reservoir on invalid pixels."""
    r = dict(r)
    r["visible_position"] = s["visible_position"]
    r["visible_normal"] = s["visible_normal"]
    r["lifetime"] = r["lifetime"] + 1.0
    variance = torch.where(valid, rsv.reservoir_variance(r), 0.0)
    return rsv.zero_where(~valid, r), variance


def direct_lit(scene, tracer, g, view, frame, noise_rand, prev_r, *,
               emissive_lit: bool, temporal_reuse: bool, no_texture: bool,
               render_size, surface=None, reproj=None, prev_spatial=None,
               track_spatial: bool = False):
    """One direct-light channel (light.wgsl:1045-1261): the sun
    (emissive_lit=False, RENDER_EMISSIVE: the surface emission is added) or
    the emissives. g: the lighting domain's G-buffer; prev_r: the previous
    temporal reservoir gathered at the reprojected coordinates (the empty
    reservoir without temporal reuse; unused without spatial tracking
    either). With temporal reuse, on the channel's validation frames
    (frame number % interval == 0, a host branch) the carried sample is
    re-traced. With track_spatial the rejected and re-validated reservoirs
    are scattered into the spatial buffer prev_spatial ([h,16,w] planes at
    the render size) at reproj's coordinates (light.wgsl:1092-1095,
    1199-1202). Without either, hikari_tpu's no-reuse specialization
    (restir.py:332-382): plain NEE, zero variance, the empty reservoir.
    Returns {render [h,w,4], variance [h,w], temporal (the new reservoir),
    prev_spatial}."""
    depth = g["position"][..., 3]
    valid = depth >= F32_EPSILON
    s = make_sample_from_gbuffer(g, noise_rand, render_size)
    if surface is None:
        surface = primary_surface(scene, g, no_texture)
    pos_f = _flat(s["visible_position"][..., :3])
    nrm_f = _flat(s["visible_normal"])
    rand_f = _flat(s["random"])
    inst_f = _flat(s["visible_instance"])
    cs = cos_solar(frame, depth.device)

    # this frame's candidate
    cand, info = select_light_candidate(scene, tracer, rand_f, pos_f, nrm_f,
                                        inst_f, cs, emissive_lit)
    ro = pos_f + nrm_f * RAY_BIAS
    rd = cand["direction"]
    trace_ok = (dot3(rd, nrm_f) > 0.0) & (cand["p"] > 0.0)
    if emissive_lit:
        trace_ok = trace_ok & (cand["emissive_instance"] >= 0)
    rad, info = _trace_radiance(scene, tracer, cand, info, ro, rd, trace_ok,
                                frame, not emissive_lit, no_texture)
    lum = luminance(rad)
    w_new = torch.where(cand["p"] > 0.0,
                        div(lum, torch.clamp(cand["p"], min=1e-30)), 0.0)
    if not temporal_reuse and not track_spatial:
        # with an empty previous reservoir the update takes this sample and
        # finalize gives w = w_new / lum: plain NEE, zero variance
        w_f = torch.where(lum > 0.0, div(w_new, torch.clamp(lum, min=1e-30)),
                          0.0)
        l_dir = normalize(_unflat(info["position"], render_size)[..., :3]
                          - s["visible_position"][..., :3])
        out = shading(scene, calculate_view(view, g["position"]),
                      s["visible_normal"], l_dir, surface,
                      _unflat(rad, render_size)) * torch.where(
                          valid, _unflat(w_f, render_size), 0.0)[..., None]
        if not emissive_lit:
            out = out + compute_emissive_radiance(surface["emissive"])
        render = torch.where(valid[..., None], torch.cat(
            [out, torch.ones_like(depth)[..., None]], -1), 0.0)
        return {"render": render, "variance": torch.zeros_like(depth),
                "temporal": rsv.empty_reservoir(render_size, depth.device),
                "prev_spatial": prev_spatial}

    r, reproj_ok = rsv.check_previous_reservoir(prev_r, s)
    if track_spatial:
        prev_spatial = rsv.scatter_reservoir_planes(
            prev_spatial, reproj["piy"], reproj["pix"], r,
            ~reproj_ok & reproj["in_loose"] & valid)
    interval = (frame["emissive_validate_interval"] if emissive_lit
                else frame["direct_validate_interval"])
    is_validation = validates(frame["number"], interval)
    s = dict(s)
    s["radiance"] = _unflat(rad, render_size)
    s["sample_position"] = _unflat(info["position"], render_size)
    s["sample_normal"] = _unflat(info["normal"], render_size)
    w_new = _unflat(w_new, render_size)
    gate = valid & (r["count"] < VALIDATION_COUNT_THRESHOLD) \
        if is_validation else valid
    r = rsv.temporal_restir(r, s, w_new,
                            dynamic(frame, "temporal_cap", depth.device),
                            gate)

    if is_validation and temporal_reuse:
        # re-trace the carried sample (light.wgsl:1156-1213): the candidate
        # from the reservoir's randoms, position and normal, the ray from
        # this pixel's point towards the reservoir's sample, excluding this
        # pixel's instance. Without temporal reuse the reservoir holds only
        # this frame's sample, which hikari_tpu skips statically
        # (restir.py:437-445)
        r_nrm = _flat(r["visible_normal"])
        cand, info = select_light_candidate(
            scene, tracer, _flat(r["random"]),
            _flat(r["visible_position"][..., :3]), r_nrm, inst_f, cs,
            emissive_lit)
        rd = normalize(_flat(r["sample_position"][..., :3]) - pos_f)
        trace_ok = (dot3(cand["direction"], r_nrm) > 0.0) & (cand["p"] > 0.0)
        if emissive_lit:
            trace_ok = trace_ok & (cand["emissive_instance"] >= 0)
        vrad, info = _trace_radiance(scene, tracer, cand, info, ro, rd,
                                     trace_ok, frame, not emissive_lit,
                                     no_texture)
        vrad2 = _unflat(vrad, render_size)
        reuse_validate = r["count"] >= VALIDATION_COUNT_THRESHOLD
        s2 = dict(s)
        for key, val in (("random", r["random"]),
                         ("sample_position",
                          _unflat(info["position"], render_size)),
                         ("sample_normal",
                          _unflat(info["normal"], render_size)),
                         ("radiance", vrad2)):
            s2[key] = torch.where(reuse_validate[..., None], val, s2[key])
        lum_ratio = div(luminance(vrad2),
                        torch.clamp(luminance(r["radiance"]), min=1e-4))
        lum_miss = ((lum_ratio > 1.25) | (lum_ratio < 0.8)) & valid
        if track_spatial:
            prev_spatial = rsv.scatter_reservoir_planes(
                prev_spatial, reproj["piy"], reproj["pix"], r,
                lum_miss & reproj["in_loose"])
        p2 = _unflat(cand["p"], render_size)
        w_new = torch.where(p2 > 0.0, div(luminance(s2["radiance"]),
                                          torch.clamp(p2, min=1e-30)), 0.0)
        r = rsv.where_reservoir(lum_miss, rsv.set_reservoir(s2, w_new), r)
        s = s2

    r = rsv.finalize_w(r, luminance(r["radiance"]))
    r, variance = _finish_channel(r, s, valid)

    # shade (light.wgsl:1233-1259)
    view_dir = calculate_view(view, g["position"])
    l_dir = normalize(r["sample_position"][..., :3]
                      - r["visible_position"][..., :3])
    out = shading(scene, view_dir, r["visible_normal"], l_dir, surface,
                  r["radiance"]) * r["w"][..., None]
    if not emissive_lit:
        out = out + compute_emissive_radiance(surface["emissive"])
    render = torch.where(valid[..., None], torch.cat(
        [out, torch.ones_like(depth)[..., None]], -1), 0.0)
    return {"render": render, "variance": variance, "temporal": r,
            "prev_spatial": prev_spatial}


def indirect_lit_ambient(scene, tracer, g, view, frame, noise_rand, prev_r,
                         *, bounces: int, temporal_reuse: bool,
                         no_texture: bool, render_size, surface=None,
                         reproj=None, prev_spatial=None,
                         track_spatial: bool = False):
    """The indirect channel (light.wgsl:1264-1498): cosine bounces (the
    tracer's with_info), NEE at each bounce hit (its probe and shadow
    rays), the radiance clamp, then temporal ReSTIR of the gathered
    radiance; with track_spatial the rejected reservoirs are scattered into
    prev_spatial as in direct_lit. Without temporal reuse or spatial
    tracking, hikari_tpu's no-reuse specialization (restir.py:631-643):
    the sample's shaded radiance over its pdf, zero variance, the empty
    reservoir. Returns {render, variance, temporal, prev_spatial}."""
    h, w = render_size
    dev = noise_rand.device
    depth = g["position"][..., 3]
    valid = depth >= F32_EPSILON
    normal = normalize(g["normal"])
    s = make_sample_from_gbuffer(g, noise_rand, render_size)
    s["visible_normal"] = normal

    n_pix = h * w
    b_pos = _flat(s["visible_position"][..., :3])
    b_nrm = _flat(normal)
    b_rand = _flat(noise_rand)
    transport = torch.ones((n_pix, 3), device=dev)
    total_rad = torch.zeros((n_pix, 4), device=dev)
    first_pos = torch.zeros((n_pix, 4), device=dev)
    first_nrm = torch.zeros((n_pix, 3), device=dev)
    pdf = torch.zeros((n_pix,), device=dev)
    alive = torch.ones((n_pix,), dtype=torch.bool, device=dev)
    amb = scene["ambient_color"][:3]
    max_ind = dynamic(frame, "max_indirect_luminance", dev)
    cs = cos_solar(frame, dev)
    # frame_number * GOLDEN_RATIO in float32 (restir.py:608): the frame's
    # device word
    advance = frame_value(frame, "advance",
                          lambda: [frame_advance(frame["number"])], dev)

    for n_b in range(bounces):
        local, bounce_pdf = sample_cosine_hemisphere(b_rand[:, :2])
        rd = apply_normal_basis(b_nrm, local)
        ro = b_pos + b_nrm * RAY_BIAS
        info = tracer.with_info(scene, ro, rd,
                                torch.full((n_pix,), F32_MAX, device=dev))
        hit_ok = info["instance"] >= 0
        hit_pos = info["position"][:, :3]
        if n_b == 0:
            first_pos = info["position"]
            first_nrm = info["normal"]
            pdf = bounce_pdf
        b_surface = dict(retrieve_surface(scene, info["material"], info["uv"],
                                          no_texture))
        b_surface["roughness"] = torch.ones_like(b_surface["roughness"])

        cand, cinfo = select_light_candidate(scene, tracer, b_rand, hit_pos,
                                             info["normal"], info["instance"],
                                             cs, True)
        sample_directional = cand["emissive_instance"] < 0
        bounce_view = normalize(b_pos - hit_pos)
        nee_ok = ((dot3(cand["direction"], info["normal"]) > 0.0)
                  & (cand["p"] > 0.0))
        ro2 = hit_pos + info["normal"] * RAY_BIAS
        hit2 = tracer.shadow(scene, ro2, cand["direction"],
                             cand["max_distance"], cand["emissive_instance"],
                             None)
        cinfo = occlude_hit_info(ro2, cand["direction"], hit2, cinfo)
        in_rad = input_radiance(
            scene, cand["direction"], cinfo["instance"], cinfo["material"],
            cinfo["uv"], sample_directional=True,
            sample_emissive=cand["emissive_instance"], sample_ambient=False,
            cos_solar=cs, no_texture=no_texture)
        # NEE radiance only for directional picks or hits on the emitter
        keep = sample_directional | (cinfo["instance"]
                                     == cand["emissive_instance"])
        in_rad = torch.cat([torch.where(keep[:, None], in_rad[:, :3], 0.0),
                            in_rad[:, 3:4]], -1)
        out_rad = shading(scene, bounce_view, info["normal"],
                          cand["direction"], b_surface, in_rad)
        out_rad = div(out_rad, torch.clamp(cand["p"][:, None], min=1e-30))
        if n_b > 0:
            out_rad = torch.where(
                bounce_pdf[:, None] < 0.01, 0.0,
                div(out_rad, torch.clamp(bounce_pdf[:, None], min=1e-30)))
        lum = luminance(out_rad)
        scale = torch.where(lum > max_ind,
                            div(max_ind, torch.clamp(lum, min=1e-30)), 1.0)
        out_rad = out_rad * scale[:, None]
        add = alive & hit_ok & nee_ok
        add_hit = torch.where(add[:, None], transport * out_rad, 0.0)
        total_rad = total_rad + torch.cat(
            [add_hit, add.to(torch.float32)[:, None]], -1)
        add_miss = torch.where((alive & ~hit_ok)[:, None], transport * amb,
                               0.0)
        total_rad = total_rad + torch.cat(
            [add_miss, torch.zeros((n_pix, 1), device=dev)], -1)
        transport = torch.where(
            (alive & hit_ok)[:, None],
            transport * env_brdf(b_surface, bounce_view, info["normal"]),
            transport)
        alive = alive & hit_ok & (transport > 0.01).any(-1)
        b_rand = torch.fmod(b_rand + advance, 1.0)
        b_pos = torch.where(hit_ok[:, None], hit_pos, b_pos)
        b_nrm = torch.where(hit_ok[:, None], info["normal"], b_nrm)

    rad = _unflat(total_rad, render_size)
    s["radiance"] = torch.cat([rad[..., :3],
                               torch.clamp(rad[..., 3:4], max=1.0)], -1)
    s["sample_position"] = _unflat(first_pos, render_size)
    s["sample_normal"] = _unflat(first_nrm, render_size)

    # temporal ReSTIR (light.wgsl:1452-1497)
    if surface is None:
        surface = primary_surface(scene, g, no_texture)
    view_dir = calculate_view(view, g["position"])
    sample_rad = shading(scene, view_dir, s["visible_normal"], normalize(
        s["sample_position"][..., :3] - s["visible_position"][..., :3]),
        surface, s["radiance"])
    pdf2 = _unflat(pdf, render_size)
    lum_s = luminance(sample_rad)
    w_new = torch.where(pdf2 > 0.0, div(lum_s, torch.clamp(pdf2, min=1e-30)),
                        0.0)
    if not temporal_reuse and not track_spatial:
        w2d = torch.where(valid & (lum_s > 0.0),
                          div(w_new, torch.clamp(lum_s, min=1e-30)), 0.0)
        render = torch.where(valid[..., None], torch.cat(
            [sample_rad * w2d[..., None], torch.ones((h, w, 1), device=dev)],
            -1), 0.0)
        return {"render": render,
                "variance": torch.zeros((h, w), device=dev),
                "temporal": rsv.empty_reservoir(render_size, dev),
                "prev_spatial": prev_spatial}
    r, reproj_ok = rsv.check_previous_reservoir(prev_r, s)
    if track_spatial:
        prev_spatial = rsv.scatter_reservoir_planes(
            prev_spatial, reproj["piy"], reproj["pix"], r,
            ~reproj_ok & reproj["in_loose"] & valid)
    r = rsv.temporal_restir(r, s, w_new,
                            dynamic(frame, "temporal_cap", dev), valid)
    out_rad = shading(scene, view_dir, r["visible_normal"], normalize(
        r["sample_position"][..., :3] - r["visible_position"][..., :3]),
        surface, r["radiance"])
    r = rsv.finalize_w(r, luminance(out_rad))
    r, variance = _finish_channel(r, s, valid)
    render = torch.where(valid[..., None], torch.cat(
        [out_rad * r["w"][..., None], torch.ones((h, w, 1), device=dev)], -1),
        0.0)
    return {"render": render, "variance": variance, "temporal": r,
            "prev_spatial": prev_spatial}


# ---------------------------------------------------------------------------
# spatial reuse (light.wgsl:1503-1684)
# ---------------------------------------------------------------------------

def compute_jacobian(q, s):
    """GRIS Jacobian (light.wgsl:985-1004): q the neighbour's reservoir, s
    this pixel's sample."""
    n = q["sample_normal"]
    q_sp = q["sample_position"][..., :3]
    q_vp = q["visible_position"][..., :3]
    s_vp = s["visible_position"][..., :3]
    cos1 = torch.abs(dot3(normalize(s_vp - q_sp), n))
    cos2 = torch.abs(dot3(normalize(q_vp - q_sp), n))
    term1 = div(cos1, torch.clamp(cos2, min=1e-4))
    num = ((q_vp - q_sp) ** 2).sum(-1)
    den = ((s_vp - q_sp) ** 2).sum(-1)
    term2 = div(num, torch.clamp(den, min=1e-4))
    return torch.clamp(term1 * term2, 1.0, 50.0)


def _take2d(x, dy, dx, dims=(0, 1)):
    """out[y, x] = x[y + dy, x + dx], wrapping around the dims' sizes: the
    roll by (-dy, -dx) as one gather per dim, its indices made on the
    device from the 0-d integer tensors dy, dx (the frame's taps), so a
    captured frame serves every rotation. A selection: the words are the
    roll's."""
    for dim, off in zip(dims, (dy, dx)):
        n = x.shape[dim]
        idx = torch.remainder(torch.arange(n, device=x.device) + off, n)
        x = x.index_select(dim, idx)
    return x


def frame_tap_offsets(frame, emissive_lit: bool, device):
    """This frame's spiral taps of the channel as spatial_fused.tap_offsets
    gives them, [(oy, ox, [(toy, tox, frac)...])], with the offsets 0-d
    int64 tensors read from the frame's device words (spatial_fused.
    frame_taps) and the march counts and fractions, which do not depend on
    the frame, as host values."""
    count_taps, reuse_range = _sf.channel_taps(emissive_lit)
    rows = _sf.frame_taps(frame, emissive_lit, device).to(
        torch.int64).unbind(0)
    *_, count, _, frac = _sf._tap_arrays(count_taps, reuse_range)
    out = []
    for i, row in enumerate(rows):
        row = row.unbind(0)
        out.append((row[0], row[1],
                    [(row[3 + 3 * j], row[4 + 3 * j], frac[i, j])
                     for j in range(int(count[i]))]))
    return out


def _rotations(oy, ox, steps):
    """A tap's four 90-degree rotations (hikari_tpu's restir.py:744-750):
    (off_y, off_x), (off_x, -off_y), (-off_y, -off_x), (-off_x, off_y),
    the march steps with them. Rounding half to even is odd-symmetric, so
    the rotated offsets are the frame's integers permuted and negated."""
    def rot(k, y, x):
        return ((y, x), (x, -y), (-y, -x), (-x, y))[k]

    return [(*rot(k, oy, ox), [(*rot(k, ty, tx), fr) for ty, tx, fr in steps])
            for k in range(4)]


def _pick(scramble_bits, vals, mask):
    """Each pixel's value from the rotation its scramble bits name (the one
    value when the tap has no rotations)."""
    out = vals[0]
    for k in range(1, len(vals)):
        out = torch.where(mask(scramble_bits == k), vals[k], out)
    return out


def spatial_reuse(scene, g, view, frame, temporal_r, prev_spatial, reproj, *,
                  emissive_lit: bool, no_texture: bool, render_size,
                  scramble_bits=None, surface=None):
    """The modular spatial ReSTIR pass of one channel at the render size:
    the previous spatial reservoir gathered at reproj's coordinates where
    the temporal lifetime is within max_reservoir_lifetime, this pixel's
    temporal reservoir merged in, then the frame's spiral taps (wrapping
    gathers of the packed temporal reservoirs at the frame's tap offsets,
    frame_tap_offsets, and the occlusion march over the depth) with the
    clamped GRIS Jacobian. temporal_r: this frame's
    temporal reservoirs (structured); prev_spatial: [h,16,w] planes.
    scramble_bits ([h,w] integers in 0..3, HikariSettings.
    spatial_tap_scramble): each tap is evaluated at the four 90-degree
    rotations of the frame's spiral and each pixel takes the one its bits
    name (hikari_tpu's restir.py:744-800).
    Returns {render [h,w,4], variance [h,w] (NaN where the frame keeps the
    temporal variance), spatial (the new reservoir)}."""
    h, w = render_size
    dev = g["position"].device
    depth = g["position"][..., 3]
    valid = depth >= F32_EPSILON
    if surface is None:
        surface = primary_surface(scene, g, no_texture)
    view_dir = calculate_view(view, g["position"])

    q0 = temporal_r
    s = {k: q0[k] for k in ("radiance", "random", "visible_position",
                            "visible_normal", "visible_instance",
                            "sample_position", "sample_normal")}
    s_vp = s["visible_position"][..., :3]
    use_spatial_variance = q0["count"] <= SPATIAL_VARIANCE_SAMPLE_THRESHOLD
    prev_sp = rsv.gather_reservoir_planes(prev_spatial, reproj["piy"],
                                          reproj["pix"], reproj["in_strict"])
    # the lifetime limit (F32_MAX for a lifetime <= 1) and the spatial cap
    caps = dynamic(frame, "spatial_caps", dev)
    r = rsv.where_reservoir(q0["lifetime"] <= caps[0:1], prev_sp, q0)

    def shade(l_dir, radiance):
        return shading(scene, view_dir, s["visible_normal"], l_dir, surface,
                       radiance)

    if emissive_lit:
        merge_w0 = luminance(q0["radiance"])
    else:
        merge_w0 = luminance(shade(normalize(
            s["sample_position"][..., :3] - s_vp), s["radiance"]))
    r = rsv.merge_reservoir(r, q0, merge_w0, valid)
    r["visible_position"] = s["visible_position"]
    r["visible_normal"] = s["visible_normal"]

    temporal_planes = rsv.pack_reservoir_planes(temporal_r)
    ys = torch.arange(h, device=dev)[:, None]
    xs = torch.arange(w, device=dev)[None, :]
    for tap in frame_tap_offsets(frame, emissive_lit, dev):
        variants = [tap] if scramble_bits is None else _rotations(*tap)
        packs, depths, in_bs, occs = [], [], [], []
        for oy, ox, steps in variants:
            packs.append(_take2d(temporal_planes, oy, ox, dims=(0, 2)))
            sample_depth = _take2d(depth, oy, ox)
            depths.append(sample_depth)
            in_bs.append((ys + oy >= 0) & (ys + oy < h) & (xs + ox >= 0)
                         & (xs + ox < w))
            # screen-space depth ray-march occlusion (light.wgsl:1608-1628)
            occluded = torch.zeros_like(valid)
            for toy, tox, frac in steps:
                ref_depth = depth + (sample_depth - depth) * float(frac)
                occluded = occluded | (_take2d(depth, toy, tox)
                                       > ref_depth + 1e-5)
            occs.append(occluded)
        q_planes = _pick(scramble_bits, packs, lambda m: m[:, None, :])
        sample_depth, in_b, occluded = (_pick(scramble_bits, v, lambda m: m)
                                        for v in (depths, in_bs, occs))
        q = rsv.unpack_reservoir_planes(q_planes)
        ratio = div(depth, torch.where(sample_depth == 0.0, 1e-30,
                                       sample_depth))
        ok = in_b & (ratio >= 0.9) & (ratio <= 1.1)
        ok = ok & (q["count"] >= F32_EPSILON)
        ok = ok & (dot3(s["visible_normal"], q["visible_normal"]) >= 0.866)
        sample_dir = normalize(q["sample_position"][..., :3] - s_vp)
        ok = ok & (dot3(sample_dir, s["visible_normal"]) >= 0.0) & ~occluded
        jac = torch.where(q["sample_position"][..., 3] > 0.5,
                          compute_jacobian(q, s), 1.0)
        if emissive_lit:
            mw = div(luminance(q["radiance"]), jac)
        else:
            mw = div(luminance(shade(sample_dir, q["radiance"])), jac)
        r = rsv.merge_reservoir(r, q, mw, ok & valid)

    r = rsv.clamp_reservoir(r, caps[1:2])
    out_rad = shade(normalize(r["sample_position"][..., :3] - s_vp),
                    r["radiance"])
    r = rsv.finalize_w(r, luminance(r["radiance"]) if emissive_lit
                       else luminance(out_rad))
    r["lifetime"] = r["lifetime"] + 1.0
    variance = torch.where(valid & use_spatial_variance,
                           rsv.reservoir_variance(r), float("nan"))
    r = rsv.where_reservoir(valid, r, q0)   # the background keeps q0
    render = torch.where(valid[..., None], torch.cat(
        [r["w"][..., None] * out_rad, torch.ones((h, w, 1), device=dev)],
        -1), 0.0)
    return {"render": render, "variance": variance, "spatial": r}
