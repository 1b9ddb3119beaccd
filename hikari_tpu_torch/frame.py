"""Frame pipeline: the fused branches of hikari_tpu/frame.py.

One frame: fused prepass (kernel A; at upscale ratio 2 the render-size
G-buffer is its strided planes, and SMAA's parity quads come from kernel
8) -> blue noise -> lighting -> a-trous denoise (kernel C, four levels) at
the render size -> tone mapping -> the post chain (SMAA TU4X, TAA Jasmine;
kernels 11 and 12). The lighting is one of

* no reuse: kernel B; the direct channel is the surface-emission term when
  the scene has no sun;
* temporal reuse (path R): one reprojection gather (kernel 9) of every
  active channel's previous reservoirs, then kernel 4, which merges them
  in the lighting kernel and returns the new reservoirs and variances;
* temporal + spatial reuse (path S): the same gather also fetches the
  previous spatial reservoirs, kernel 4 also emits the flags and scatter
  reservoirs, and kernel 10 runs once per spatial channel (emissive,
  indirect) after the scatter-replace.

The carry holds the previous view matrices (velocity); with reuse the
[h,16,w] temporal and spatial reservoir planes at the render size; with
SMAA or TAA the previous full-res G-buffer; with SMAA the previous tone
image (render size); with TAA the previous TAA output (post size).

Settings outside the ported slices raise NotImplementedError when the
frame function is built: FSR, SMAA at any ratio but 2, other ratios than
1 and 2, ratio 2 at an odd output size, checkerboard lighting (with or
without temporal reuse), the spatial tap scramble, spatial reuse without
temporal reuse, textures, and scenes beyond the kernels' caps.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from hikari_tpu_torch.config import HikariSettings, Taa, UpscaleMode
from hikari_tpu_torch.ops import light_fused as _lf
from hikari_tpu_torch.ops import prepass_fused as _pf
from hikari_tpu_torch.ops import reservoir as rsv
from hikari_tpu_torch.ops import restir
from hikari_tpu_torch.ops import spatial_fused as _sf
from hikari_tpu_torch.ops.denoise import denoise_channels
from hikari_tpu_torch.ops.noise import sample_blue_noise
from hikari_tpu_torch.ops.post import post_chain, post_sizes
from hikari_tpu_torch.ops.prepass import frame_jitter
from hikari_tpu_torch.ops.reproj_gather import reproj_gather
from hikari_tpu_torch.ops.tonemap import tone_mapping

TEMPORAL_KEYS = ("direct_temporal", "emissive_temporal", "indirect_temporal")
SPATIAL_KEYS = ("spatial_de", "spatial_indirect")
# the planes of the previous full-res G-buffer the post chain carries
PREV_GBUFFER_KEYS = ("position", "normal", "instance_material",
                     "velocity_uv")


def scaled_size(full_size, ratio: float):
    """ceil(size / ratio) (post_process.rs:1172-1174)."""
    h, w = full_size
    return (max(1, math.ceil(h / ratio)), max(1, math.ceil(w / ratio)))


def _smaa(settings: HikariSettings) -> bool:
    return settings.upscale.mode == UpscaleMode.SMAA_TU4X


def _taa(settings: HikariSettings) -> bool:
    return settings.taa == Taa.JASMINE


def _tracks(settings: HikariSettings):
    """(track_de, track_ind): which spatial channels the settings ask for."""
    return (settings.emissive_spatial_reuse,
            settings.indirect_spatial_reuse and settings.indirect_bounces > 0)


def unsupported_settings(settings: HikariSettings, full_size):
    """The reasons these settings, at output size `full_size`, lie outside
    the ported slices."""
    reasons = []
    ratio = settings.upscale_ratio
    if settings.upscale.mode == UpscaleMode.FSR1:
        reasons.append("upscale=fsr1")
    elif _smaa(settings) and ratio != 2.0:
        reasons.append(f"smaa_tu4x at ratio {ratio}")
    elif ratio not in (1.0, 2.0):
        reasons.append(f"upscale ratio {ratio}")
    elif ratio == 2.0 and (full_size[0] % 2 or full_size[1] % 2):
        reasons.append(f"ratio 2 at the odd output size {tuple(full_size)}")
    if any(_tracks(settings)):
        if not settings.temporal_reuse:
            reasons.append("spatial reuse without temporal_reuse")
    if settings.checkerboard_lighting:
        reasons.append("checkerboard_lighting")
    if settings.spatial_tap_scramble:
        reasons.append("spatial_tap_scramble")
    return reasons


def unsupported_scene(scene, no_texture: bool, num_emissives: int):
    """The reasons a compiled scene lies outside the ported slices."""
    reasons = []
    if not no_texture:
        reasons.append("textures")
    for err in (_pf.prepass_caps_error(scene),
                _lf.lighting_caps_error(scene, num_emissives)):
        if err is not None:
            reasons.append(err)
    return reasons


def spatial_fused_active(scene, settings: HikariSettings) -> bool:
    """The fused spatial path (kernel 10) runs: spatial reuse on top of the
    fused temporal path and a scene within the kernel's material cap
    (hikari_tpu/frame.py:44-76). hikari_tpu's other conditions (no
    checkerboard, no tap scramble, no textures) are settings and scenes
    that unsupported_settings / unsupported_scene reject for the frame."""
    return (any(_tracks(settings)) and settings.temporal_reuse
            and _sf.spatial_fused_eligible(scene))


def carry_keys(settings: HikariSettings):
    """The reservoir carries the frame of these settings reads."""
    if not settings.temporal_reuse:
        return ()
    return TEMPORAL_KEYS + (SPATIAL_KEYS if any(_tracks(settings)) else ())


def post_carry_shapes(full_size, settings: HikariSettings) -> dict:
    """The post chain's carries the frame of these settings reads, with
    their shapes (hikari_tpu/frame.py:103-116): the previous G-buffer at
    full size for SMAA or TAA, the previous tone image (render size) for
    SMAA, the previous TAA output (post size) for TAA."""
    h, w = full_size
    render_size = scaled_size(full_size, settings.upscale_ratio)
    shapes = {}
    if _smaa(settings) or _taa(settings):
        shapes["prev_gbuffer"] = {"position": (h, w, 4), "normal": (h, w, 3),
                                  "instance_material": (h, w, 2),
                                  "velocity_uv": (h, w, 4)}
    if _smaa(settings):
        shapes["prev_tone"] = tuple(render_size) + (4,)
    if _taa(settings):
        shapes["prev_taa"] = post_sizes(settings, render_size) + (4,)
    return shapes


def init_carry(full_size, settings: HikariSettings, device) -> dict:
    """Persistent frame state: the previous view matrices; with temporal
    reuse the three [h,16,w] temporal reservoir carries and the two spatial
    ones at the render size; and the post chain's history
    (post_carry_shapes). All zero: no history."""
    eye = torch.eye(4, dtype=torch.float32, device=device)
    carry = {"prev_view_proj": eye, "prev_inverse_view_proj": eye.clone()}
    h, w = scaled_size(full_size, settings.upscale_ratio)
    for k in carry_keys(settings):
        carry[k] = torch.zeros((h, rsv.PACKED_WIDTH, w), dtype=torch.float32,
                               device=device)

    def zeros(shape):
        if isinstance(shape, dict):
            return {k: zeros(v) for k, v in shape.items()}
        return torch.zeros(shape, dtype=torch.float32, device=device)

    carry.update(zeros(post_carry_shapes(full_size, settings)))
    return carry


def carry_from_jax(carry, settings: HikariSettings, device,
                   full_size=None) -> dict:
    """The port's carry for `settings` from a hikari_tpu frame carry given
    as numpy arrays (the counterpart of scene_from_arrays): the view
    matrices, the [h,16,w] reservoir planes and, given the output size,
    the post chain's history, bit for bit."""
    def tensor(a):
        a = np.ascontiguousarray(np.asarray(a, np.float32))
        return torch.from_numpy(a.copy()).to(device)

    out = {}
    for k in ("prev_view_proj", "prev_inverse_view_proj") \
            + carry_keys(settings):
        out[k] = tensor(carry[k])
        if k in TEMPORAL_KEYS + SPATIAL_KEYS \
                and out[k].shape[1] != rsv.PACKED_WIDTH:
            raise ValueError(f"{k}: shape {tuple(out[k].shape)}, not the "
                             "[h,16,w] channel planes of the fused paths")
    if full_size is not None:
        for k, shape in post_carry_shapes(full_size, settings).items():
            if isinstance(shape, dict):
                out[k] = {p: tensor(carry[k][p]) for p in shape}
            else:
                out[k] = tensor(carry[k])
    return out


def build_render_frame(settings: HikariSettings, full_size, scene,
                       no_texture: bool, num_emissives: int = 1,
                       has_sun: bool = True):
    """Returns render_frame(scene, view, frame, noise, carry) -> (image
    [H,W,4], albedo [H,W,4], carry), specialized on the static settings
    and scene facts (emissive count, sun presence). Raises
    NotImplementedError for anything outside the ported slices."""
    reasons = (unsupported_settings(settings, full_size)
               + unsupported_scene(scene, no_texture, num_emissives))
    if reasons:
        raise NotImplementedError(
            "outside the ported slices: " + ", ".join(reasons))
    # within the caps above, spatial reuse always takes the fused kernel
    fused_sp = spatial_fused_active(scene, settings)
    full_size = tuple(full_size)
    ratio = settings.upscale_ratio
    render_size = scaled_size(full_size, ratio)
    half = ratio == 2.0     # an exact half within the checks above
    post_history = _smaa(settings) or _taa(settings)
    bounces = settings.indirect_bounces
    reuse = settings.temporal_reuse
    track_de, track_ind = _tracks(settings)
    # channels that trace rays this configuration
    active = (has_sun, num_emissives > 0, bounces > 0)
    any_active = any(active)
    sp_sources = []
    if fused_sp:
        if track_de and num_emissives > 0:
            sp_sources.append("spatial_de")
        if track_ind:
            sp_sources.append("spatial_indirect")

    # the empty reservoir's planes, broadcast over [h,16,w]
    empty = rsv.pack_reservoir_planes(
        rsv.empty_reservoir((1, 1), scene["tri_pos_flat"].device))

    def apply_scatters(fl, reproj, prev_p, slots):
        """The spatial-buffer invalidation scatters of the modular path
        (restir.py:267-271, 414-417) as a per-pixel replace: they target
        the coordinates the gather just read."""
        in_loose = reproj["in_loose"]
        for slot in slots:
            flags = fl[f"{slot}_flags"]
            gate_m = (torch.fmod(flags, 2.0) >= 1.0) & in_loose
            prev_p = torch.where(gate_m[:, None, :], empty, prev_p)
            if f"{slot}_scatter" in fl:
                val_m = (flags >= 2.0) & in_loose
                prev_p = torch.where(val_m[:, None, :],
                                     fl[f"{slot}_scatter"], prev_p)
        return prev_p

    def render_frame(scene, view, frame, noise, carry):
        prev_view = {"view_proj": carry["prev_view_proj"],
                     "inverse_view_proj": carry["prev_inverse_view_proj"]}
        number = frame["number"]
        jit = frame_jitter(number, settings.taa, settings.upscale.mode)
        albedo_r = smaa_quads = None
        if half:
            # the render-size G-buffer: kernel A's strided planes
            gbuf, albedo, g, albedo_r = _pf.prepass_fused(
                scene, view, prev_view, jit, full_size,
                dec_parity=number & 1)
        else:
            gbuf, albedo = _pf.prepass_fused(scene, view, prev_view, jit,
                                             full_size)
            g = restir.resample_gbuffer(gbuf, render_size, number, ratio)
        if _smaa(settings):
            smaa_quads = _pf.prepass_fused_quads(scene, view, prev_view, jit,
                                                 full_size)
        rand = sample_blue_noise(noise, number, render_size)
        dev = albedo.device
        zero_render = torch.zeros(render_size + (4,), device=dev)
        zero_var = torch.zeros(render_size, device=dev)
        new_carry = {
            "prev_view_proj": view["view_proj"],
            "prev_inverse_view_proj": view["inverse_view_proj"],
        }

        gathered, sp_gathered, reproj = [], {}, None
        if reuse and any_active:
            # one gather launch for every active temporal channel and
            # spatial source; pixels outside the strict unit box read -1
            reproj = restir.reprojection(g, render_size)
            piy_m = torch.where(reproj["in_strict"], reproj["piy"],
                                -1).to(torch.int32).contiguous()
            keys = [TEMPORAL_KEYS[c] for c in range(3) if active[c]]
            outs = reproj_gather([carry[k] for k in keys + sp_sources],
                                 piy_m, reproj["pix"].contiguous())
            gathered = outs[:len(keys)]
            sp_gathered = dict(zip(sp_sources, outs[len(keys):]))

        fl = {}
        if any_active:
            fl = _lf.fused_lighting(
                scene, g, view, frame, rand, has_sun=has_sun,
                num_emissives=num_emissives, bounces=bounces,
                render_size=render_size, temporal=reuse,
                prev_planes=gathered, track_de=track_de and fused_sp,
                track_ind=track_ind and fused_sp)
        if reuse:
            for c, slot in enumerate("dei"):
                k = TEMPORAL_KEYS[c]
                new_carry[k] = fl[f"{slot}_packed"] if active[c] else carry[k]
            for k in SPATIAL_KEYS:
                if k in carry:
                    new_carry[k] = carry[k]

        def var_of(slot):
            return fl[f"{slot}_var"] if reuse else zero_var

        if has_sun:
            d_render, d_var = fl["d_render"], var_of("d")
        else:
            # the deterministic surface-emission term (no rays)
            d = restir.emissive_surface_channel(scene, g, no_texture,
                                                render_size)
            d_render, d_var = d["render"], d["variance"]
        e_render = fl.get("e_render", zero_render)
        e_var = var_of("e") if active[1] else zero_var
        i_render = fl.get("i_render", zero_render)
        i_var = var_of("i") if active[2] else zero_var

        if "spatial_de" in sp_gathered:
            prev_de = apply_scatters(
                fl, reproj, sp_gathered["spatial_de"],
                [s for s, on in (("d", has_sun), ("e", True)) if on])
            sp = _sf.spatial_fused(scene, g, view, frame, fl["e_packed"],
                                   prev_de, emissive_lit=True,
                                   render_size=render_size)
            new_carry["spatial_de"] = sp["spatial_planes"]
            e_render = sp["render"]
            e_var = torch.where(torch.isnan(sp["variance"]), e_var,
                                sp["variance"])
        if "spatial_indirect" in sp_gathered:
            prev_ind = apply_scatters(fl, reproj,
                                      sp_gathered["spatial_indirect"], ["i"])
            sp = _sf.spatial_fused(scene, g, view, frame, fl["i_packed"],
                                   prev_ind, emissive_lit=False,
                                   render_size=render_size)
            new_carry["spatial_indirect"] = sp["spatial_planes"]
            i_render = sp["render"]
            i_var = torch.where(torch.isnan(sp["variance"]), i_var,
                                sp["variance"])

        if settings.denoise:
            # firefly filtering off for direct, on for emissive/indirect;
            # the sun-less direct term has zero variance and is left as is
            dn_in, slots = [], []
            if has_sun:
                dn_in.append((d_render, d_var, False))
                slots.append("d")
            if active[1]:
                dn_in.append((e_render, e_var, True))
                slots.append("e")
            if active[2]:
                dn_in.append((i_render, i_var, True))
                slots.append("i")
            if dn_in:
                outs = dict(zip(slots, denoise_channels(
                    g, albedo, dn_in, frame, render_size, ratio,
                    albedo_r=albedo_r)))
                d_render = outs.get("d", d_render)
                e_render = outs.get("e", e_render)
                i_render = outs.get("i", i_render)

        tone = tone_mapping(d_render, e_render, i_render,
                            frame["clear_color"])
        image, post_carry = post_chain(gbuf, carry, tone, frame, settings,
                                       full_size, render_size, smaa_quads)
        new_carry.update(post_carry)
        if post_history:
            new_carry["prev_gbuffer"] = {k: gbuf[k]
                                         for k in PREV_GBUFFER_KEYS}
        return image, albedo, new_carry

    return render_frame
