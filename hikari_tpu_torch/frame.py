"""Frame pipeline: the fused branches of hikari_tpu/frame.py.

One frame: fused prepass (kernel A) -> blue noise -> lighting -> a-trous
denoise (kernel C, four levels) -> tone mapping -> the pass-through post
chain. The lighting is one of

* no reuse: kernel B; the direct channel is the surface-emission term when
  the scene has no sun;
* temporal reuse (path R): one reprojection gather (kernel 9) of every
  active channel's previous reservoirs, then kernel 4, which merges them
  in the lighting kernel and returns the new reservoirs and variances;
* temporal + spatial reuse (path S): the same gather also fetches the
  previous spatial reservoirs, kernel 4 also emits the flags and scatter
  reservoirs, and kernel 10 runs once per spatial channel (emissive,
  indirect) after the scatter-replace.

The carry holds the previous view matrices (velocity) and, with reuse, the
[h,16,w] temporal and spatial reservoir planes.

Settings outside the ported slices raise NotImplementedError when the
frame function is built: checkerboard lighting (with or without temporal
reuse), the spatial tap scramble, spatial reuse without temporal reuse,
TAA, any upscaler, textures, and scenes beyond the kernels' caps.
"""

from __future__ import annotations

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
from hikari_tpu_torch.ops.prepass import frame_jitter
from hikari_tpu_torch.ops.reproj_gather import reproj_gather
from hikari_tpu_torch.ops.tonemap import tone_mapping

TEMPORAL_KEYS = ("direct_temporal", "emissive_temporal", "indirect_temporal")
SPATIAL_KEYS = ("spatial_de", "spatial_indirect")


def _tracks(settings: HikariSettings):
    """(track_de, track_ind): which spatial channels the settings ask for."""
    return (settings.emissive_spatial_reuse,
            settings.indirect_spatial_reuse and settings.indirect_bounces > 0)


def unsupported_settings(settings: HikariSettings):
    """The reasons these settings lie outside the ported slices."""
    reasons = []
    if any(_tracks(settings)):
        if not settings.temporal_reuse:
            reasons.append("spatial reuse without temporal_reuse")
    if settings.checkerboard_lighting:
        reasons.append("checkerboard_lighting")
    if settings.spatial_tap_scramble:
        reasons.append("spatial_tap_scramble")
    if settings.taa != Taa.NONE:
        reasons.append(f"taa={settings.taa.value}")
    if settings.upscale.mode != UpscaleMode.NONE:
        reasons.append(f"upscale={settings.upscale.mode.value}")
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


def init_carry(full_size, settings: HikariSettings, device) -> dict:
    """Persistent frame state: the previous view matrices, and with
    temporal reuse the three [h,16,w] temporal reservoir carries and the
    two spatial ones (all zero: no history)."""
    eye = torch.eye(4, dtype=torch.float32, device=device)
    carry = {"prev_view_proj": eye, "prev_inverse_view_proj": eye.clone()}
    h, w = full_size   # no upscaler: lighting runs at the output size
    for k in carry_keys(settings):
        carry[k] = torch.zeros((h, rsv.PACKED_WIDTH, w), dtype=torch.float32,
                               device=device)
    return carry


def carry_from_jax(carry, settings: HikariSettings, device) -> dict:
    """The port's carry for `settings` from a hikari_tpu frame carry given
    as numpy arrays (the counterpart of scene_from_arrays): the view
    matrices and the [h,16,w] reservoir planes, bit for bit."""
    out = {}
    for k in ("prev_view_proj", "prev_inverse_view_proj") \
            + carry_keys(settings):
        a = np.ascontiguousarray(np.asarray(carry[k], np.float32))
        if k not in ("prev_view_proj", "prev_inverse_view_proj") \
                and a.shape[1] != rsv.PACKED_WIDTH:
            raise ValueError(f"{k}: shape {a.shape}, not the [h,16,w] "
                             "channel planes of the fused paths")
        out[k] = torch.from_numpy(a.copy()).to(device)
    return out


def build_render_frame(settings: HikariSettings, full_size, scene,
                       no_texture: bool, num_emissives: int = 1,
                       has_sun: bool = True):
    """Returns render_frame(scene, view, frame, noise, carry) -> (image
    [H,W,4], albedo [H,W,4], carry), specialized on the static settings
    and scene facts (emissive count, sun presence). Raises
    NotImplementedError for anything outside the ported slices."""
    reasons = (unsupported_settings(settings)
               + unsupported_scene(scene, no_texture, num_emissives))
    if reasons:
        raise NotImplementedError(
            "outside the ported slices: " + ", ".join(reasons))
    # within the caps above, spatial reuse always takes the fused kernel
    fused_sp = spatial_fused_active(scene, settings)
    # no upscaler: lighting runs at the output size (ratio 1)
    render_size = tuple(full_size)
    ratio = settings.upscale_ratio
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
        gbuf, albedo = _pf.prepass_fused(scene, view, prev_view, jit,
                                         full_size)
        g = restir.resample_gbuffer(gbuf, render_size, number, ratio)
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
                    g, albedo, dn_in, frame, render_size, ratio)))
                d_render = outs.get("d", d_render)
                e_render = outs.get("e", e_render)
                i_render = outs.get("i", i_render)

        tone = tone_mapping(d_render, e_render, i_render,
                            frame["clear_color"])
        # hikari_tpu's post_chain passes the frame through without SMAA,
        # TAA or an upscaler, the only settings built above
        return tone, albedo, new_carry

    return render_frame
