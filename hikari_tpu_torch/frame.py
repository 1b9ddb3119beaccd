"""Frame pipeline: the no-reuse branch of hikari_tpu/frame.py.

One frame: fused prepass (kernel A) -> blue noise -> no-reuse lighting
(kernel B; the direct channel is the surface-emission term when the scene
has no sun) -> a-trous denoise (kernel C, four levels) -> tone mapping ->
the pass-through post chain. The carry holds the previous view matrices
(velocity).

Settings outside this slice raise NotImplementedError when the frame
function is built: temporal or spatial reuse, checkerboard lighting, TAA,
any upscaler, textures, and scenes beyond the kernels' caps.
"""

from __future__ import annotations

import torch

from hikari_tpu_torch.config import HikariSettings, Taa, UpscaleMode
from hikari_tpu_torch.ops import light_fused as _lf
from hikari_tpu_torch.ops import prepass_fused as _pf
from hikari_tpu_torch.ops import restir
from hikari_tpu_torch.ops.denoise import denoise_channels
from hikari_tpu_torch.ops.noise import sample_blue_noise
from hikari_tpu_torch.ops.prepass import frame_jitter
from hikari_tpu_torch.ops.tonemap import tone_mapping


def unsupported_settings(settings: HikariSettings):
    """The reasons these settings lie outside the ported slice."""
    reasons = []
    if settings.temporal_reuse:
        reasons.append("temporal_reuse")
    if settings.emissive_spatial_reuse:
        reasons.append("emissive_spatial_reuse")
    if settings.indirect_spatial_reuse and settings.indirect_bounces > 0:
        reasons.append("indirect_spatial_reuse")
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
    """The reasons a compiled scene lies outside the ported slice."""
    reasons = []
    if not no_texture:
        reasons.append("textures")
    for err in (_pf.prepass_caps_error(scene),
                _lf.lighting_caps_error(scene, num_emissives)):
        if err is not None:
            reasons.append(err)
    return reasons


def init_carry(device) -> dict:
    """Persistent frame state of the no-reuse path."""
    eye = torch.eye(4, dtype=torch.float32, device=device)
    return {"prev_view_proj": eye, "prev_inverse_view_proj": eye.clone()}


def build_render_frame(settings: HikariSettings, full_size, scene,
                       no_texture: bool, num_emissives: int = 1,
                       has_sun: bool = True):
    """Returns render_frame(scene, view, frame, noise, carry) -> (image
    [H,W,4], albedo [H,W,4], carry), specialized on the static settings
    and scene facts (emissive count, sun presence). Raises
    NotImplementedError for anything outside the ported slice."""
    reasons = (unsupported_settings(settings)
               + unsupported_scene(scene, no_texture, num_emissives))
    if reasons:
        raise NotImplementedError(
            "outside the ported no-reuse slice: " + ", ".join(reasons))
    # no upscaler: lighting runs at the output size (ratio 1)
    render_size = tuple(full_size)
    ratio = settings.upscale_ratio
    bounces = settings.indirect_bounces

    def render_frame(scene, view, frame, noise, carry):
        prev_view = {"view_proj": carry["prev_view_proj"],
                     "inverse_view_proj": carry["prev_inverse_view_proj"]}
        number = frame["number"]
        jit = frame_jitter(number, settings.taa, settings.upscale.mode)
        gbuf, albedo = _pf.prepass_fused(scene, view, prev_view, jit,
                                         full_size)
        g = restir.resample_gbuffer(gbuf, render_size, number, ratio)
        rand = sample_blue_noise(noise, number, render_size)

        zero_render = torch.zeros(render_size + (4,), device=albedo.device)
        zero_var = torch.zeros(render_size, device=albedo.device)
        fl = {}
        if has_sun or num_emissives > 0 or bounces > 0:
            fl = _lf.fused_lighting(scene, g, view, frame, rand,
                                    has_sun=has_sun,
                                    num_emissives=num_emissives,
                                    bounces=bounces, render_size=render_size)
        if has_sun:
            d_render = fl["d_render"]
        else:
            # the deterministic surface-emission term (no rays)
            d_render = restir.emissive_surface_channel(
                scene, g, no_texture, render_size)["render"]
        e_render = fl.get("e_render", zero_render)
        i_render = fl.get("i_render", zero_render)

        if settings.denoise:
            # firefly filtering off for direct, on for emissive/indirect;
            # the sun-less direct term has zero variance and is left as is
            dn_in, slots = [], []
            if has_sun:
                dn_in.append((d_render, zero_var, False))
                slots.append("d")
            if num_emissives > 0:
                dn_in.append((e_render, zero_var, True))
                slots.append("e")
            if bounces > 0:
                dn_in.append((i_render, zero_var, True))
                slots.append("i")
            if dn_in:
                outs = dict(zip(slots, denoise_channels(
                    g, albedo, dn_in, frame, render_size, ratio)))
                d_render = outs.get("d", d_render)
                e_render = outs.get("e", e_render)
                i_render = outs.get("i", i_render)

        tone = tone_mapping(d_render, e_render, i_render,
                            frame["clear_color"])
        new_carry = {
            "prev_view_proj": view["view_proj"],
            "prev_inverse_view_proj": view["inverse_view_proj"],
        }
        # hikari_tpu's post_chain passes the frame through without SMAA,
        # TAA or an upscaler, the only settings built above
        return tone, albedo, new_carry

    return render_frame
