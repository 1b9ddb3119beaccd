"""Post-process routing (the port of hikari_tpu/ops/post.py): SMAA -> TAA
-> FSR per the settings, then the overlay.

Replicates PostProcessNode::run's texture routing
(post_process.rs:1140-1312, 930-1060): SMAA reads the tone-mapping history
and doubles the working size; TAA reads the SMAA output (or the tone
output) and its own history; FSR (EASU, then RCAS over an alpha of ones)
reads the TAA output (or the tone output) and emits the output size. The
overlay resamples anything else to the camera target and NaN pixels fall
back to albedo (overlay.wgsl:36-47).
"""

from __future__ import annotations

import torch

from portbench.reference.hk.config import HikariSettings, Taa, UpscaleMode
from portbench.reference.hk.ops._kernel import dynamic
from portbench.reference.hk.ops.filters import resize_bilinear
from portbench.reference.hk.ops.fsr import easu, rcas
from portbench.reference.hk.ops.smaa import smaa_tu4x
from portbench.reference.hk.ops.taa import taa_jasmine
from portbench.reference.hk.utils.math import inverse_reinhard_luminance


def post_sizes(settings: HikariSettings, render_size):
    """Static size of the TAA stage's input and history."""
    if settings.upscale.mode == UpscaleMode.SMAA_TU4X:
        return (2 * render_size[0], 2 * render_size[1])
    return tuple(render_size)


def post_chain(gbuf, carry, tone, frame, settings: HikariSettings,
               full_size, render_size, smaa_quads):
    """Returns (final [H,W,4] at full_size, post carry {"prev_tone",
    "prev_taa"} for the stages that ran). smaa_quads: this frame's parity
    context with SMAA (kernel 8's quads or smaa.parity_context's), else
    None. hikari_tpu also carries prev_upscale (the chain's output), which
    it writes and never reads (hikari_tpu/ops/post.py:110); the port
    leaves it out."""
    full_size = tuple(full_size)
    cur = tone
    post_carry = {}
    if settings.upscale.mode == UpscaleMode.SMAA_TU4X:
        cur = smaa_tu4x(smaa_quads, carry["prev_gbuffer"], carry["prev_tone"],
                        tone, frame, render_size)
        post_carry["prev_tone"] = tone
    if settings.taa == Taa.JASMINE:
        cur = taa_jasmine(gbuf, carry["prev_gbuffer"], carry["prev_taa"], cur,
                          frame, dynamic(frame, "clear_color", cur.device),
                          post_sizes(settings, render_size))
        post_carry["prev_taa"] = cur
    if settings.upscale.mode == UpscaleMode.FSR1:
        up = easu(cur, full_size)
        ones = torch.ones(full_size + (1,), device=up.device)
        cur = rcas(torch.cat([up, ones], -1), settings.upscale.sharpness)
    if tuple(cur.shape[:2]) != full_size:
        cur = resize_bilinear(cur, full_size)
    return cur, post_carry


def overlay_compose(image, albedo, hdr: bool):
    """NaN fallback to albedo + optional inverse Reinhard for the HDR path
    (overlay.wgsl:36-47)."""
    bad = ~torch.isfinite(image).all(-1, keepdim=True)
    out = torch.where(bad, albedo, image)
    if hdr:
        rgb = inverse_reinhard_luminance(out[..., :3])
        out = torch.cat([rgb, out[..., 3:4]], -1)
    return out
