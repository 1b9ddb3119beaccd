"""The overlay of hikari_tpu/ops/post.py. Its post chain (SMAA, TAA,
upscalers) is not ported: at the settings the port supports it passes the
tone-mapped frame through (frame.py)."""

from __future__ import annotations

import torch

from hikari_tpu_torch.utils.math import inverse_reinhard_luminance


def overlay_compose(image, albedo, hdr: bool):
    """NaN fallback to albedo + optional inverse Reinhard for the HDR path
    (overlay.wgsl:36-47)."""
    bad = ~torch.isfinite(image).all(-1, keepdim=True)
    out = torch.where(bad, albedo, image)
    if hdr:
        rgb = inverse_reinhard_luminance(out[..., :3])
        out = torch.cat([rgb, out[..., 3:4]], -1)
    return out
