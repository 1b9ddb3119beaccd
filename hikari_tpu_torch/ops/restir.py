"""The parts of hikari_tpu/ops/restir.py the ported frames use: the
jittered-deferred G-buffer lookup (the identity at upscale ratio 1; at
ratio 2 the frame takes prepass_fused's decimated planes instead), the
primary surface, the sun-less direct channel, and the per-frame
reprojection (previous-frame coordinates) of the reuse paths."""

from __future__ import annotations

import torch

from hikari_tpu_torch.ops._kernel import div
from hikari_tpu_torch.ops.shading import (compute_emissive_radiance,
                                          retrieve_surface)
from hikari_tpu_torch.utils.math import F32_EPSILON


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


def reprojection(g, render_size):
    """Previous-frame uv, coordinates and bounds shared by every channel
    (light.wgsl:1089). g: render-res G-buffer."""
    uv = pixel_uv(render_size, g["velocity_uv"].device)
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


def resample_deferred(img, render_size, frame_number: int, ratio: float):
    """Jittered-deferred lookup of a full-res [H,W,...] buffer at render
    resolution: the identity at ratio 1, the only ratio it serves (the
    ratio-2 frame reads prepass_fused's decimated planes)."""
    if ratio == 1.0 and tuple(img.shape[:2]) == tuple(render_size):
        return img
    raise NotImplementedError(
        f"upscale ratio {ratio} (render size {render_size}) is not ported")


def resample_gbuffer(gbuf, render_size, frame_number: int, ratio: float):
    """Every G-buffer plane through resample_deferred."""
    return {k: resample_deferred(v, render_size, frame_number, ratio)
            for k, v in gbuf.items()}


def primary_surface(scene, g, no_texture: bool):
    """The G-buffer pixel's material surface (light.wgsl:729-781)."""
    material = g["instance_material"][..., 1].to(torch.int32)
    return retrieve_surface(scene, material, no_texture)


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
