"""Math helpers (the part of hikari_tpu/utils/math.py the port's frames
use): tensor helpers batched over trailing ...x3 / ...x4 axes, and the
per-frame integer hash on the host."""

from __future__ import annotations

import numpy as np
import torch

from hikari_tpu_torch.ops._kernel import div

F32_EPSILON = 1.1920929e-7
F32_MAX = 3.402823466e38
TAU = 6.283185307
INV_TAU = 0.159154943
PI = 3.14159265358979
GOLDEN_RATIO = 1.618033989

# Rec. 709 luminance coefficients.
LUMA = (0.2126, 0.7152, 0.0722)


def luminance(rgb: torch.Tensor) -> torch.Tensor:
    """Rec.709 luminance over the trailing rgb axis."""
    return (LUMA[0] * rgb[..., 0] + LUMA[1] * rgb[..., 1]
            + LUMA[2] * rgb[..., 2])


def dot3(a, b):
    return (a * b).sum(-1)


def normalize(v, eps=1e-20):
    return v * torch.rsqrt(torch.clamp(dot3(v, v), min=eps))[..., None]


def pcg_hash(value) -> np.uint32:
    """Integer hash (utils.wgsl:15-25) of one uint32, on the host."""
    m = np.uint64(0xFFFFFFFF)
    k = np.uint64(2654435769)
    state = (np.uint64(value) & m) ^ np.uint64(2747636419)
    state = (state * k) & m
    state = state ^ (state >> np.uint64(16))
    state = (state * k) & m
    state = state ^ (state >> np.uint64(16))
    state = (state * k) & m
    return np.uint32(state)


def random_float(value) -> np.float32:
    """uint32 -> [0,1] float32 (utils.wgsl:27-29), on the host: one scalar
    per frame (the spatial spiral's rotation)."""
    return np.float32(pcg_hash(value)) / np.float32(4294967295.0)


def perceptual_roughness_to_roughness(perceptual):
    clamped = torch.clamp(perceptual, 0.089, 1.0)
    return clamped * clamped


def rgb_to_ycocg(rgb: torch.Tensor) -> torch.Tensor:
    """Playdead TAA color space (taa.wgsl:20-26); the divisions by powers
    of two are exact."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    y = r / 4.0 + g / 2.0 + b / 4.0
    co = r / 2.0 - b / 2.0
    cg = -r / 4.0 + g / 2.0 - b / 4.0
    return torch.stack([y, co, cg], -1)


def ycocg_to_rgb(ycocg: torch.Tensor) -> torch.Tensor:
    y, co, cg = ycocg[..., 0], ycocg[..., 1], ycocg[..., 2]
    return torch.clamp(torch.stack([y + co - cg, y + cg, y - co - cg], -1),
                       0.0, 1.0)


def clip_towards_aabb_center(prev_color, aabb_min, aabb_max):
    """Variance clipping (taa.wgsl:37-45)."""
    p_clip = 0.5 * (aabb_max + aabb_min)
    e_clip = 0.5 * (aabb_max - aabb_min)
    v_clip = prev_color - p_clip
    v_unit = div(v_clip, torch.where(e_clip == 0.0, 1e-20, e_clip))
    ma_unit = v_unit.abs().amax(-1, keepdim=True)
    clipped = p_clip + div(v_clip, torch.clamp(ma_unit, min=1e-20))
    return torch.where(ma_unit > 1.0, clipped, prev_color)


def change_luminance(c_in, l_out):
    l_in = torch.clamp(luminance(c_in), min=1e-8)
    return c_in * (l_out / l_in)[..., None]


def reinhard_luminance(color):
    """Bevy's luminance-based Reinhard tone map."""
    l_old = luminance(color)
    l_new = l_old / (1.0 + l_old)
    return change_luminance(color, l_new)


def inverse_reinhard_luminance(color):
    """Inverse Reinhard (overlay.wgsl:28-33)."""
    l_old = torch.clamp(luminance(color), 0.0005, 0.995)
    l_new = l_old / (1.0 - l_old)
    return change_luminance(color, l_new)
