"""FXAA 3.11 (console quality): the Bevy FXAA core node of the reference
graph (lib.rs:342-365), the port of hikari_tpu/ops/fxaa.py. Off by default,
like Bevy cameras without the Fxaa component. PyTorch tensor ops in
hikari_tpu's operation order (about 150 ops a call)."""

from __future__ import annotations

import torch

from portbench.reference.hk.ops._kernel import const_values, div, f32
from portbench.reference.hk.ops.filters import bilinear_sample
from portbench.reference.hk.ops.restir import pixel_uv
from portbench.reference.hk.utils.math import luminance

EDGE_THRESHOLD_MIN = 0.0312
EDGE_THRESHOLD_MAX = 0.125
SUBPIXEL_QUALITY = 0.75

# the 8 neighbours FXAA reads, in texels
NEIGHBOURS = ((0, 1), (0, -1), (-1, 0), (1, 0),
              (-1, 1), (1, 1), (-1, -1), (1, -1))


def fxaa(img):
    """Edge-antialias an LDR [H,W,C] image (simplified FXAA 3.11
    quality)."""
    h, w = img.shape[:2]
    uv = pixel_uv((h, w), img.device)
    texel = (f32(1.0 / w), f32(1.0 / h))
    offs = const_values([[du * texel[0], dv * texel[1]]
                         for du, dv in NEIGHBOURS], img.device)
    l_d, l_u, l_l, l_r, l_dl, l_dr, l_ul, l_ur = (
        luminance(bilinear_sample(img, uv + offs[k])[..., :3])
        for k in range(len(NEIGHBOURS)))

    l_c = luminance(img[..., :3])
    l_min = torch.minimum(l_c, torch.minimum(torch.minimum(l_d, l_u),
                                             torch.minimum(l_l, l_r)))
    l_max = torch.maximum(l_c, torch.maximum(torch.maximum(l_d, l_u),
                                             torch.maximum(l_l, l_r)))
    rng = l_max - l_min
    active = rng >= torch.clamp(l_max * EDGE_THRESHOLD_MAX,
                                min=EDGE_THRESHOLD_MIN)

    edge_h = (torch.abs(-2 * l_l + l_ul + l_dl)
              + 2 * torch.abs(-2 * l_c + l_u + l_d)
              + torch.abs(-2 * l_r + l_ur + l_dr))
    edge_v = (torch.abs(-2 * l_u + l_ul + l_ur)
              + 2 * torch.abs(-2 * l_c + l_l + l_r)
              + torch.abs(-2 * l_d + l_dl + l_dr))
    horizontal = edge_h >= edge_v

    l1 = torch.where(horizontal, l_u, l_l)
    l2 = torch.where(horizontal, l_d, l_r)
    grad1 = l1 - l_c
    grad2 = l2 - l_c
    steepest1 = torch.abs(grad1) >= torch.abs(grad2)
    step_len = torch.where(horizontal, texel[1], texel[0])
    step_len = torch.where(steepest1, -step_len, step_len)

    # subpixel blend
    l_avg = div(2.0 * (l_d + l_u + l_l + l_r) + l_dl + l_dr + l_ul + l_ur,
                12.0)
    sub = torch.clamp(div(torch.abs(l_avg - l_c),
                          torch.clamp(rng, min=1e-5)), 0.0, 1.0)
    sub = (-2.0 * sub + 3.0) * sub * sub
    blend = sub * sub * SUBPIXEL_QUALITY

    half = step_len * 0.5
    zero = torch.zeros_like(step_len)
    off = torch.where(horizontal[..., None], torch.stack([zero, half], -1),
                      torch.stack([half, zero], -1))
    out = bilinear_sample(img, uv + off * blend[..., None])
    return torch.where(active[..., None], out, img)
