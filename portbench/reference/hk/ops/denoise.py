"""SVGF-style edge-aware a-trous denoiser (denoise.wgsl), the port of
hikari_tpu/ops/denoise.py without its XLA shift-stencil cascade: the levels
always run through ops/denoise_fused.py (kernel C or its plain version).

Per channel: demodulation (divide out albedo + 3x3 variance prefilter,
denoise.wgsl:135-166), four a-trous levels with steps 8/4/2/1, then
re-modulation by albedo.
"""

from __future__ import annotations

import torch

from portbench.reference.hk.config import ATROUS_KERNEL
from portbench.reference.hk.ops._kernel import div
from portbench.reference.hk.ops.denoise_fused import _shift, denoise_levels_fused
from portbench.reference.hk.ops.restir import resample_deferred
from portbench.reference.hk.utils.math import F32_EPSILON, F32_MAX, normalize

STEPS = (8, 4, 2, 1)


def demodulate(albedo_r, render, variance, render_size):
    """irradiance = render / albedo; variance 3x3 prefilter."""
    alb = albedo_r[..., :3]
    irr = torch.where(alb < 0.01, 0.0,
                      div(render[..., :3], torch.clamp(alb, min=1e-6)))
    var = torch.zeros(render_size, dtype=torch.float32,
                      device=variance.device)
    for oy in (-1, 0, 1):
        for ox in (-1, 0, 1):
            v, ok = _shift(variance, oy, ox)
            k = float(ATROUS_KERNEL[oy + 1, ox + 1])
            var = var + torch.where(ok & (v <= F32_MAX),
                                    k * torch.clamp(v, min=0.0), 0.0)
    return irr, var


def denoise_channels(g, albedo, chans, frame, render_size, ratio: float,
                     albedo_r=None):
    """Denoise several lighting channels in one cascade (the edge-stopping
    geometry weights are shared). chans: list of (render [h,w,4], variance
    [h,w], firefly bool). albedo_r: the albedo at render size, which the
    frame at an exact half takes from the decimated prepass; without it
    the full-res `albedo` goes through resample_deferred at the ratio
    (the identity at ratio 1), as in hikari_tpu/frame.py:566-569. Returns
    the denoised [h,w,4] renders."""
    if albedo_r is None:
        albedo_r = resample_deferred(albedo, render_size, frame["number"],
                                     ratio)
    depth = g["position"][..., 3]
    valid = depth >= F32_EPSILON
    normal = normalize(g["normal"])
    irrs, variances = [], []
    for render, variance, _ in chans:
        irr_c, var_c = demodulate(albedo_r, render, variance, render_size)
        irrs.append(irr_c)
        variances.append(var_c)
    outs_irr = denoise_levels_fused(
        irrs, variances, normal, g["depth_gradient"], depth,
        g["instance_material"][..., 0], [ff for _, _, ff in chans], STEPS)
    ones = torch.ones(tuple(render_size) + (1,), device=depth.device)
    return [torch.where(valid[..., None],
                        torch.cat([oi, ones], -1) * albedo_r, 0.0)
            for oi in outs_irr]
