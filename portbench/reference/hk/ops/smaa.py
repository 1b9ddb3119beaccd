"""Filmic SMAA TU4X checkerboard temporal upscaler (smaa.wgsl:81-271), the
port of hikari_tpu/ops/smaa.py at every ratio in [1, 2].

It renders at the render size with alternating diagonal jitter into an
output grid of twice the render size; each frame fills 2 of the 4 pixels
of every output quad (the current sample and the reprojected history
with clip rejection), and the extrapolate pass fills the other diagonal by
differential blending of N/E/S/W luminance gradients. The current
G-buffer is read at output coords 2c + parity + k through a parity
context (hikari_tpu's _parity_ctx): where the G-buffer holds exactly
twice the render size (ratio 2 at an even output size), its four parity
quads (kernel 8's planes, or the G-buffer's strided views,
`parity_quads`), whose taps are static shifts; otherwise (ratio-1
supersampling, other ratios, odd sizes) the G-buffer's own planes
(`Direct`), sampled by hikari_tpu's _parity_sample through the nearest
take of `generic_index` (its static strided offsets at the render size
or twice it are the same integers). The two history fetches are
kernel 11 (previous tone, nearest) and kernel 12 (previous depth /
instance / velocity, nearest, bf16 window).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from portbench.reference.hk.config import frame_parity
from portbench.reference.hk.ops import warp2 as _w2
from portbench.reference.hk.ops import warp_band as _wb
from portbench.reference.hk.ops._kernel import div
from portbench.reference.hk.ops.filters import shift_edge
from portbench.reference.hk.ops.taa import dilate_velocity, max_pool_edge
from portbench.reference.hk.utils.math import (TAU, clip_towards_aabb_center,
                                         luminance, rgb_to_ycocg,
                                         ycocg_to_rgb)

_BIAS = 2.5


def parity_quads(gbuf):
    """A full-res G-buffer as SMAA's parity quads, strided views: {(a, b):
    {"depth", "velocity", "instance"}} of pixels (2y+a, 2x+b), the planes
    kernel 8 copies (hikari_tpu's _parity_ctx on an even-size G-buffer,
    smaa.py:53-67)."""
    return {(a, b): {"depth": gbuf["position"][a::2, b::2, 3],
                     "velocity": gbuf["velocity_uv"][a::2, b::2, :2],
                     "instance": gbuf["instance_material"][a::2, b::2, 0]}
            for a in (0, 1) for b in (0, 1)}


@dataclasses.dataclass(frozen=True)
class Direct:
    """hikari_tpu's "direct" parity context: SMAA's three planes
    ({"depth", "velocity", "instance"}) at the G-buffer's own size, read
    through `sample_full` at the render size."""

    planes: dict
    render_size: tuple


def parity_context(gbuf, render_size):
    """SMAA's reads of the full-res G-buffer `gbuf` (hikari_tpu's
    _parity_ctx, smaa.py:53-65): its parity quads where it holds twice
    the render size, else `Direct` over its planes."""
    h, w = render_size
    H, W = gbuf["position"].shape[:2]
    if H < 2 * h or W < 2 * w:
        return Direct({"depth": gbuf["position"][..., 3],
                       "velocity": gbuf["velocity_uv"][..., :2],
                       "instance": gbuf["instance_material"][..., 0]},
                      tuple(render_size))
    return parity_quads({k: gbuf[k][:2 * h, :2 * w]
                         for k in ("position", "velocity_uv",
                                   "instance_material")})


def generic_index(n: int, n_full: int, j: int, k: int, device=None):
    """hikari_tpu's _parity_sample_generic index map along one axis
    (smaa.py:90-97): clip(floor((2i + j + k + 0.5) * (n_full / (2n))),
    0, n_full - 1) for i < n, in float32 with the quotient rounded to
    float32 first."""
    i = torch.arange(n, dtype=torch.float32, device=device)
    x = (2.0 * i + float(j + k) + 0.5) * float(np.float32(n_full / (2 * n)))
    return torch.clamp(torch.floor(x).to(torch.int64), 0, n_full - 1)


def sample_full(full, parity: int, render_size, ky: int = 0, kx: int = 0):
    """`full` [H,W,...] sampled (nearest) at output coords (2c + parity +
    k) of each render-size pixel c, the output grid twice the render size
    (hikari_tpu's _parity_sample). Its static strided offsets, taken
    where H and W are each the render size or twice it, are the integers
    `generic_index` gives there (quotient 0.5 or 1.0, exact in float32),
    so one take serves every size."""
    rh, rw = render_size
    H, W = full.shape[:2]
    ys = generic_index(rh, H, parity, ky, full.device)
    xs = generic_index(rw, W, parity, kx, full.device)
    return full.index_select(0, ys).index_select(1, xs)


def parity_sample(ctx, key, parity: int, ky: int = 0, kx: int = 0):
    """ctx[key] at output coords (2c + parity + k) for each render-res
    pixel c. Parity quads: a clamp-to-edge shift of one quad (hikari_tpu's
    _parity_sample_ctx; the clamp acts on the decimated plane); `Direct`:
    sample_full."""
    if isinstance(ctx, Direct):
        return sample_full(ctx.planes[key], parity, ctx.render_size, ky, kx)
    jy, jx = ky + parity, kx + parity
    return shift_edge(ctx[(jy % 2, jx % 2)][key], jy // 2, jx // 2)


def smaa_tu4x(quads, prev_gbuf, prev_tone, tone, frame, render_size):
    """Pass 1 + 2; returns [2rh, 2rw, 4]. quads: the parity context of the
    current frame's G-buffer (`parity_context`, or kernel 8's planes
    {(a, b): {"depth", "velocity", "instance"}});
    prev_gbuf at output (full) res; tone / prev_tone at render res."""
    rh, rw = render_size
    oh, ow = 2 * rh, 2 * rw
    dev = tone.device
    even_frame = frame_parity(frame["number"]) == 0
    prev_j = 1 if even_frame else 0

    current_color = tone[..., :3]

    def depth_at(ky, kx):
        return parity_sample(quads, "depth", prev_j, ky, kx)

    # velocity at previous_output_uv with 4-diagonal max-depth dilation
    velocity = dilate_velocity(
        depth_at, lambda ky, kx: parity_sample(quads, "velocity", prev_j,
                                               ky, kx))
    depth0 = depth_at(0, 0)

    # previous_output_uv (output space) and the reprojected source coords
    cy = (2.0 * torch.arange(rh, dtype=torch.float32, device=dev)
          + float(prev_j) + 0.5)[:, None].expand(rh, rw)
    cx = (2.0 * torch.arange(rw, dtype=torch.float32, device=dev)
          + float(prev_j) + 0.5)[None, :].expand(rh, rw)
    reproj_uy = div(cy, float(oh)) - velocity[..., 1]
    reproj_ux = div(cx, float(ow)) - velocity[..., 0]
    boundary_miss = ((reproj_ux < 0.0) | (reproj_ux > 1.0)
                     | (reproj_uy < 0.0) | (reproj_uy > 1.0))

    prev_color, = _wb.warp_band([prev_tone[..., :3]], ("nearest",),
                                reproj_uy * rh - 0.5, reproj_ux * rw - 0.5)

    # the footprint max of the previous depth replaces the reference's
    # 5-bias x 4-corner probes (ANY over the footprint)
    pooled = max_pool_edge(prev_gbuf["position"][..., 3], 3)
    # instance ids ride the bf16 window mod 256 (exact in bf16 below 256;
    # the comparison wraps both sides)
    pg = torch.cat([pooled[..., None],
                    torch.remainder(prev_gbuf["instance_material"][..., 0:1],
                                    256.0),
                    prev_gbuf["velocity_uv"][..., :2]], -1)
    cur_instance = torch.remainder(
        parity_sample(quads, "instance", prev_j), 256.0)
    cur_depth = depth0

    aux, = _w2.warp_multi(pg, reproj_uy * oh - 0.5, reproj_ux * ow - 0.5,
                          [("nearest", (0.0, 0.0), (0, 4))],
                          dtype=torch.bfloat16)
    pmax = aux[..., 0]
    pinst = aux[..., 1]
    pvel = aux[..., 2:4]

    depth_miss = (cur_depth == 0.0) | ((pmax > 0.0) & (
        div(cur_depth, torch.clamp(pmax, min=1e-30)) < 0.95))
    instance_miss = depth_miss & (torch.abs(pinst - cur_instance) > 1.0)
    dv = velocity - pvel
    velocity_miss = torch.sqrt(dv[..., 0] * dv[..., 0]
                               + dv[..., 1] * dv[..., 1]) > 1e-4
    need_clip = boundary_miss | ((depth_miss | instance_miss) & velocity_miss)

    # the bias minimizing the current-depth distance (gather4 corners of
    # position.w at output coords 2c + prev_j + bias)
    biases = [(0.0, 0.0), (_BIAS, _BIAS), (-_BIAS, _BIAS), (_BIAS, -_BIAS),
              (-_BIAS, -_BIAS)]
    min_ds = torch.full(render_size, 10.0, device=dev)
    best_bias = torch.zeros(render_size, dtype=torch.int64, device=dev)
    for bi, (bx, by) in enumerate(biases):
        # hikari_tpu sums from 0: exact, so the sum starts at its first term
        dds = None
        for ky in (0, 1):
            for kx in (0, 1):
                e = cur_depth - depth_at(math.floor(by - 0.5) + ky,
                                         math.floor(bx - 0.5) + kx)
                dds = e * e if dds is None else dds + e * e
        dds = torch.sqrt(dds)
        best_bias = torch.where(dds < min_ds, bi, best_bias)
        min_ds = torch.minimum(min_ds, dds)

    # 2x2 YCoCg variance clip from the current tone quad around
    # previous_output_uv + bias (tone coord c + (prev_j + 0.5 + bias)/2 -
    # 0.5: static corners per bias)
    s_mm = rgb_to_ycocg(torch.clamp(current_color, 0.0, 1.0))
    s_sq = s_mm * s_mm
    shifted = {}

    def ycc_at(dy, dx):
        if (dy, dx) not in shifted:
            shifted[(dy, dx)] = (shift_edge(s_mm, dy, dx),
                                 shift_edge(s_sq, dy, dx))
        return shifted[(dy, dx)]

    prev_ycc = rgb_to_ycocg(prev_color)
    clipped = None
    for bi, (bx, by) in enumerate(biases):
        y0 = math.floor((prev_j + 0.5 + by) / 2.0 - 0.5)
        x0 = math.floor((prev_j + 0.5 + bx) / 2.0 - 0.5)
        m1, m2 = ycc_at(y0, x0)
        for ky, kx in ((0, 1), (1, 0), (1, 1)):
            a, a2 = ycc_at(y0 + ky, x0 + kx)
            m1 = m1 + a
            m2 = m2 + a2
        mean = m1 / 4.0
        var = torch.sqrt(torch.clamp(m2 / 4.0 - mean * mean, min=0.0))
        variant = ycocg_to_rgb(clip_towards_aabb_center(
            prev_ycc, mean - var, mean + var))
        clipped = variant if clipped is None else torch.where(
            (best_bias == bi)[..., None], variant, clipped)
    prev_color = torch.where(need_clip[..., None], clipped, prev_color)

    # sub-pixel velocity differential remix (smaa.wgsl:218-227)
    # velocity / (2 texel), texel = (1/ow, 1/oh) as float32
    subpix = torch.remainder(torch.stack(
        [div(velocity[..., 0], 2.0 * float(np.float32(1.0 / ow))),
         div(velocity[..., 1], 2.0 * float(np.float32(1.0 / oh)))], -1), 1.0)
    blend = torch.clamp(-torch.cos(torch.maximum(subpix[..., 0],
                                                 subpix[..., 1]) * TAU),
                        0.0, 1.0)
    # remix: the linear sample of the current tone at previous_output_uv,
    # tone coord c + prev_j / 2 - 0.25
    off = prev_j / 2.0 - 0.25
    lo = math.floor(off)
    frac = off - lo
    remix = (shift_edge(current_color, lo, lo) * (1 - frac) * (1 - frac)
             + shift_edge(current_color, lo, lo + 1) * frac * (1 - frac)
             + shift_edge(current_color, lo + 1, lo) * (1 - frac) * frac
             + shift_edge(current_color, lo + 1, lo + 1) * frac * frac)
    prev_color = prev_color + (remix - prev_color) * blend[..., None]

    one = torch.ones(render_size + (1,), device=dev)
    cur4 = torch.cat([current_color, one], -1)
    prev4 = torch.cat([torch.clamp(prev_color, 0.0, 1.0), one], -1)
    p00, p11 = (cur4, prev4) if even_frame else (prev4, cur4)

    # ---- extrapolate pass (smaa.wgsl:239-271); its neighbours wrap
    def qshift(img, dy, dx):
        return torch.roll(img, (-dy, -dx), (0, 1))

    t_c, b_c = p00, p11
    n_c = qshift(p11, -1, 0)
    e_c = qshift(p00, 0, 1)
    s_c = qshift(p00, 1, 0)
    w_c = qshift(p11, 0, -1)

    def lum_diff(a, b):
        return luminance(torch.abs(a[..., :3] - b[..., :3]))

    factor_x = (torch.clamp(lum_diff(t_c, s_c), min=1e-3)
                * torch.clamp(lum_diff(n_c, b_c), min=1e-3))
    factor_y = (torch.clamp(lum_diff(w_c, b_c), min=1e-3)
                * torch.clamp(lum_diff(t_c, e_c), min=1e-3))
    factor_z = div(1.0, factor_x + factor_y)

    def diff_blend(t, b, l, r):
        color = (l + r) * factor_x[..., None] + (t + b) * factor_y[..., None]
        return 0.5 * factor_z[..., None] * color

    x_color = diff_blend(t_c, s_c, w_c, b_c)
    y_color = diff_blend(n_c, b_c, t_c, e_c)
    # out[2y + o, 2x + i]: (0,0) p00, (0,1) y_color, (1,0) x_color, (1,1) p11
    quad = torch.stack([torch.stack([p00, y_color], 2),
                        torch.stack([x_color, p11], 2)], 1)
    return quad.reshape(oh, ow, 4)
