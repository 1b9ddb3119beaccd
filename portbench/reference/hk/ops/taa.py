"""TAA "Jasmine" (taa.wgsl:75-170), the port of hikari_tpu/ops/taa.py:
velocity dilation via the 4-neighbour max depth, Catmull-Rom history
resample, disocclusion tests (boundary / depth ratio / position distance /
velocity distance) gating a 3x3 YCoCg variance clip, then the blend
mix(prev, curr, 0.1 / upscale_ratio).

Every current-frame tap is a static clamp-to-edge shift; every history tap
is at uv - velocity and comes from one call of kernel 11 (ops/warp_band):
Catmull-Rom over the previous output's rgb, nearest over the previous
position, the pooled previous depth and the previous velocity.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.hk.ops import warp_band as _wb
from portbench.reference.hk.ops._kernel import div, values_on
from portbench.reference.hk.ops.filters import resize_bilinear, shift_edge
from portbench.reference.hk.utils.math import (clip_towards_aabb_center,
                                         rgb_to_ycocg, ycocg_to_rgb)

# the four diagonal neighbours (dy, dx) of the velocity dilation, in
# hikari_tpu's order: (+1,+1), (+1,-1), (-1,+1), (-1,-1)
DIAGONALS = ((1, 1), (1, -1), (-1, 1), (-1, -1))


def _resample_to(img, size):
    if tuple(img.shape[:2]) == tuple(size):
        return img
    return resize_bilinear(img, size)


def dilate_velocity(depth_at, vel_at):
    """The velocity of the nearest (max-depth) diagonal neighbour where it
    is nearer than the centre. depth_at(dy, dx) / vel_at(dy, dx): the depth
    and velocity planes shifted by (dy, dx). Ties sum their offsets, as
    hikari_tpu's do: two tied maxima at opposite x give ox = 0, and then no
    candidate is taken."""
    depths = [depth_at(dy, dx) for dy, dx in DIAGONALS]
    max_depth = torch.stack(depths, -1).amax(-1)
    m = [(d == max_depth).to(torch.float32) for d in depths]
    # the offsets' sums are small integers: exact in any order
    ox = m[0] - m[1] + m[2] - m[3]
    oy = m[0] + m[1] - m[2] - m[3]
    dilate = depth_at(0, 0) < max_depth
    out = vel_at(0, 0)
    for sy in (-1, 1):
        for sx in (-1, 1):
            take = dilate & (oy == sy) & (ox == sx)
            out = torch.where(take[..., None], vel_at(sy, sx), out)
    return out


def nearest_velocity(gbuf_pos, gbuf_vel):
    """Velocity dilation (taa.wgsl:56-73) over static shifts."""
    depth = gbuf_pos[..., 3]
    vel = gbuf_vel[..., :2]
    return dilate_velocity(lambda dy, dx: shift_edge(depth, dy, dx),
                           lambda dy, dx: shift_edge(vel, dy, dx))


def max_pool_edge(plane, r: int):
    """Separable (2r+1)^2 max over clamp-to-edge shifts."""
    pooled_y = plane
    for dy in range(-r, r + 1):
        if dy:
            pooled_y = torch.maximum(pooled_y, shift_edge(plane, dy, 0))
    pooled = pooled_y
    for dx in range(-r, r + 1):
        if dx:
            pooled = torch.maximum(pooled, shift_edge(pooled_y, 0, dx))
    return pooled


def taa_jasmine(gbuf, prev_gbuf, prev_taa, current, frame, clear_color,
                size):
    """current: this frame's input at `size`; prev_taa: last frame's
    output. gbuf / prev_gbuf are full-res; `size` is the working
    (post-SMAA) size; clear_color: 4 values, or the frame's 4 device
    words."""
    h, w = size
    dev = current.device
    pos = _resample_to(gbuf["position"], size)
    vel_tex = _resample_to(gbuf["velocity_uv"], size)
    prev_pos = _resample_to(prev_gbuf["position"], size)
    prev_vel = _resample_to(prev_gbuf["velocity_uv"], size)

    current_color = current[..., :3]
    alpha = current[..., 3:4]
    velocity = nearest_velocity(pos, vel_tex)

    ys = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5)[:, None]
    xs = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5)[None, :]
    sy = ys - velocity[..., 1] * h - 0.5
    sx = xs - velocity[..., 0] * w - 0.5
    previous_uv_y = div(ys.expand(h, w), float(h)) - velocity[..., 1]
    previous_uv_x = div(xs.expand(h, w), float(w)) - velocity[..., 0]
    boundary_miss = ((previous_uv_x < 0.0) | (previous_uv_x > 1.0)
                     | (previous_uv_y < 0.0) | (previous_uv_y > 1.0))

    cur_depth = pos[..., 3]
    depth_miss = cur_depth == 0.0
    position_miss = cur_depth == 0.0

    # ANY(ratio < 0.95) over the reference's 5-bias depth footprint equals
    # the test against the footprint's max of the previous depth
    pooled = max_pool_edge(prev_pos[..., 3], 2)
    aux_src = torch.cat([prev_pos[..., :3], pooled[..., None],
                         prev_vel[..., :2]], -1)
    pc, aux = _wb.warp_band([prev_taa[..., :3], aux_src],
                            ("catmull", "nearest"), sy, sx)
    pmax = aux[..., 3]

    has_content = (cur_depth > 0.0) | (pmax > 0.0)
    depth_miss = depth_miss | ((pmax > 0.0) & (
        div(cur_depth, torch.clamp(pmax, min=1e-30)) < 0.95))
    e = [pos[..., k] - aux[..., k] for k in range(3)]
    dist = torch.sqrt(e[0] * e[0] + e[1] * e[1] + e[2] * e[2])
    position_miss = position_miss | (dist > 0.5)
    v0 = velocity[..., 0] - aux[..., 4]
    v1 = velocity[..., 1] - aux[..., 5]
    velocity_miss = torch.sqrt(v0 * v0 + v1 * v1) > 0.00005

    prev_color = torch.clamp(pc, 0.0, 1.0)
    need_clip = boundary_miss | (position_miss & velocity_miss & depth_miss)

    # separable 3x3 moment sums of the current colour in YCoCg
    s_mm = rgb_to_ycocg(torch.clamp(current_color, 0.0, 1.0))
    s_sq = s_mm * s_mm

    def box3(x):
        r = x + shift_edge(x, 0, -1) + shift_edge(x, 0, 1)
        return r + shift_edge(r, -1, 0) + shift_edge(r, 1, 0)

    mean = div(box3(s_mm), 9.0)
    var = torch.sqrt(torch.clamp(div(box3(s_sq), 9.0) - mean * mean,
                                 min=0.0))
    clipped = ycocg_to_rgb(clip_towards_aabb_center(
        rgb_to_ycocg(prev_color), mean - var, mean + var))
    prev_color = torch.where(need_clip[..., None], clipped, prev_color)

    blend = float(np.float32(0.1) / np.float32(frame["upscale_ratio"]))
    out = prev_color + (current_color - prev_color) * blend
    out = torch.cat([out, alpha], -1)
    return torch.where(has_content[..., None], out,
                       values_on(clear_color, dev))
