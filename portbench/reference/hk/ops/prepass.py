"""The G-buffer prepass without kernel A (hikari_tpu/ops/prepass.py): the
per-frame Halton jitter, the camera rays, the forward-difference depth
gradient, and `prepass`, which traces the primary rays through the
scene's tracer (`with_info`) for scenes beyond kernel A's gate."""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.hk.config import HALTON_JITTER, Taa, UpscaleMode
from portbench.reference.hk.ops._kernel import div, host_values


def frame_jitter(frame_number: int, taa: Taa, upscale_mode: UpscaleMode):
    """Sub-pixel jitter in pixels for this frame, as two float32 values."""
    if upscale_mode == UpscaleMode.SMAA_TU4X:
        index = (frame_number >> 1) & 15
    else:
        index = frame_number & 15
    if taa == Taa.JASMINE:
        return tuple(float(v) for v in HALTON_JITTER[index])
    return (0.0, 0.0)


def jitter_tensor(jitter, device) -> torch.Tensor:
    """The frame's [2] float32 jitter on `device`: the frame's device words
    as they are, or a fresh tensor of host values (a caller outside the
    frame program)."""
    if torch.is_tensor(jitter):
        return jitter.reshape(2)
    return host_values([float(np.float32(j)) for j in jitter], device)


def camera_rays(view, size, jitter_pixels, rows=None):
    """Primary rays for every pixel: (origins [H,W,3], unit directions
    [H,W,3]). Unprojects NDC depths 0.9 and 0.1 through inverse_view_proj,
    term by term in the order kernel A evaluates them; the matrix and the
    jitter (jitter_tensor) stay on the device, their entries 0-d tensors.
    rows: (first row, count), the rays of those image rows only
    ([count,W,3]; a row sharded kernel A's block)."""
    h, w = size
    row0, count = (0, h) if rows is None else rows
    dev = view["inverse_view_proj"].device
    m = view["inverse_view_proj"].reshape(16).to(torch.float32).unbind(0)
    jx, jy = jitter_tensor(jitter_pixels, dev).unbind(0)
    y = (torch.arange(count, dtype=torch.float32, device=dev)
         + float(row0))[:, None].expand(count, w)
    x = torch.arange(w, dtype=torch.float32, device=dev)[None, :].expand(
        count, w)
    u = div(x + 0.5 + jx, float(w))
    v = div(y + 0.5 + jy, float(h))
    ndc_x = u * 2.0 - 1.0
    ndc_y = (1.0 - v) * 2.0 - 1.0

    def unproject(z):
        z = float(np.float32(z))
        hs = [ndc_x * m[4 * r] + ndc_y * m[4 * r + 1] + m[4 * r + 2] * z
              + m[4 * r + 3] for r in range(4)]
        inv = div(1.0, hs[3])
        return hs[0] * inv, hs[1] * inv, hs[2] * inv

    ax, ay, az = unproject(0.9)
    bx, by, bz = unproject(0.1)
    dx, dy, dz = bx - ax, by - ay, bz - az
    inv_len = torch.rsqrt(torch.clamp(dx * dx + dy * dy + dz * dz,
                                      min=1e-30))
    d = torch.stack([dx * inv_len, dy * inv_len, dz * inv_len], -1)
    o = view["world_position"].reshape(-1)[:3].to(torch.float32)
    return o.expand(*y.shape, 3), d


def depth_gradient(depth, grad_scale: float = 1.0):
    """[h,w,2] forward differences of the depth (the last row and column
    repeat their neighbour's) over `grad_scale` image pixels."""
    ddx = torch.cat([depth[:, 1:] - depth[:, :-1],
                     depth[:, -1:] - depth[:, -2:-1]], dim=1)
    ddy = torch.cat([depth[1:, :] - depth[:-1, :],
                     depth[-1:, :] - depth[-2:-1, :]], dim=0)
    if grad_scale != 1.0:
        ddx = ddx * (1.0 / grad_scale)
        ddy = ddy * (1.0 / grad_scale)
    return torch.stack([ddx, ddy], -1)


# the primary rays' max_t (hikari_tpu/ops/prepass.py:93)
PRIMARY_MAX_T = 3.4e38


def prepass(scene, tracer, view, prev_view, jitter, size):
    """The full-resolution G-buffer of ops/prepass_fused.py's contract from
    one jittered primary ray per pixel through `tracer.with_info`: position
    (xyz + NDC depth, 0 on the background), normal, depth gradient,
    instance / material ids + 0.5 (-0.5 on the background) and velocity +
    mesh uv. The surface point, depth and velocity share kernel A's
    expressions (prepass_fused._surface_point)."""
    from portbench.reference.hk.ops import prepass_fused as _pf

    h, w = size
    jitter = jitter_tensor(jitter, view["view_proj"].device)
    p = _pf.pack_params(view, prev_view, jitter, size)
    origin, direction = camera_rays(view, size, jitter)
    ro = origin.reshape(-1, 3).contiguous()
    rd = direction.reshape(-1, 3).contiguous()
    info = tracer.with_info(
        scene, ro, rd, torch.full((h * w,), PRIMARY_MAX_T, device=ro.device))
    inst_f = info["instance"].to(torch.float32)
    mask, (wx, wy, wz), depth, velu, velv = _pf._surface_point(
        p, ro.unbind(-1), rd.unbind(-1), info["t"], inst_f,
        scene["inst_motion"])
    z = torch.zeros_like(depth)
    position = torch.stack([torch.where(mask, wx, z), torch.where(mask, wy, z),
                            torch.where(mask, wz, z), depth], -1)
    normal = torch.where(mask[:, None], info["normal"], 0.0)
    inst_mat = torch.stack(
        [inst_f + 0.5, info["material"].to(torch.float32) + 0.5], -1)
    vel_uv = torch.cat([torch.stack([velu, velv], -1), info["uv"]], -1)
    depth = depth.reshape(h, w)
    return {
        "position": position.reshape(h, w, 4),
        "normal": normal.reshape(h, w, 3),
        "depth_gradient": depth_gradient(depth),
        "instance_material": inst_mat.reshape(h, w, 2),
        "velocity_uv": vel_uv.reshape(h, w, 4),
    }
