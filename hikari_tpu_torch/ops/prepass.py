"""Primary-ray helpers of the G-buffer prepass (the port of the parts of
hikari_tpu/ops/prepass.py the fused prepass uses): the per-frame Halton
jitter and the camera rays."""

from __future__ import annotations

import numpy as np
import torch

from hikari_tpu_torch.config import HALTON_JITTER, Taa, UpscaleMode
from hikari_tpu_torch.ops._kernel import div


def frame_jitter(frame_number: int, taa: Taa, upscale_mode: UpscaleMode):
    """Sub-pixel jitter in pixels for this frame, as two float32 values."""
    if upscale_mode == UpscaleMode.SMAA_TU4X:
        index = (frame_number >> 1) & 15
    else:
        index = frame_number & 15
    if taa == Taa.JASMINE:
        return tuple(float(v) for v in HALTON_JITTER[index])
    return (0.0, 0.0)


def camera_rays(view, size, jitter_pixels, pixels=None):
    """Primary rays for every pixel: (origins [H,W,3], unit directions
    [H,W,3]). Unprojects NDC depths 0.9 and 0.1 through inverse_view_proj,
    term by term in the order kernel A evaluates them. `pixels`, when
    given, is a pair of float32 grids (y, x) of the image pixels to trace
    (default: every pixel of `size`)."""
    h, w = size
    dev = view["inverse_view_proj"].device
    m = view["inverse_view_proj"].detach().cpu().numpy().astype(
        np.float32).reshape(16)
    jx, jy = (float(np.float32(j)) for j in jitter_pixels)
    if pixels is None:
        y = torch.arange(h, dtype=torch.float32,
                         device=dev)[:, None].expand(h, w)
        x = torch.arange(w, dtype=torch.float32,
                         device=dev)[None, :].expand(h, w)
    else:
        y, x = pixels
    u = div(x + 0.5 + jx, float(w))
    v = div(y + 0.5 + jy, float(h))
    ndc_x = u * 2.0 - 1.0
    ndc_y = (1.0 - v) * 2.0 - 1.0

    def unproject(z):
        hs = [ndc_x * float(m[4 * r]) + ndc_y * float(m[4 * r + 1])
              + float(m[4 * r + 2] * np.float32(z)) + float(m[4 * r + 3])
              for r in range(4)]
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
