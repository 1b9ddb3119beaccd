"""Texture-sampling helpers on dense [H,W,C] tensors with clamp-to-edge
addressing (the post-process samplers' address mode): the part of
hikari_tpu/ops/filters.py the post chain uses, and the static
clamp-to-edge shift of its TAA and SMAA passes."""

from __future__ import annotations

import torch

from portbench.reference.hk.ops._kernel import div


def shift_edge(img: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """out[y, x] = img[clamp(y + dy), clamp(x + dx)] over the first two
    axes (hikari_tpu's pad-edge-and-slice `_shift`)."""
    h, w = img.shape[:2]
    dy = max(-(h - 1), min(dy, h - 1))
    dx = max(-(w - 1), min(dx, w - 1))
    if dy > 0:
        img = torch.cat([img[dy:], img[-1:].expand(dy, *img.shape[1:])], 0)
    elif dy < 0:
        img = torch.cat([img[:1].expand(-dy, *img.shape[1:]), img[:dy]], 0)
    if dx > 0:
        img = torch.cat([img[:, dx:],
                         img[:, -1:].expand(h, dx, *img.shape[2:])], 1)
    elif dx < 0:
        img = torch.cat([img[:, :1].expand(h, -dx, *img.shape[2:]),
                         img[:, :dx]], 1)
    return img


def bilinear_sample(img: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """img [H,W,C] sampled at uv [...,2] in [0,1] (u along x)."""
    h, w = img.shape[:2]
    fx = uv[..., 0] * w - 0.5
    fy = uv[..., 1] * h - 0.5
    x0 = torch.floor(fx)
    y0 = torch.floor(fy)
    ax = (fx - x0)[..., None]
    ay = (fy - y0)[..., None]
    x0i = torch.clamp(x0.long(), 0, w - 1)
    y0i = torch.clamp(y0.long(), 0, h - 1)
    x1i = torch.clamp(x0i + 1, 0, w - 1)
    y1i = torch.clamp(y0i + 1, 0, h - 1)
    return (img[y0i, x0i] * (1 - ax) * (1 - ay)
            + img[y0i, x1i] * ax * (1 - ay)
            + img[y1i, x0i] * (1 - ax) * ay
            + img[y1i, x1i] * ax * ay)


def resize_bilinear(img: torch.Tensor, out_size) -> torch.Tensor:
    """Full-screen-quad style resample (the overlay draw when the post
    chain's output size differs from the target)."""
    h, w = out_size
    dev = img.device
    x = div(torch.arange(w, dtype=torch.float32, device=dev) + 0.5, float(w))
    y = div(torch.arange(h, dtype=torch.float32, device=dev) + 0.5, float(h))
    v, u = torch.meshgrid(y, x, indexing="ij")
    return bilinear_sample(img, torch.stack([u, v], -1))
