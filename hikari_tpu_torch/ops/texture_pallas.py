"""The coherent atlas sampler: kernel 14 (csrc/texture.cu) and its plain
version, ops/shading.py sample_atlas.

`sample_atlas_coherent(scene, tex_id, uv)` samples the texture atlas
bilinearly with repeat addressing at every pixel of a screen-coherent uv
field (the primary surface's texture slots): tex_id [...] int32 (-1 =
none, which gives 1.0), uv [..., 2] float32; returns [..., 4] float32.

The TPU kernel (hikari_tpu/ops/texture_pallas.py) has no per-lane gather:
per 16x16 pixel group it DMAs one 64x256-texel bf16 window of a panel
tiling of the atlas, centred on the group's mean texel, applies the y
weights as a matrix product and clamps texels outside the window to its
edge. On Hopper a gather is a plain load, so the port samples every pixel
exactly: its result is sample_atlas's, bit for bit. The window, its clamp
and the bf16 panels are a TPU approximation and are not ported; where a
footprint lies inside its group's window the two agree to the window's
bf16 precision.
"""

from __future__ import annotations

import math

import torch

from hikari_tpu_torch.ops._kernel import (bind, check, check_launch, on_cpu,
                                          ptr, stream)
from hikari_tpu_torch.ops.shading import sample_atlas


def _pixel_stride(name: str, t: torch.Tensor, lead, inner: int) -> int:
    """The element stride between neighbouring pixels of `t` (shape
    `lead`, plus `inner` contiguous values per pixel when inner > 1), as a
    slice of a wider per-pixel tensor has; raises when the pixels do not
    lie at one uniform stride."""
    shape = tuple(lead) + ((inner,) if inner > 1 else ())
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if inner > 1 and t.stride(-1) != 1:
        raise ValueError(f"{name}: its {inner} values per pixel are not "
                         "contiguous")
    dims = [i for i, d in enumerate(lead) if d > 1]
    if not dims:
        return inner
    s = t.stride(dims[-1])
    step = s
    for i in reversed(range(len(lead))):
        if lead[i] > 1 and t.stride(i) != step:
            raise ValueError(f"{name}: pixels at no uniform stride")
        step *= lead[i]
    return s


def sample_atlas_coherent(scene, tex_id, uv):
    """Kernel 14: runs `sample_atlas` for CPU tensors and launches
    csrc/texture.cu (one thread per pixel) for CUDA tensors. tex_id and uv
    may be slices of wider per-pixel tensors (one uniform pixel stride
    each)."""
    if on_cpu(tex_id):
        return sample_atlas(scene, tex_id, uv)
    from hikari_tpu_torch.build import load_cuda

    dev = tex_id.device
    atlas, rects = scene["atlas"], scene["tex_rect"]
    check("atlas", atlas, torch.float32, device=dev)
    check("tex_rect", rects, torch.int32, device=dev)
    if atlas.dim() != 3 or atlas.shape[2] != 4 or rects.dim() != 2 \
            or rects.shape[1] != 4:
        raise ValueError("atlas [A_h, A_w, 4] and tex_rect [T, 4] expected")
    if tex_id.dtype != torch.int32 or uv.dtype != torch.float32:
        raise TypeError("tex_id int32 and uv float32 expected")
    if uv.device != dev:
        raise ValueError(f"uv: on {uv.device}, expected {dev}")
    lead = tuple(tex_id.shape)
    id_stride = _pixel_stride("tex_id", tex_id, lead, 1)
    uv_stride = _pixel_stride("uv", uv, lead, 2)
    n = math.prod(lead)
    out = torch.empty(lead + (4,), dtype=torch.float32, device=dev)
    fn = bind(load_cuda("texture"), "hk_sample_atlas", "ppppiipiiiip")
    rc = fn(ptr(atlas), ptr(rects), ptr(tex_id), ptr(uv), id_stride,
            uv_stride, ptr(out), n, atlas.shape[0], atlas.shape[1],
            rects.shape[0], stream(dev))
    check_launch(rc, "sample_atlas_coherent")
    sample_atlas_coherent.launches += 1
    return out


sample_atlas_coherent.launches = 0
