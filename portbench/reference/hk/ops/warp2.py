"""Multi-reduce window warp: kernel 12 (csrc/warp.cu, hk_warp_multi) and its
plain version.

One HWC source [H, W, F <= 16] sampled at per-pixel coords (sy, sx),
clamped to [0, H-1] x [0, W-1], by one or more reduces: a filter
('nearest' | 'bilinear' | 'catmull'), a static (dy, dx) offset added to the
clamped coords, and a channel range. With dtype bfloat16 the source values
and the filter weights are rounded to bf16 (nearest even) before the f32
sums, as hikari_tpu's bf16 window and weights are; the nearest filter
rounds half down (its |d| <= 0.5 & d > -0.5 rule). SMAA's previous
G-buffer fetch calls it.

The TPU kernel (hikari_tpu/ops/warp2.py) fetches a 32-row window per 16x16
group around the group's mean coords and clamps local coords to that
window, an approximation its callers reject by their disocclusion tests.
The port samples every pixel exactly: in window the two agree.

The kernel works on 32x8 tiles of output pixels. When every reduce is
nearest (SMAA's call) an instance reads each reduce's channel range in
float4 / float2 loads where the layout allows and writes vector stores; a
generic instance serves the rest. No shared-memory staging: a nearest
fetch reads each texel once, and at SMAA's 2x ratio a block's texel box
holds 4x the texels its pixels read.
"""

from __future__ import annotations


import numpy as np
import torch

from portbench.reference.hk.ops.warp_band import taps

MAX_CHANNELS = 16


def _bf16(t):
    return t.to(torch.bfloat16).to(torch.float32)


def multi_plain(src, sy, sx, reduces, bf16: bool):
    """Gathers and weighted sums over whole planes, in the kernel's order."""
    hs, ws = src.shape[:2]
    vals = _bf16(src) if bf16 else src
    y = torch.clamp(sy, 0.0, hs - 1.0)
    x = torch.clamp(sx, 0.0, ws - 1.0)
    outs = []
    for kind, (oy, ox), (lo, hi) in reduces:
        qy = y + float(np.float32(oy))
        qx = x + float(np.float32(ox))
        sub = vals[..., lo:hi]
        if kind == "nearest":
            iy = torch.clamp(torch.ceil(qy - 0.5).long(), 0, hs - 1)
            ix = torch.clamp(torch.ceil(qx - 0.5).long(), 0, ws - 1)
            outs.append(sub[iy, ix])
            continue
        wy, ry = taps(qy, hs, kind)
        wx, rx = taps(qx, ws, kind)
        if bf16:
            wy, wx = [_bf16(t) for t in wy], [_bf16(t) for t in wx]
        acc = torch.zeros(sy.shape + (hi - lo,), device=sy.device)
        for j in range(4):
            t = torch.zeros_like(acc)
            for i in range(4):
                t = t + wy[i][..., None] * sub[ry[i], rx[j]]
            acc = acc + t * wx[j][..., None]
        outs.append(acc)
    return outs


def warp_multi(src, sy, sx, reduces, dtype=torch.float32):
    """Kernel 12. src: [H, W, F] float32 (channels contiguous, any pixel
    stride); sy, sx: [h, w] float32 source coords; reduces: up to 4
    (kind, (dy, dx), (lo, hi)); dtype: the window type, float32 or
    bfloat16. Returns a list of [h, w, hi - lo] float32. Runs `multi_plain`."""
    if dtype is not torch.float32 and dtype is not torch.bfloat16:
        raise TypeError(f"window dtype {dtype}: float32 or bfloat16")
    bf16 = dtype is torch.bfloat16
    return multi_plain(src, sy, sx, [
        (k, (float(oy), float(ox)), (int(lo), int(hi)))
        for k, (oy, ox), (lo, hi) in reduces], bf16)

