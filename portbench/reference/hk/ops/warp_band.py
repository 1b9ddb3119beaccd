"""Filtered history resample: kernel 11 (csrc/warp.cu, hk_warp_band) and
its plain version.

Each output pixel samples every source at its coords (sy, sx), clamped to
[0, hs-1] x [0, w-1] (pixel centres at integers), with a separable filter
whose taps clamp to the edge: nearest (round half to even, as the TPU
kernel's jnp.round), bilinear, or the full 4x4 Catmull-Rom kernel. The TAA
history fetch and SMAA's previous-tone fetch call it.

The TPU kernel (hikari_tpu/ops/warp_band.py) is banded: a window around
each 8x128 group's mean offset, because the TPU has no per-lane gather.
In band its result is this exact filter up to f32 rounding; out of band it
clamps local coords to the band edge, an approximation its callers reject
by their disocclusion tests. The port filters every pixel exactly. Its
nearest rounds the global coord half to even where the TPU rounds the
band-local one: the two differ only at exact .5 ties with an odd band
origin. Sources are HWC ([hs, w, F], any pixel stride) where the TPU
kernel takes [hs, F, w] channel planes.

The kernel works on 32x8 tiles of output pixels, reads a texel's channels
in float4 / float2 loads where the layout allows and, in the (catmull,
nearest) instance, copies the block's texel box of the Catmull-Rom source
into shared memory when it fits a fixed budget and reads global memory
otherwise: both give the same words. Template instances serve
(catmull, nearest) (TAA) and (nearest,) (SMAA) with up to 4 and 8
channels; a generic instance the rest.
"""

from __future__ import annotations

import torch

from portbench.reference.hk.ops._kernel import check

MAX_SOURCES = 4


def w1d(d, kind: str):
    """1-D filter weight at signed distance d (bilinear / Catmull-Rom)."""
    a = torch.abs(d)
    if kind == "bilinear":
        return torch.clamp(1.0 - a, min=0.0)
    a2 = a * a
    a3 = a * a * a
    return torch.where(a < 1.0, 1.5 * a3 - 2.5 * a2 + 1.0,
                       torch.where(a < 2.0,
                                   -0.5 * a3 + 2.5 * a2 - 4.0 * a + 2.0,
                                   0.0))


def taps(c, n: int, kind: str):
    """The four taps floor(c)-1 .. floor(c)+2 of coords c along an axis of
    n texels: (weights, clamped indices), four of each."""
    f = torch.floor(c)
    t = c - f
    i0 = f.long()
    return ([w1d(t - float(k - 1), kind) for k in range(4)],
            [torch.clamp(i0 + (k - 1), 0, n - 1) for k in range(4)])


def band_plain(sources, kinds, sy, sx):
    """Gathers and weighted sums over whole planes, in the kernel's order."""
    hs, w = sources[0].shape[:2]
    y = torch.clamp(sy, 0.0, hs - 1.0)
    x = torch.clamp(sx, 0.0, w - 1.0)
    outs = []
    for src, kind in zip(sources, kinds):
        if kind == "nearest":
            outs.append(src[torch.round(y).long(), torch.round(x).long()])
            continue
        wy, ry = taps(y, hs, kind)
        wx, rx = taps(x, w, kind)
        acc = torch.zeros(sy.shape + src.shape[2:], device=sy.device)
        for i in range(4):
            xacc = torch.zeros_like(acc)
            for j in range(4):
                xacc = xacc + wx[j][..., None] * src[ry[i], rx[j]]
            acc = acc + wy[i][..., None] * xacc
        outs.append(acc)
    return outs


def warp_band(sources, kinds, sy, sx, blocks=None):
    """Kernel 11. sources: up to 4 float32 [hs, w, F] tensors (channels
    contiguous, any pixel stride, shared hs and w); kinds: a filter name per
    source; sy, sx: [h, w] float32 source coords. Returns a list of
    [h, w, F] float32. Runs `band_plain`.

    blocks: None, or an int32 [2] CUDA tensor to which each block of the
    staging instance adds 1 at [0] if it staged, at [1] if it read global
    memory (a check that both branches run)."""
    return band_plain(sources, tuple(kinds), sy, sx)

