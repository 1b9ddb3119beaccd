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
"""

from __future__ import annotations

import torch

from hikari_tpu_torch.ops._kernel import (bind, check, check_launch, on_cpu,
                                          ptr, stream)

KINDS = {"nearest": 0, "bilinear": 1, "catmull": 2}
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


def warp_band(sources, kinds, sy, sx):
    """Kernel 11. sources: up to 4 float32 [hs, w, F] tensors (channels
    contiguous, any pixel stride, shared hs and w); kinds: a filter name per
    source; sy, sx: [h, w] float32 source coords. Returns a list of
    [h, w, F] float32. Runs `band_plain` for CPU tensors and launches
    csrc/warp.cu (every source in one launch) for CUDA tensors."""
    kinds = tuple(kinds)
    if on_cpu(sy):
        return band_plain(sources, kinds, sy, sx)
    from hikari_tpu_torch.build import load_cuda

    n = len(sources)
    if not 1 <= n <= MAX_SOURCES or len(kinds) != n:
        raise ValueError(f"{n} sources, {len(kinds)} kinds; the kernel takes "
                         f"1..{MAX_SOURCES} of each")
    dev = sy.device
    h, w = sy.shape
    hs = sources[0].shape[0]
    check("sy", sy, torch.float32, (h, w), dev)
    check("sx", sx, torch.float32, (h, w), dev)
    outs, strides = [], []
    for i, s in enumerate(sources):
        if s.dim() != 3 or tuple(s.shape[:2]) != (hs, w):
            raise ValueError(f"sources[{i}]: shape {tuple(s.shape)}, expected "
                             f"({hs}, {w}, F)")
        if s.dtype != torch.float32 or s.device != dev:
            raise TypeError(f"sources[{i}]: {s.dtype} on {s.device}")
        p = s.stride(1)
        if s.stride() != (w * p, p, 1):
            raise ValueError(f"sources[{i}]: strides {s.stride()} are not "
                             "those of a slice of contiguous pixels")
        strides.append(p)
        outs.append(torch.empty((h, w, s.shape[2]), dtype=torch.float32,
                                device=dev))
    pad = MAX_SOURCES - n
    fn = bind(load_cuda("warp"), "hk_warp_band", "ppiiii" + "p" * 8
              + "i" * 12 + "p")
    rc = fn(ptr(sy), ptr(sx), h, w, hs, n,
            *(ptr(s) for s in list(sources) + [None] * pad),
            *(ptr(o) for o in outs + [None] * pad),
            *([KINDS[k] for k in kinds] + [0] * pad),
            *([s.shape[2] for s in sources] + [0] * pad),
            *(strides + [0] * pad), stream(dev))
    check_launch(rc, "warp_band")
    warp_band.launches += 1
    return outs


warp_band.launches = 0
