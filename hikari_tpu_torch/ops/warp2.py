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
holds 4x the texels its pixels read. A call passes one packed table
(MULTI_TABLE, csrc/warp.cu's MultiCall) and the stream to a binding made
once.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from hikari_tpu_torch import build as _build
from hikari_tpu_torch.ops._kernel import (bind, check, check_launch, on_cpu,
                                          outputs, stream)
from hikari_tpu_torch.ops.warp_band import KINDS, taps
from hikari_tpu_torch.parallel import shard as _sh

MAX_REDUCES = 4
MAX_CHANNELS = 16
# source rows of neighbour context a row-sharded call fetches (hikari_tpu's
# 4 halo blocks of 8 rows): farther motion clamps to the halo-extended
# block
SHARD_HALO = 32
# csrc/warp.cu MultiCall: src, dst[4], sy, sx (pointers); kind[4], lo[4],
# hi[4] (ints); offy[4], offx[4] (floats); n_red, hs, ws, p, h, w, bf16,
# unused (ints)
MULTI_TABLE = struct.Struct("<7Q12i8f8i")


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


def multi_island(src, sy, sx, reduces, dtype, mesh):
    """Kernel 12 as a row-sharded island (hikari_tpu/ops/warp2.py:165-222)
    for a source of r times the output's rows (r an integer): each rank
    samples its block of output rows from the proportional block of the
    source (r times as many rows) plus SHARD_HALO source rows of each
    neighbour's, the first and last blocks repeating their edge row (the
    sampler clamps to the edge). The coords are clamped in global rows,
    then rebased into the halo-extended block; there every word equals
    the whole call's (`shard.sampler_rows`). Rows pad with copies of the
    last."""
    hh, h = src.shape[0], sy.shape[0]
    r = hh // h
    hl = _sh.block_rows(h, mesh.n)
    hsl = r * hl
    halo = min(SHARD_HALO, hsl)
    src_p, _ = _sh.pad_rows_to(src, mesh.n * hsl, mode="edge")
    sy_p, _ = _sh.pad_rows_to(sy, mesh.n * hl, mode="edge")
    sx_p, _ = _sh.pad_rows_to(sx, mesh.n * hl, mode="edge")

    def local(sy_l, sx_l):
        src_h, base = _sh.sampler_rows(_sh.local_rows(src_p, mesh, hsl),
                                       halo, mesh)
        sy_b = (torch.clamp(sy_l, 0.0, hh - 1.0) - float(base)).contiguous()
        return warp_multi(src_h, sy_b, sx_l.contiguous(), reduces,
                          dtype=dtype)

    return _sh.island(local, mesh, h, hl, sy_p, sx_p)


def warp_multi(src, sy, sx, reduces, dtype=torch.float32, mesh=None):
    """Kernel 12. src: [H, W, F] float32 (channels contiguous, any pixel
    stride); sy, sx: [h, w] float32 source coords; reduces: up to 4
    (kind, (dy, dx), (lo, hi)); dtype: the window type, float32 or
    bfloat16. Returns a list of [h, w, hi - lo] float32. Runs `multi_plain`
    for CPU tensors and launches csrc/warp.cu (every reduce in one launch)
    for CUDA tensors. mesh: a row mesh (parallel/shard.py): a source of an
    integer multiple of the output's rows runs as `multi_island`; at a
    non-integral ratio the call runs whole (hikari_tpu/ops/warp2.py
    :181-186), and so does a call with a reduce offset in rows (y + dy
    rounds otherwise in a block's rows than in the image's; SMAA's call
    has none)."""
    if (mesh is not None and src.shape[0] % sy.shape[0] == 0
            and all(float(dy) == 0.0 for _, (dy, _), _ in reduces)):
        return multi_island(src, sy, sx, reduces, dtype, mesh)
    if dtype is not torch.float32 and dtype is not torch.bfloat16:
        raise TypeError(f"window dtype {dtype}: float32 or bfloat16")
    bf16 = dtype is torch.bfloat16
    if not sy.is_cuda and on_cpu(sy):
        return multi_plain(src, sy, sx, [
            (k, (float(oy), float(ox)), (int(lo), int(hi)))
            for k, (oy, ox), (lo, hi) in reduces], bf16)
    n = len(reduces)
    if not 1 <= n <= MAX_REDUCES:
        raise ValueError(f"{n} reduces; the kernel takes 1..{MAX_REDUCES}")
    dev = sy.device
    h, w = shape = sy.shape
    check("sy", sy, torch.float32, shape, dev)
    check("sx", sx, torch.float32, shape, dev)
    if src.dim() != 3 or src.dtype != torch.float32 or src.device != dev:
        raise TypeError(f"src: {src.dtype} {tuple(src.shape)} on "
                        f"{src.device}, expected float32 [H, W, F] on {dev}")
    hs, ws, f = src.shape
    stride = src.stride()
    p = stride[1]
    if f > MAX_CHANNELS or stride != (ws * p, p, 1):
        raise ValueError(f"src: {f} channels, strides {stride}")
    pad = (0,) * (MAX_REDUCES - n)
    codes, los, his, oys, oxs = [], [], [], [], []
    for kind, (oy, ox), (lo, hi) in reduces:
        lo, hi = int(lo), int(hi)
        if kind not in KINDS or not 0 <= lo < hi <= f:
            raise ValueError(f"reduce {kind} ({lo}, {hi}) on {f} channels")
        codes.append(KINDS[kind])
        los.append(lo)
        his.append(hi)
        oys.append(oy)
        oxs.append(ox)
    outs = outputs(sy, h, w, [hi - lo for hi, lo in zip(his, los)])
    table = MULTI_TABLE.pack(
        src.data_ptr(), *[o.data_ptr() for o in outs], *pad, sy.data_ptr(),
        sx.data_ptr(), *codes, *pad, *los, *pad, *his, *pad, *oys, *pad,
        *oxs, *pad, n, hs, ws, p, h, w, bf16, 0)
    rc = bind(_build.load_cuda("warp"), "hk_warp_multi", "tp")(
        table, stream(dev))
    check_launch(rc, "warp_multi")
    warp_multi.launches += 1
    return outs


warp_multi.launches = 0
