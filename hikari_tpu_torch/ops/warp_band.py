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
channels; a generic instance the rest. A call passes one packed table
(BAND_TABLE, csrc/warp.cu's BandCall) and the stream to a binding made
once.
"""

from __future__ import annotations

import struct

import torch

from hikari_tpu_torch import build as _build
from hikari_tpu_torch.ops._kernel import (bind, check, check_launch, on_cpu,
                                          outputs, stream)
from hikari_tpu_torch.parallel import shard as _sh

KINDS = {"nearest": 0, "bilinear": 1, "catmull": 2}
MAX_SOURCES = 4
# rows of neighbour context a row-sharded warp fetches (hikari_tpu's
# SHARD_HALO): farther motion clamps to the halo-extended block
SHARD_HALO = 16
# csrc/warp.cu BandCall: src[4], dst[4], sy, sx, blocks (pointers); kind[4],
# f[4], stride[4], n_src, h, w, hs (ints)
BAND_TABLE = struct.Struct("<11Q16i")


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


def band_island(sources, kinds, sy, sx, mesh):
    """Kernel 11 as a row-sharded island (hikari_tpu/ops/warp_band.py
    :329-395), for sources on the output's row grid: each rank warps its
    block of output rows from its block of the sources plus SHARD_HALO
    rows of each neighbour's, the first and last blocks repeating their
    edge row (the sampler clamps to the edge, so a zero halo would put
    zeros under the border taps). The coords are clamped in global rows,
    then rebased into the halo-extended block; there every word equals
    the whole warp's (`shard.sampler_rows`). The blocks start at even
    rows, so the nearest filter's round half to even rounds as in global
    rows. Rows pad with copies of the last."""
    h = sy.shape[0]
    hl = _sh.block_rows(h, mesh.n, 2)
    halo = min(SHARD_HALO, hl)
    rows = mesh.n * hl
    padded = [_sh.pad_rows_to(t, rows, mode="edge")[0]
              for t in [sy, sx] + list(sources)]

    def local(sy_l, sx_l, *srcs):
        srcs_h, bases = zip(*(_sh.sampler_rows(s, halo, mesh)
                              for s in srcs))
        sy_b = (torch.clamp(sy_l, 0.0, h - 1.0)
                - float(bases[0])).contiguous()
        return warp_band(list(srcs_h), kinds, sy_b, sx_l.contiguous())

    return _sh.island(local, mesh, h, hl, *padded)


def warp_band(sources, kinds, sy, sx, blocks=None, mesh=None):
    """Kernel 11. sources: up to 4 float32 [hs, w, F] tensors (channels
    contiguous, any pixel stride, shared hs and w); kinds: a filter name per
    source; sy, sx: [h, w] float32 source coords. Returns a list of
    [h, w, F] float32. Runs `band_plain` for CPU tensors and launches
    csrc/warp.cu (every source in one launch) for CUDA tensors.

    blocks: None, or an int32 [2] CUDA tensor to which each block of the
    staging instance adds 1 at [0] if it staged, at [1] if it read global
    memory (a check that both branches run).

    mesh: a row mesh (parallel/shard.py): sources on the output's row grid
    run as `band_island`; others run whole."""
    if mesh is not None and sources[0].shape[0] == sy.shape[0]:
        return band_island(sources, kinds, sy, sx, mesh)
    if not sy.is_cuda and on_cpu(sy):
        return band_plain(sources, tuple(kinds), sy, sx)
    n = len(sources)
    if not 1 <= n <= MAX_SOURCES or len(kinds) != n:
        raise ValueError(f"{n} sources, {len(kinds)} kinds; the kernel takes "
                         f"1..{MAX_SOURCES} of each")
    dev = sy.device
    h, w = shape = sy.shape
    check("sy", sy, torch.float32, shape, dev)
    check("sx", sx, torch.float32, shape, dev)
    hs = sources[0].shape[0]
    if blocks is not None:
        check("blocks", blocks, torch.int32, (2,), dev)
    pad = (0,) * (MAX_SOURCES - n)
    srcs, codes, fs, strides = [], [], [], []
    for i, s in enumerate(sources):
        hs_, w_, f = s.shape if s.dim() == 3 else (None, None, None)
        if hs_ != hs or w_ != w:
            raise ValueError(f"sources[{i}]: shape {tuple(s.shape)}, expected "
                             f"({hs}, {w}, F)")
        if s.dtype != torch.float32 or s.device != dev:
            raise TypeError(f"sources[{i}]: {s.dtype} on {s.device}")
        stride = s.stride()
        p = stride[1]
        if stride != (w * p, p, 1):
            raise ValueError(f"sources[{i}]: strides {stride} are not "
                             "those of a slice of contiguous pixels")
        srcs.append(s.data_ptr())
        codes.append(KINDS[kinds[i]])
        fs.append(f)
        strides.append(p)
    outs = outputs(sy, h, w, fs)
    table = BAND_TABLE.pack(
        *srcs, *pad, *[o.data_ptr() for o in outs], *pad, sy.data_ptr(),
        sx.data_ptr(), 0 if blocks is None else blocks.data_ptr(), *codes,
        *pad, *fs, *pad, *strides, *pad, n, h, w, hs)
    rc = bind(_build.load_cuda("warp"), "hk_warp_band", "tp")(
        table, stream(dev))
    check_launch(rc, "warp_band")
    warp_band.launches += 1
    return outs


warp_band.launches = 0
