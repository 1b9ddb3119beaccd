"""Reprojection gather: kernel 9 (csrc/reproj_gather.cu) and its plain
version.

Each pixel fetches its previous-frame reservoir planes at the reprojected
coordinates: out[s][y, :, x] = src[s][piy, :, pix] where (piy, pix) lies in
the source, and zeros (the rejected reservoir) elsewhere. The frame marks
rejected pixels with piy = -1.

The TPU kernel (hikari_tpu/ops/reproj_gather.py) is banded because the TPU
has no per-lane gather: a window around each 8x128 group's mean offset,
tap codes and lane rolls. On Hopper a gather is a plain load, so the port
gathers every pixel exactly. In-band pixels agree with the TPU kernel bit
for bit; pixels its band rejects get zeros there and the exact gather
here. The port has no group mean, so it also has no way to let rejected
(-1) pixels drag a group's window off its band.
"""

from __future__ import annotations

import struct

import torch

from hikari_tpu_torch.ops._kernel import (bind, check, check_launch, on_cpu,
                                          stream)
from hikari_tpu_torch.parallel import shard as _sh

# the temporal reservoirs of the three channels + the two spatial ones
MAX_SOURCES = 5
# planes per pixel the kernel gathers: the 64 B packed reservoir's
PLANES = 16
# rows of neighbour context a row-sharded gather fetches (hikari_tpu's
# SHARD_HALO): a source further away rejects
SHARD_HALO = 16
# csrc/reproj_gather.cu GatherCall: the sources' and the outputs' pointers
# (MAX_SOURCES slots each, 0 past the last), piy, pix (pointers); n_src,
# hs, h, w, f (ints), padded to 8 bytes
GATHER_TABLE = struct.Struct("<12Q5i4x")


def gather_plain(sources, piy, pix):
    """Advanced indexing + where over whole planes."""
    hs, f, w = sources[0].shape
    ok = (piy >= 0) & (piy < hs) & (pix >= 0) & (pix < w)
    iy = torch.where(ok, piy, 0).long()
    ix = torch.where(ok, pix, 0).long()
    return [torch.where(ok[:, None, :], s[iy, :, ix].permute(0, 2, 1), 0.0)
            for s in sources]


def gather_island(sources, piy, pix, mesh):
    """Kernel 9 as a row-sharded island (hikari_tpu/ops/reproj_gather.py
    :278-330): each rank gathers its block of output rows from its block
    of the sources plus SHARD_HALO rows of each neighbour's, the source
    rows rebased into that halo-extended block. A source row beyond the
    halo rejects (the empty reservoir), as in hikari_tpu's sharded gather;
    within it every word equals the whole gather's. Pad rows carry -1
    (reject)."""
    h = piy.shape[0]
    hl = _sh.block_rows(h, mesh.n)
    halo = min(SHARD_HALO, hl)
    base = mesh.rank * hl - halo
    piy, _ = _sh.pad_rows_to(piy, mesh.n * hl, value=-1)
    pix, _ = _sh.pad_rows_to(pix, mesh.n * hl, value=-1)

    def local(piy_l, pix_l, *srcs):
        srcs_h = [_sh.halo_rows(s, halo, halo, mesh) for s in srcs]
        rows = srcs_h[0].shape[0]
        # rejected pixels stay -1; a source beyond the block rejects
        piy_b = piy_l - base
        piy_b = torch.where((piy_l >= 0) & (piy_b < rows), piy_b,
                            -1).to(torch.int32).contiguous()
        return reproj_gather(srcs_h, piy_b, pix_l.contiguous())

    return _sh.island(local, mesh, h, hl, piy, pix, *sources)


def reproj_gather(sources, piy, pix, mesh=None):
    """Kernel 9: sources, a list of up to 5 [hs,F,w] float32 channel-plane
    tensors (F = PLANES for CUDA tensors); piy/pix [h,w] int32 source
    coordinates. Returns a list of
    [h,F,w], views of one allocation. Runs `gather_plain` for CPU tensors
    and launches csrc/reproj_gather.cu (all sources in one launch, its
    arguments in one packed table, GATHER_TABLE) for CUDA tensors. With a
    row mesh it runs as `gather_island` (the outputs gathered whole, one
    tensor each)."""
    if mesh is not None:
        return gather_island(sources, piy, pix, mesh)
    if on_cpu(piy):
        return gather_plain(sources, piy, pix)
    from hikari_tpu_torch.build import load_cuda

    n = len(sources)
    if not 1 <= n <= MAX_SOURCES:
        raise ValueError(f"{n} sources; the kernel takes 1..{MAX_SOURCES}")
    if sources[0].dim() != 3:
        raise ValueError(f"sources[0]: shape {tuple(sources[0].shape)}, "
                         "expected [hs, F, w]")
    dev = piy.device
    hs, f, w = sources[0].shape
    h = piy.shape[0]
    if f != PLANES:
        raise ValueError(f"sources[0]: {f} planes, the kernel takes {PLANES}")
    if max(h, hs) * f * w >= 2 ** 31:
        raise ValueError(f"planes of {max(h, hs) * f * w} words: the kernel "
                         "indexes them in 32 bits")
    for i, s in enumerate(sources):
        check(f"sources[{i}]", s, torch.float32, (hs, f, w), dev)
    check("piy", piy, torch.int32, (h, w), dev)
    check("pix", pix, torch.int32, (h, w), dev)
    # one allocation, one view per source (an allocation costs the host
    # more than a view)
    outs = list(torch.empty((n, h, f, w), dtype=torch.float32,
                            device=dev).unbind(0))
    empty = [0] * (MAX_SOURCES - n)
    table = GATHER_TABLE.pack(
        *(t.data_ptr() for t in sources), *empty,
        *(t.data_ptr() for t in outs), *empty, piy.data_ptr(),
        pix.data_ptr(), n, hs, h, w, f)
    fn = bind(load_cuda("reproj_gather"), "hk_reproj_gather", "tp")
    rc = fn(table, stream(dev))
    check_launch(rc, "reproj_gather")
    reproj_gather.launches += 1
    return outs


reproj_gather.launches = 0
