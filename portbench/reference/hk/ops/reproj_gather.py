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

import torch

# the temporal reservoirs of the three channels + the two spatial ones
MAX_SOURCES = 5
# planes per pixel the kernel gathers: the 64 B packed reservoir's
PLANES = 16


def gather_plain(sources, piy, pix):
    """Advanced indexing + where over whole planes."""
    hs, f, w = sources[0].shape
    ok = (piy >= 0) & (piy < hs) & (pix >= 0) & (pix < w)
    iy = torch.where(ok, piy, 0).long()
    ix = torch.where(ok, pix, 0).long()
    return [torch.where(ok[:, None, :], s[iy, :, ix].permute(0, 2, 1), 0.0)
            for s in sources]


def reproj_gather(sources, piy, pix):
    """Kernel 9: sources, a list of up to 5 [hs,F,w] float32 channel-plane
    tensors (F = PLANES for CUDA tensors); piy/pix [h,w] int32 source
    coordinates. Returns a list of
    [h,F,w]. Runs `gather_plain`."""
    return gather_plain(sources, piy, pix)

