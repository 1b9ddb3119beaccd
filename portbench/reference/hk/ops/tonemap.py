"""Channel combine + Reinhard tone mapping (tone_mapping.wgsl:21-31)."""

from __future__ import annotations

import torch

from portbench.reference.hk.ops._kernel import values_on
from portbench.reference.hk.utils.math import reinhard_luminance


def tone_mapping(direct, emissive, indirect, clear_color):
    """[h,w,4] channels -> tone-mapped [h,w,4]; pixels with alpha 0 take
    the clear colour (4 values, or the frame's 4 device words)."""
    color = direct + emissive + indirect
    rgb = reinhard_luminance(torch.clamp(color[..., :3], min=0.0039))
    out = torch.cat([rgb, color[..., 3:4]], -1)
    clear = values_on(clear_color, out.device)
    return torch.where(color[..., 3:4] > 0.0, out, clear)
