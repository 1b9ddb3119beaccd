"""Bloom: quadratic-threshold prefilter + dual-filter mip pyramid (the port
of hikari_tpu/ops/bloom.py).

The Bevy BLOOM core node the reference chains after OVERLAY
(lib.rs:342-365; examples/simple.rs adds BloomSettings::default()).
Defaults are Bevy 0.9's BloomSettings: threshold 1.0, knee 0.1, scale 1.0,
intensity 0.04. Downsample: the 13-tap filter to half size; upsample: the
9-tap tent, added to the level above; 5 mips (fewer on small images).
PyTorch tensor ops over filters.bilinear_sample, in hikari_tpu's operation
order (its are XLA ops too): 14 + 13 x 11 per downsample and 8 + 9 x 11
per upsample, about 1,200 ops for 5 mips.
"""

from __future__ import annotations

import dataclasses

import torch

from portbench.reference.hk.ops._kernel import const_values, div, f32
from portbench.reference.hk.ops.filters import bilinear_sample
from portbench.reference.hk.ops.restir import pixel_uv


@dataclasses.dataclass(frozen=True)
class BloomSettings:
    intensity: float = 0.04
    threshold: float = 1.0
    knee: float = 0.1
    scale: float = 1.0


# the 13 taps of the downsample in texels, and the 9 of the tent
DOWN_TAPS = ((-2, -2), (0, -2), (2, -2), (-2, 0), (0, 0), (2, 0),
             (-2, 2), (0, 2), (2, 2), (-1, -1), (1, -1), (-1, 1), (1, 1))
TENT_TAPS = ((0, 0), (-1, 0), (1, 0), (0, -1), (0, 1),
             (-1, -1), (1, -1), (-1, 1), (1, 1))


def _quadratic_threshold(color, threshold, knee):
    br = color.amax(-1)
    rq = torch.clamp(br - threshold + knee, 0.0, 2.0 * knee)
    rq = f32(f32(0.25) / f32(max(knee, 1e-5))) * rq * rq
    gain = div(torch.maximum(rq, br - threshold), torch.clamp(br, min=1e-4))
    return color * gain[..., None]


def _taps(img, size, texel, taps):
    """img sampled at the texel centres of an h x w target, each shifted
    by a tap's (dx, dy) * texel: a list in the order of `taps`."""
    uv = pixel_uv(size, img.device)
    offs = const_values([[dx * texel[0], dy * texel[1]] for dx, dy in taps],
                        img.device)
    return [bilinear_sample(img, uv + offs[k]) for k in range(len(taps))]


def _downsample(img):
    """13-tap downsample (Jimenez) to half size."""
    h, w = img.shape[:2]
    size = (max(1, h // 2), max(1, w // 2))
    a, b, c, d, e, f, g, hh, i, j, k, l, m = _taps(
        img, size, (f32(1.0 / w), f32(1.0 / h)), DOWN_TAPS)
    out = e * 0.125
    out = out + (a + c + g + i) * 0.03125
    out = out + (b + d + f + hh) * 0.0625
    out = out + (j + k + l + m) * 0.125
    return out


def _upsample_tent(img, out_size, scale=1.0):
    """9-tap tent upsample to out_size, taps `scale` texels of img apart."""
    s = _taps(img, out_size, (f32(scale / img.shape[1]),
                              f32(scale / img.shape[0])), TENT_TAPS)
    out = s[0] * 4.0
    out = out + (s[1] + s[2] + s[3] + s[4]) * 2.0
    out = out + (s[5] + s[6] + s[7] + s[8])
    return div(out, 16.0)


def bloom(img, settings: BloomSettings = BloomSettings(), mips: int = 5):
    """img [H,W,C] HDR -> img + bloom (alpha kept)."""
    h, w = img.shape[:2]
    mips = min(mips, max(1, min(h, w).bit_length() - 3))
    rgb = img[..., :3]
    pre = _quadratic_threshold(rgb, settings.threshold,
                               settings.knee * settings.threshold)
    chain = [pre]
    for _ in range(mips):
        chain.append(_downsample(chain[-1]))
    up = chain[-1]
    for level in range(mips - 1, -1, -1):
        up = _upsample_tent(up, chain[level].shape[:2],
                            settings.scale) + chain[level]
    out = rgb + up * settings.intensity
    if img.shape[-1] == 4:
        out = torch.cat([out, img[..., 3:4]], -1)
    return out
