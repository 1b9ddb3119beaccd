"""A-trous denoiser level: kernel C (csrc/denoise_fused.cu) and its plain
version.

The port of hikari_tpu/ops/denoise_fused.py. One level filters all C
channels at once (denoise.wgsl:43-116): 8 taps at `step`, weighted by
normal^16, the depth gradient, the instance match and luminance/variance,
then the 3-sigma firefly clamp for the channels that ask for it. Stacks are
planes, as on the TPU:

  irr  [3C, H, W]  bf16  demodulated irradiance (level input and output)
  geo  [2+C, H, W] bf16  grad_x, grad_y, then C luminance-weight
                         denominators 1 / (4 * var^0.25 + 1e-3)
  f32s [5, H, W]   f32   depth, instance id, nx, ny, nz (pre-normalized)
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference.hk.config import ATROUS_KERNEL
from portbench.reference.hk.ops._kernel import div
from portbench.reference.hk.utils.math import F32_MAX

_LUMA = (0.2126, 0.7152, 0.0722)
_TAPS = tuple((oy, ox) for oy in (-1, 0, 1) for ox in (-1, 0, 1)
              if not (oy == 0 and ox == 0))
MAX_CHANNELS = 3
KERNEL_STEPS = (1, 2, 4, 8)   # kernel C's instances: the cascade's steps


def _shift(planes, dy, dx):
    """planes[..., y + dy, x + dx] with zeros outside, and the in-image
    mask [H, W]."""
    h, w = planes.shape[-2:]
    pad = F.pad(planes, (max(-dx, 0), max(dx, 0), max(-dy, 0), max(dy, 0)))
    y0, x0 = max(dy, 0), max(dx, 0)
    out = pad[..., y0:y0 + h, x0:x0 + w]
    ys = torch.arange(h, device=planes.device)[:, None] + dy
    xs = torch.arange(w, device=planes.device)[None, :] + dx
    ok = (ys >= 0) & (ys < h) & (xs >= 0) & (xs < w)
    return out, ok


def _bad(rgb):
    fin = (torch.isfinite(rgb[0]) & torch.isfinite(rgb[1])
           & torch.isfinite(rgb[2]))
    over = (rgb[0] > F32_MAX) | (rgb[1] > F32_MAX) | (rgb[2] > F32_MAX)
    return ~fin | over


def atrous_plain(irr, geo, f32s, *, step: int, nch: int, ffs: tuple,
                 row0: int = 0, rows=None):
    """Kernel C's body over whole planes; returns [3C,H,W] bf16. The planes
    are the image rows row0 .. row0 + H - 1 of an image of `rows` rows (H
    when None): taps outside the planes or outside the image are
    skipped."""
    h = irr.shape[1]
    rows = h if rows is None else rows
    k_center = float(ATROUS_KERNEL[1, 1])
    irr_f = irr.to(torch.float32)
    gx, gy = geo[0].to(torch.float32), geo[1].to(torch.float32)
    denom = [geo[2 + c].to(torch.float32) for c in range(nch)]
    d0, i0 = f32s[0], f32s[1]
    n0 = [f32s[2 + i] for i in range(3)]
    zero = torch.zeros_like(d0)

    c_irr, bad, lum0 = [], [], []
    for c in range(nch):
        rgb = [irr_f[3 * c + i] for i in range(3)]
        b = _bad(rgb)
        rgb = [torch.where(b, zero, ch) for ch in rgb]
        c_irr.append(rgb)
        bad.append(b)
        lum0.append(_LUMA[0] * rgb[0] + _LUMA[1] * rgb[1] + _LUMA[2] * rgb[2])
    sum_irr = [[ch * k_center for ch in c_irr[c]] for c in range(nch)]
    sum_w = [torch.where(bad[c], 0.0, k_center) for c in range(nch)]
    ff_m1 = [zero] * nch
    ff_m2 = [zero] * nch
    ff_cnt = [zero] * nch

    for oy, ox in _TAPS:
        k_tap = float(ATROUS_KERNEL[oy + 1, ox + 1])
        sf, ok = _shift(f32s, oy * step, ox * step)
        si, _ = _shift(irr_f, oy * step, ox * step)
        if row0 != 0 or rows != h:
            ty = torch.arange(h, device=ok.device) + (row0 + oy * step)
            ok = ok & ((ty >= 0) & (ty < rows))[:, None]
        nw = torch.clamp(n0[0] * sf[2] + n0[1] * sf[3] + n0[2] * sf[4],
                         min=0.0)
        nw = nw * nw
        nw = nw * nw
        nw = nw * nw
        nw = nw * nw
        iw = torch.clamp(1.0 - torch.abs(i0 - sf[1]), min=0.0)
        geo_w = nw * iw * k_tap
        dg = torch.abs(gx * float(ox) + gy * float(oy))
        d_arg = div(torch.abs(d0 - sf[0]), dg + 0.01)
        for c in range(nch):
            src = [si[3 * c + i] for i in range(3)]
            okc = ok & ~_bad(src)
            s_lum = _LUMA[0] * src[0] + _LUMA[1] * src[1] + _LUMA[2] * src[2]
            wgt = geo_w * torch.exp(
                -(d_arg + torch.abs(lum0[c] - s_lum) * denom[c]))
            sum_irr[c] = [torch.where(okc, sum_irr[c][i] + src[i] * wgt,
                                      sum_irr[c][i]) for i in range(3)]
            sum_w[c] = torch.where(okc, sum_w[c] + wgt, sum_w[c])
            if ffs[c]:
                ff_m1[c] = torch.where(okc, ff_m1[c] + s_lum, ff_m1[c])
                ff_m2[c] = torch.where(okc, ff_m2[c] + s_lum * s_lum,
                                       ff_m2[c])
                ff_cnt[c] = torch.where(okc, ff_cnt[c] + 1.0, ff_cnt[c])

    out = []
    for c in range(nch):
        wsum = sum_w[c]
        inv = div(1.0, torch.clamp(wsum, min=1e-4))
        ni = [torch.where(wsum < 1e-4, zero, ch * inv) for ch in sum_irr[c]]
        if ffs[c]:
            cnt = torch.clamp(ff_cnt[c], min=1.0)
            mean = div(ff_m1[c], cnt)
            var = div(ff_m2[c], cnt) - mean * mean
            fire = lum0[c] > mean + 3.0 * torch.sqrt(torch.clamp(var, min=0.0))
            scale = div(mean, torch.clamp(lum0[c], min=1e-30))
            ni = [torch.where(fire, scale * ch, ch) for ch in ni]
        out += ni
    return torch.stack(out).to(torch.bfloat16)


def atrous_level(irr, geo, f32s, *, step: int, nch: int, ffs: tuple,
                 row0: int = 0, rows=None):
    """Kernel C's plain version, `atrous_plain` (step in KERNEL_STEPS). row0,
    rows: the image row of the planes' first row and the image's rows (a
    row block with its halo; the whole image by default)."""
    return atrous_plain(irr, geo, f32s, step=step, nch=nch, ffs=ffs,
                        row0=row0, rows=rows)


def level_stacks(irrs, variances, normal, gradient, depth, instance):
    """The level inputs (irr, geo, f32s) from per-channel [h,w,3]
    demodulated irradiance and [h,w] prefiltered variance, the
    pre-normalized normal [h,w,3], gradient [h,w,2] and depth/instance."""
    irr = torch.stack([c[..., i] for c in irrs for i in range(3)]).to(
        torch.bfloat16)
    denoms = [div(1.0, 4.0 * torch.sqrt(torch.sqrt(torch.clamp(v, min=0.0)))
                  + 1e-3) for v in variances]
    geo = torch.stack([gradient[..., 0], gradient[..., 1]] + denoms).to(
        torch.bfloat16)
    f32s = torch.stack([depth, instance, normal[..., 0], normal[..., 1],
                        normal[..., 2]]).contiguous()
    return irr, geo, f32s


def denoise_levels_fused(irrs, variances, normal, gradient, depth, instance,
                         ffs, steps):
    """The a-trous cascade, one kernel C launch per level (inputs as
    `level_stacks`). Returns a list of [h,w,3] f32 (filtered irradiance,
    firefly clamp applied)."""
    nch = len(irrs)
    irr, geo, f32s = level_stacks(irrs, variances, normal, gradient, depth,
                                  instance)
    for step in steps:
        irr = atrous_level(irr, geo, f32s, step=step, nch=nch,
                           ffs=tuple(ffs))
    irr = irr.to(torch.float32)
    return [torch.stack([irr[3 * c + i] for i in range(3)], -1)
            for c in range(nch)]
