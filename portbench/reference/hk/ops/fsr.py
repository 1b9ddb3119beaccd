"""AMD FidelityFX Super Resolution 1.0: EASU upscale + RCAS sharpen, the
port of hikari_tpu/ops/fsr.py.

The reference ships prebuilt SPIR-V blobs for these two passes
(src/shaders/fsr/fsr_pass_easu.spv / fsr_pass_rcas.spv) compiled from AMD's
public ffx_fsr1.h; hikari_tpu computes the same published algorithm (a
12-tap edge-adaptive Lanczos-like filter with deringing, and the robust
contrast-adaptive sharpener) as whole-image tensor ops, with no Pallas
kernel, and so does the port: plain PyTorch on the device of its input.

Two traits of hikari_tpu are kept for parity: EASU returns RGB only (the
post chain appends an alpha of ones), and RCAS's neighbours wrap around
the image's borders (jnp.roll), where AMD's clamp to the edge.
"""

from __future__ import annotations

import numpy as np
import torch

# the 12 taps (dx, dy) around the sample's texel f, in hikari_tpu's order:
#  b c
# e f g h
# i j k l
#  n o
TAPS = {"b": (0, -1), "c": (1, -1), "e": (-1, 0), "f": (0, 0), "g": (1, 0),
        "h": (2, 0), "i": (-1, 1), "j": (0, 1), "k": (1, 1), "l": (2, 1),
        "n": (0, 2), "o": (1, 2)}
RCAS_LIMIT = 0.25 - 1.0 / 16.0


def easu_coords(n_out: int, n_in: int, device=None):
    """EASU's source coordinate along one axis of n_out output pixels:
    (texel index floor(p) as int64, fraction p - floor(p)) of
    p = (u + 0.5) * (n_in / n_out) - 0.5, in float32 with the quotient
    rounded to float32 first, as hikari_tpu's weakly typed Python float
    is (fsr.py:33-40)."""
    u = torch.arange(n_out, dtype=torch.float32, device=device)
    p = (u + 0.5) * float(np.float32(n_in / n_out)) - 0.5
    fp = torch.floor(p)
    return fp.to(torch.int64), p - fp


def _luma(c):
    # FSR feature luma: B*0.5 + R*0.5 + G
    return c[..., 2] * 0.5 + (c[..., 0] * 0.5 + c[..., 1])


def easu(img, out_size):
    """Edge-adaptive spatial upsampling. img [ih,iw,C] -> [oh,ow,3]."""
    ih, iw = img.shape[:2]
    oh, ow = out_size
    dev = img.device
    ix, fx = easu_coords(ow, iw, dev)
    iy, fy = easu_coords(oh, ih, dev)
    px = fx[None, :].expand(oh, ow)
    py = fy[:, None].expand(oh, ow)
    rgb = img[..., :3]
    # a tap's texel (iy + dy, ix + dx), clamped, is separable: two takes
    rows = {dy: rgb.index_select(0, torch.clamp(iy + dy, 0, ih - 1))
            for dy in (-1, 0, 1, 2)}
    tex = {k: rows[dy].index_select(1, torch.clamp(ix + dx, 0, iw - 1))
           for k, (dx, dy) in TAPS.items()}
    lum = {k: _luma(c) for k, c in tex.items()}

    dir_x = torch.zeros_like(px)
    dir_y = torch.zeros_like(px)
    length = torch.zeros_like(px)

    def easu_set(w, la, lb, lc, ld, le):
        nonlocal dir_x, dir_y, length
        lenx = torch.maximum(torch.abs(ld - lc), torch.abs(lc - lb))
        lenx = 1.0 / torch.clamp(lenx, min=1e-5)
        dx = ld - lb
        dir_x = dir_x + dx * w
        lx = torch.clamp(torch.abs(dx) * lenx, 0.0, 1.0)
        lx = lx * lx
        leny = torch.maximum(torch.abs(le - lc), torch.abs(lc - la))
        leny = 1.0 / torch.clamp(leny, min=1e-5)
        dy = le - la
        dir_y = dir_y + dy * w
        ly = torch.clamp(torch.abs(dy) * leny, 0.0, 1.0)
        ly = ly * ly
        length = length + (lx + ly) * w

    easu_set((1 - px) * (1 - py), lum["b"], lum["e"], lum["f"], lum["g"],
             lum["j"])
    easu_set(px * (1 - py), lum["c"], lum["f"], lum["g"], lum["h"],
             lum["k"])
    easu_set((1 - px) * py, lum["f"], lum["i"], lum["j"], lum["k"],
             lum["n"])
    easu_set(px * py, lum["g"], lum["j"], lum["k"], lum["l"], lum["o"])

    dir_r = dir_x * dir_x + dir_y * dir_y
    zro = dir_r < (1.0 / 32768.0)
    rsq = 1.0 / torch.sqrt(torch.clamp(dir_r, min=1e-20))
    dir_xn = torch.where(zro, 1.0, dir_x * rsq)
    dir_yn = torch.where(zro, 0.0, dir_y * rsq)
    length = length * 0.5
    length = length * length

    stretch = (dir_xn * dir_xn + dir_yn * dir_yn) / torch.clamp(
        torch.maximum(torch.abs(dir_xn), torch.abs(dir_yn)), min=1e-5)
    len2x = 1.0 + (stretch - 1.0) * length
    len2y = 1.0 - 0.5 * length
    lob = 0.5 + ((1.0 / 4.0 - 0.04) - 0.5) * length
    clp = 1.0 / torch.clamp(lob, min=1e-5)

    min4 = torch.minimum(torch.minimum(tex["f"], tex["g"]),
                         torch.minimum(tex["j"], tex["k"]))
    max4 = torch.maximum(torch.maximum(tex["f"], tex["g"]),
                         torch.maximum(tex["j"], tex["k"]))

    acc = torch.zeros((oh, ow, 3), dtype=torch.float32, device=dev)
    acc_w = torch.zeros_like(px)
    for k, (dx, dy) in TAPS.items():
        offx = dx - px
        offy = dy - py
        vx = (offx * dir_xn + offy * dir_yn) * len2x
        vy = (offx * -dir_yn + offy * dir_xn) * len2y
        d2 = torch.minimum(vx * vx + vy * vy, clp)
        wb = (2.0 / 5.0) * d2 - 1.0
        wa = lob * d2 - 1.0
        wb = wb * wb
        wa = wa * wa
        wb = (25.0 / 16.0) * wb - (25.0 / 16.0 - 1.0)
        wgt = wb * wa
        acc = acc + tex[k] * wgt[..., None]
        acc_w = acc_w + wgt

    out = acc / torch.clamp(acc_w, min=1e-5)[..., None]
    return torch.minimum(torch.maximum(out, min4), max4)


def rcas(img, sharpness: float):
    """Robust contrast-adaptive sharpening of img [h,w,3|4] (alpha passes
    through). sharpness in stops (0 = max). The 4 neighbours wrap around
    the borders, as hikari_tpu's do."""
    sharp = float(np.float32(2.0 ** (-float(sharpness))))

    def sh(dy, dx):
        return torch.roll(img[..., :3], (-dy, -dx), (0, 1))

    e = img[..., :3]
    b = sh(-1, 0)
    d = sh(0, -1)
    f = sh(0, 1)
    h = sh(1, 0)
    mn4 = torch.minimum(torch.minimum(b, d), torch.minimum(f, h))
    mx4 = torch.maximum(torch.maximum(b, d), torch.maximum(f, h))
    hit_min = torch.minimum(mn4, e) / torch.clamp(4.0 * mx4, min=1e-5)
    hit_max = (1.0 - torch.maximum(mx4, e)) / torch.clamp(
        4.0 * mn4 - 4.0, max=-1e-5)
    lobe_rgb = torch.maximum(-hit_min, hit_max)
    lobe = torch.clamp(torch.clamp(lobe_rgb.amax(-1), max=0.0),
                       min=-RCAS_LIMIT) * sharp
    rcp = 1.0 / (4.0 * lobe + 1.0)
    out = ((b + d + f + h) * lobe[..., None] + e) * rcp[..., None]
    if img.shape[-1] == 4:
        out = torch.cat([out, img[..., 3:4]], -1)
    return out
