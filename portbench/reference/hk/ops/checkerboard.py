"""Checkerboard lighting: light half the pixels each frame (the port of
hikari_tpu/ops/checkerboard.py).

Each frame the lighting runs only for pixels with (x + y + frame) % 2 == 0,
laid out densely as an [h, w/2] "compressed" domain; the other half is
reconstructed from its lit neighbours, gated by depth and normal. With
temporal reuse the full-resolution reservoir carry keeps the unlit half's
reservoirs, so every pixel's reservoir refreshes every other frame.

compress / compress_planes / expand / merge_packed_planes are selections
(strided views and a row-parity select), bit for bit; reconstruct is the
only arithmetic.
"""

from __future__ import annotations

import torch

from portbench.reference.hk.ops._kernel import div
from portbench.reference.hk.ops.filters import shift_edge

# neighbour order of the reconstruction (its summation order)
NEIGHBOURS = ((0, 1), (0, -1), (1, 0), (-1, 0))


def _row_even(par: int, h: int, device) -> torch.Tensor:
    """[h] bool: True where the row's lit pixels sit at even x."""
    return (torch.arange(h, device=device) + par) % 2 == 0


def active_mask(par: int, size, device=None) -> torch.Tensor:
    """[h, w] bool: True at the pixels lit this frame."""
    h, w = size
    yy = torch.arange(h, device=device)[:, None]
    xx = torch.arange(w, device=device)[None, :]
    return (xx + yy + par) % 2 == 0


def pixel_uv(size, par: int, device=None) -> torch.Tensor:
    """[h, w/2, 2]: the true pixel-centre uv of each compressed-domain
    pixel."""
    h, w = size
    o = (torch.arange(h, device=device)[:, None] + par) % 2
    xs = 2 * torch.arange(w // 2, device=device)[None, :] + o
    u = div(xs.to(torch.float32) + 0.5, float(w))
    v = div(torch.arange(h, dtype=torch.float32, device=device) + 0.5,
            float(h))[:, None].expand(u.shape)
    return torch.stack([u, v], -1)


def _rows(t: torch.Tensor, row_even: torch.Tensor) -> torch.Tensor:
    """row_even shaped to broadcast over t's trailing axes."""
    return row_even.reshape((-1,) + (1,) * (t.dim() - 1))


def compress(x: torch.Tensor, par: int) -> torch.Tensor:
    """[h, w, ...] -> [h, w/2, ...]: out[y, i] = x[y, 2i + (y + par) % 2].
    Needs an even w."""
    h, w = x.shape[:2]
    if w % 2:
        raise ValueError("checkerboard lighting needs an even render width")
    even, odd = x[:, 0::2], x[:, 1::2]
    return torch.where(_rows(even, _row_even(par, h, x.device)), even, odd)


def compress_planes(p: torch.Tensor, par: int) -> torch.Tensor:
    """compress for the channel-plane layout: [h, F, w] -> [h, F, w/2]."""
    h, _, w = p.shape
    if w % 2:
        raise ValueError("checkerboard lighting needs an even render width")
    even, odd = p[:, :, 0::2], p[:, :, 1::2]
    return torch.where(_row_even(par, h, p.device)[:, None, None], even, odd)


def expand(a: torch.Tensor, par: int) -> torch.Tensor:
    """[h, w/2, ...] -> [h, w, ...] with zeros at the unlit pixels."""
    h, hw = a.shape[:2]
    z = torch.zeros_like(a)
    at_even = torch.stack([a, z], 2).reshape((h, 2 * hw) + a.shape[2:])
    at_odd = torch.stack([z, a], 2).reshape((h, 2 * hw) + a.shape[2:])
    return torch.where(_rows(at_even, _row_even(par, h, a.device)), at_even,
                       at_odd)


def reconstruct(full, mask, depth, normal):
    """Fill the unlit pixels of `full` [h, w, c] from their 4 lit
    neighbours (clamp-to-edge), each gated by the depth ratio in
    [0.9, 1.1] (denominator where(nb == 0, 1e-30, nb)) and n . n' >= 0.866;
    where every gate fails, the plain 4-neighbour mean. mask [h, w] bool
    lit; depth [h, w], normal [h, w, 3]: the render-size G-buffer."""
    num = torch.zeros_like(full)
    den = torch.zeros(full.shape[:2], dtype=full.dtype, device=full.device)
    num_f = torch.zeros_like(full)
    for dy, dx in NEIGHBOURS:
        nb = shift_edge(full, dy, dx)
        nb_depth = shift_edge(depth, dy, dx)
        nb_normal = shift_edge(normal, dy, dx)
        ratio = div(depth, torch.where(nb_depth == 0.0, 1e-30, nb_depth))
        ok = (nb_depth > 0.0) & (ratio >= 0.9) & (ratio <= 1.1)
        ok = ok & ((normal * nb_normal).sum(-1) >= 0.866)
        wgt = ok.to(full.dtype)
        num = num + wgt[..., None] * nb
        den = den + wgt
        num_f = num_f + nb
    recon = torch.where(den[..., None] > 0.0,
                        div(num, torch.clamp(den, min=1.0)[..., None]),
                        num_f * 0.25)
    return torch.where(mask[..., None], full, recon)


def merge_packed_planes(new_c, old_full, par: int):
    """This frame's compressed reservoir planes new_c [h, F, w/2] into the
    full carry old_full [h, F, w]: lit pixels take the new reservoirs,
    unlit ones keep the carry's."""
    out = old_full.clone()
    # rows y = par (mod 2) are lit at even x, the others at odd x
    out[par::2, :, 0::2] = new_c[par::2]
    out[1 - par::2, :, 1::2] = new_c[1 - par::2]
    return out
