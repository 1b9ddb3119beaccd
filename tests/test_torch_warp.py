"""Kernels 11 and 12's plain versions (hikari_tpu_torch.ops.warp_band /
warp2) against hikari_tpu's banded and windowed Pallas warps in interpret
mode.

The TPU kernels are exact only inside their band (warp_band: integer
residual within R of the 8x128 group's mean) or window (warp2: the 32-row
window of each 16x16 group); outside it they clamp local coords to the
band / window edge. The port filters every pixel exactly, so parity is
asserted on the in-band / in-window pixels, and their share is floored.
The coordinate fields are smooth (tests/test_warp_band.py:_fields) and
quantized to odd multiples of 1/2048 px: the TPU kernel adds its margins
(8 rows, 64 columns) to the coords in float32, which moves a fractional
part by up to half an ulp of the shifted coord, and quantized coords make
that exact; odd multiples are never .5 ties, where the TPU kernel rounds
its band-local coord and the port the image coord.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hikari_tpu.ops import warp_band as band_ref
from hikari_tpu.ops.warp2 import warp_multi as multi_ref
from hikari_tpu_torch.ops.warp2 import warp_multi
from hikari_tpu_torch.ops.warp_band import warp_band
from tests.test_warp_band import _fields
from tests.torch_threads import one_torch_thread  # noqa: F401

BAND = (16, 256)          # two 8-row groups x two 128-wide groups
MULTI_OUT = (32, 64)      # SMAA's shapes: a source at twice the output
WEIGHTED_TOL = 1e-5


def _quantize(a):
    q = np.floor(np.asarray(a, np.float64) * 1024.0) + 0.5
    return (q / 1024.0).astype(np.float32)


def _in_band(sy, sx, hs, w):
    """Pixels whose banded local coords hikari_tpu does not clamp
    (warp_band._warp_impl / _band_coords, recomputed in numpy)."""
    gh, gw, mx = band_ref.GROUP_H, band_ref.GROUP_W, band_ref.MX
    h = sy.shape[0]
    hp, wp = -(-h // gh) * gh, -(-w // gw) * gw
    ws_p = -(-(w + mx + 2 * band_ref.CHUNK + mx) // band_ref.CHUNK) \
        * band_ref.CHUNK
    syp = np.pad(np.clip(sy, 0, hs - 1) + np.float32(gh),
                 ((0, hp - h), (0, wp - w)), mode="edge")
    sxp = np.pad(np.clip(sx, 0, w - 1) + np.float32(mx),
                 ((0, hp - h), (0, wp - w)), mode="edge")
    yy = np.arange(hp, dtype=np.float32)[:, None]
    xx = np.arange(wp, dtype=np.float32)[None, :]

    def gmean(v):
        return np.round(v.reshape(hp // gh, gh, wp // gw, gw).mean(
            axis=(1, 3), dtype=np.float32)).astype(np.int64)

    off = band_ref.R + 1
    row0 = np.clip(np.arange(hp // gh)[:, None] * gh + gmean(syp - yy) - off,
                   0, hs + 2 * gh - band_ref.WIN_R)
    x0 = np.clip(np.arange(wp // gw)[None, :] * gw + gmean(sxp - xx) - off,
                 0, ws_p - 2 * band_ref.CHUNK - 1)
    ly = syp - np.repeat(np.repeat(row0, gh, 0), gw, 1) - yy % gh
    lx = sxp - np.repeat(np.repeat(x0, gh, 0), gw, 1) - xx % gw
    hi = band_ref.NSH - 2 - 1e-3
    return ((ly >= 1) & (ly <= hi) & (lx >= 1) & (lx <= hi))[:h, :w]


def _in_window(sy, sx, hs, ws, offset, margin):
    """Pixels whose windowed local coords hikari_tpu's warp2 does not clamp
    (_warp_core, recomputed in numpy)."""
    g = 16
    h, w = sy.shape
    hh, ww = -(-h // g) * g, -(-w // g) * g
    y = np.clip(np.pad(sy, ((0, hh - h), (0, ww - w)), mode="edge"), 0, hs - 1)
    x = np.clip(np.pad(sx, ((0, hh - h), (0, ww - w)), mode="edge"), 0, ws - 1)

    def origin(v, blocks):
        m = v.reshape(hh // g, g, ww // g, g).mean(axis=(1, 3),
                                                   dtype=np.float32)
        b = np.clip(np.round((m - 16) / 8).astype(np.int64), 0,
                    max(blocks, 4) - 4)
        return np.repeat(np.repeat(b * 8, g, 0), g, 1)

    ly = y - origin(y, -(-hs // 8)) + offset[0]
    lx = x - origin(x, -(-ws // 8)) + offset[1]
    lo, hi = margin - 1, 32 - margin
    return ((ly >= lo) & (ly <= hi) & (lx >= lo) & (lx <= hi))[:h, :w]


def _band_both(sources, kinds, sy, sx):
    """(port, reference) outputs as [h, w, F] numpy arrays."""
    ref = band_ref.warp_band([jnp.asarray(np.moveaxis(s, -1, 1))
                              for s in sources], kinds, jnp.asarray(sy),
                             jnp.asarray(sx), interpret=True)
    got = warp_band([torch.from_numpy(s) for s in sources], kinds,
                    torch.from_numpy(sy), torch.from_numpy(sx))
    return ([g.numpy() for g in got],
            [np.moveaxis(np.asarray(r), 1, -1) for r in ref])


# the source layouts kernel 11 branches on: (pixel stride, channels); a
# source is the first channels of a contiguous [hs, w, stride] array
BAND_LAYOUTS = {"3_of_stride_4": (4, 3), "6_contiguous": (6, 6),
                "1_channel": (1, 1), "5_of_stride_8": (8, 5)}
# kernel 12's: (pixel stride, channels)
MULTI_LAYOUTS = {"16_channels": (16, 16), "3_of_stride_4": (4, 3)}
BAND_KINDS = [("catmull", "nearest"), ("bilinear", "catmull"),
              ("nearest", "bilinear")]


def _layout(rng, shape, layout, lo, hi):
    """A [*shape, F] float32 view of (pixel stride, F), uniform in [lo, hi)."""
    p, f = layout
    return rng.uniform(lo, hi, tuple(shape) + (p,)).astype(np.float32)[
        ..., :f]


def _assert_band_parity(kinds, got, ref, ok):
    for kind, g, r in zip(kinds, got, ref):
        if kind == "nearest":
            np.testing.assert_array_equal(g[ok], r[ok], err_msg=kind)
        else:
            err = np.abs(g[ok] - r[ok]).max()
            assert err <= WEIGHTED_TOL, (kind, err)


@pytest.mark.parametrize(
    ("kinds", "layout"),
    [(k, None) for k in BAND_KINDS]
    + [(k, name) for name in BAND_LAYOUTS for k in BAND_KINDS],
    ids=["+".join(k) for k in BAND_KINDS]
    + [f"{'+'.join(k)}-{name}" for name in BAND_LAYOUTS for k in BAND_KINDS])
def test_warp_band_matches_reference(kinds, layout):
    """F = 3 and 6 in one call (layout None), or two sources of one layout
    of BAND_LAYOUTS (strided channel slices), on a smooth field that
    spills < 1.3 px over the borders."""
    rng = np.random.default_rng(11)
    h, w = BAND
    if layout is None:
        sources = [rng.uniform(0, 1, (h, w, 3)).astype(np.float32),
                   rng.uniform(-2, 2, (h, w, 6)).astype(np.float32)]
    else:
        sources = [_layout(rng, (h, w), BAND_LAYOUTS[layout], 0, 1),
                   _layout(rng, (h, w), BAND_LAYOUTS[layout], -2, 2)]
    sy, sx = (_quantize(a) for a in _fields(h, w, 1.0, seed=4))
    ok = _in_band(sy, sx, h, w)
    assert ok.mean() >= 0.99, ok.mean()
    _assert_band_parity(kinds, *_band_both(sources, kinds, sy, sx), ok)


@pytest.mark.parametrize("shift", [(-0.7, 0.6), (0.8, -0.9)],
                         ids=["up_right", "down_left"])
def test_warp_band_borders(shift):
    """A sub-pixel spill over every border stays in band and clamps its
    taps to the edge in both."""
    rng = np.random.default_rng(13)
    h, w = BAND
    sources = [rng.uniform(0, 1, (h, w, 3)).astype(np.float32),
               rng.uniform(0, 1, (h, w, 6)).astype(np.float32)]
    yy, xx = np.meshgrid(np.arange(h, dtype=np.float32),
                         np.arange(w, dtype=np.float32), indexing="ij")
    sy = _quantize(yy + shift[0])
    sx = _quantize(xx + shift[1])
    ok = _in_band(sy, sx, h, w)
    assert ok.all()
    kinds = ("catmull", "nearest")
    _assert_band_parity(kinds, *_band_both(sources, kinds, sy, sx), ok)


def _multi_field(seed, layout=(4, 4)):
    """SMAA's aux fetch: output pixel (y, x) reads source (2y + j, 2x + j)
    minus a smooth reprojection. The source has `layout` (pixel stride,
    channels)."""
    rng = np.random.default_rng(seed)
    h, w = MULTI_OUT
    yy, xx = np.meshgrid(np.arange(h, dtype=np.float64) * 2.0,
                         np.arange(w, dtype=np.float64) * 2.0, indexing="ij")
    sy = yy + 1.0 + 1.3 * np.sin(xx / 20.0) + rng.uniform(-0.3, 0.3, (h, w))
    sx = xx - 2.1 * np.cos(yy / 17.0) + rng.uniform(-0.3, 0.3, (h, w))
    src = _layout(rng, (2 * h, 2 * w), layout, 0, 4)
    # SMAA's channel 1: instance ids + 0.5, mod 256
    src[..., 1] = rng.integers(0, 300, (2 * h, 2 * w)) % 256 + 0.5
    return src, _quantize(sy), _quantize(sx)


def _multi_bf16_nearest(src, sy, sx):
    f = src.shape[2]
    reduces = [("nearest", (0.0, 0.0), (0, f))]
    ref, = multi_ref(jnp.asarray(src), jnp.asarray(sy), jnp.asarray(sx),
                     reduces, dtype=jnp.bfloat16)
    got, = warp_multi(torch.from_numpy(src), torch.from_numpy(sy),
                      torch.from_numpy(sx), reduces, dtype=torch.bfloat16)
    ok = _in_window(sy, sx, *src.shape[:2], (0.0, 0.0), 1)
    assert ok.mean() >= 0.9, ok.mean()
    np.testing.assert_array_equal(got.numpy()[ok], np.asarray(ref)[ok])


def test_warp_multi_matches_reference_bf16_nearest():
    """SMAA's call: nearest, bf16 window, 4 channels; equal in window."""
    _multi_bf16_nearest(*_multi_field(17))


@pytest.mark.parametrize("layout", list(MULTI_LAYOUTS))
def test_warp_multi_layouts_match_reference_bf16_nearest(layout):
    """SMAA's call on the other source layouts of kernel 12 (16 channels,
    a 3-channel slice at stride 4): equal in window."""
    _multi_bf16_nearest(*_multi_field(17, MULTI_LAYOUTS[layout]))


def _multi_f32_filters(src, sy, sx):
    reduces = [("bilinear", (1.0, -1.0), (0, 3)),
               ("catmull", (0.0, 0.5), (1, src.shape[2]))]
    ref = multi_ref(jnp.asarray(src), jnp.asarray(sy), jnp.asarray(sx),
                    reduces)
    got = warp_multi(torch.from_numpy(src), torch.from_numpy(sy),
                     torch.from_numpy(sx), reduces)
    for (kind, off, _), g, r in zip(reduces, got, ref):
        ok = _in_window(sy, sx, *src.shape[:2], off,
                        2 if kind == "catmull" else 1)
        assert ok.mean() >= 0.75, (kind, ok.mean())
        # channel 1 holds ids up to 255.5: the tolerance scales with |ref|
        r = np.asarray(r)[ok]
        err = np.abs(g.numpy()[ok] - r) / np.maximum(np.abs(r), 1.0)
        assert err.max() <= WEIGHTED_TOL, (kind, err.max())


def test_warp_multi_matches_reference_f32_filters():
    """Bilinear and Catmull-Rom reduces with offsets, f32 window: within
    1e-5 * max(|ref|, 1)."""
    _multi_f32_filters(*_multi_field(19))


@pytest.mark.parametrize("layout", list(MULTI_LAYOUTS))
def test_warp_multi_layouts_match_reference_f32_filters(layout):
    """The filtered reduces on kernel 12's other source layouts."""
    _multi_f32_filters(*_multi_field(19, MULTI_LAYOUTS[layout]))


def test_nearest_tie_rules():
    """warp_band rounds a .5 coord half to even (the TPU kernel's
    jnp.round); warp_multi half down (warp2's |d| <= 0.5 & d > -0.5)."""
    src = torch.arange(8, dtype=torch.float32).reshape(1, 8, 1).expand(
        8, 8, 1).contiguous()
    sx = torch.tensor([[2.5, 3.5, 0.49, 6.51]]).expand(2, 4).contiguous()
    sy = torch.zeros((2, 4))
    band, = warp_band([src], ("nearest",), sy, sx)
    multi, = warp_multi(src, sy, sx, [("nearest", (0.0, 0.0), (0, 1))])
    assert band[0, :, 0].tolist() == [2.0, 4.0, 0.0, 7.0]
    assert multi[0, :, 0].tolist() == [2.0, 3.0, 0.0, 7.0]
