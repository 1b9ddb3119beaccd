"""Kernel 9's plain version (hikari_tpu_torch.ops.reproj_gather) against
hikari_tpu's banded Pallas gather in interpret mode, on the pan and the
zoom/rotate motion fields of tests/test_reproj_gather.py.

The contract: the port equals the exact gather everywhere (zeros where the
source coordinate lies outside the source); hikari_tpu's band returns the
same words or zeros at every pixel; under a static field the two are
identical."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hikari_tpu.ops.reproj_gather import reproj_gather as gather_ref
from hikari_tpu_torch.ops.reproj_gather import reproj_gather
from tests.test_reproj_gather import _field
from tests.torch_threads import one_torch_thread  # noqa: F401


def _motion(kind, mag, h, w):
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    if kind == "zoom":
        py = cy + (1.0 + mag) * (yy - cy)
        px = cx + (1.0 + mag) * (xx - cx)
    else:
        c, s = np.cos(mag), np.sin(mag)
        py = cy + c * (yy - cy) - s * (xx - cx)
        px = cx + s * (yy - cy) + c * (xx - cx)
    return np.round(py).astype(np.int32), np.round(px).astype(np.int32)


def _check(srcs, piy, pix, floor, interior=None):
    """floor: the least share of live pixels on which hikari_tpu's band
    returns the port's words; interior: pixels a full band group away from
    any clipped frame edge, where the band must accept every pixel."""
    h, f, w = srcs[0].shape
    got = reproj_gather([torch.from_numpy(s) for s in srcs],
                        torch.from_numpy(piy), torch.from_numpy(pix))
    want = gather_ref([jnp.asarray(s) for s in srcs], jnp.asarray(piy),
                      jnp.asarray(pix))
    live = (piy >= 0) & (piy < h) & (pix >= 0) & (pix < w)
    for s, g_, r_ in zip(srcs, got, want):
        g_ = g_.numpy()
        r_ = np.asarray(r_)
        exact = np.moveaxis(s[np.clip(piy, 0, h - 1), :,
                              np.clip(pix, 0, w - 1)], -1, 1)
        exact = np.where(live[:, None, :], exact, 0.0)
        # the port is the exact gather, bit for bit
        np.testing.assert_array_equal(g_.view(np.uint32),
                                      exact.view(np.uint32))
        # hikari_tpu's band keeps the same words or rejects to zero
        same = (r_.view(np.uint32) == g_.view(np.uint32)).all(axis=1)
        zero = (r_ == 0).all(axis=1)
        assert (same | zero).all()
        # ... and keeps them, bit for bit, on most pixels
        assert same[live].mean() >= floor, same[live].mean()
        if interior is not None:
            assert same[interior].all()
    return got, want


@pytest.mark.parametrize("pan,floor", [
    # observed shares of live pixels equal to the port: 1.0, 0.9705,
    # 0.5381; the big pan clips a third of each band group at the frame
    # edge, and the band rejects those groups (the disocclusion contract)
    ((0.0, 0.0), 1.0), ((-3.2, 5.7), 0.95), ((12.0, -40.0), 0.5)])
def test_pans(pan, floor):
    rng = np.random.default_rng(0)
    h, w, f = 48, 384, 16
    srcs = [rng.normal(size=(h, f, w)).astype(np.float32) for _ in range(2)]
    piy, pix = _field(h, w, *pan, grad=0.002)
    # the frame's sentinel: rejected pixels read -1 (hikari_tpu counts
    # them into its group means and may reject their neighbours too; the
    # port reads zeros there and the exact words elsewhere)
    piy[::7, ::11] = -1
    # the interior of tests/test_reproj_gather.py: every pixel in-band
    yy, xx = np.mgrid[0:h, 0:w]
    interior = ((yy + pan[0] >= 8) & (yy + pan[0] <= h - 9)
                & (xx + pan[1] >= 128) & (xx + pan[1] <= w - 129))
    _check(srcs, piy, pix, floor, interior)


@pytest.mark.parametrize("kind,mag,floor", [
    # the floors of tests/test_reproj_gather.py's non-translational cases;
    # observed shares 1.0, 1.0, 1.0, 0.9422
    ("zoom", 0.01, 0.999), ("rotate", 0.01, 0.999), ("zoom", 0.02, 0.99),
    ("rotate", 0.02, 0.90)])
def test_zoom_and_rotation(kind, mag, floor):
    rng = np.random.default_rng(7)
    h, w, f = 64, 384, 8
    src = rng.normal(size=(h, f, w)).astype(np.float32)
    piy, pix = _motion(kind, mag, h, w)
    _check([src], piy, pix, floor)


def test_static_field_is_identical():
    """Zero motion: both are the identity, bit for bit."""
    rng = np.random.default_rng(1)
    h, w, f = 40, 256, 16
    src = rng.normal(size=(h, f, w)).astype(np.float32)
    piy, pix = _field(h, w, 0.0, 0.0)
    got, want = _check([src], piy, pix, 1.0, np.ones((h, w), bool))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[0].numpy(), src)


def test_packed_words_are_copied_exactly():
    """Packed reservoir words that read as float32 denormals (a bf16 pair
    with a zero high half) or signalling NaNs (an snorm8 word with the
    flag byte 255) come through the port's gather unchanged. hikari_tpu's
    band sums masked slabs: on the CPU it flushes the denormal words to 0
    and quiets the signalling NaNs, and changes no other word. That is why
    the whole-frame tests give the reference an exact gather
    (tests/test_torch_frame.py:exact_gather)."""
    rng = np.random.default_rng(4)
    h, w, f = 16, 128, 4
    src = rng.normal(size=(h, f, w)).astype(np.float32)
    u = src.view(np.uint32)
    u[:, 0] = rng.integers(1, 0x7FFFFF, size=(h, w))              # denormal
    u[:, 1] = 0xFF800001 + rng.integers(0, 0x3FFFFF, size=(h, w))  # sNaN
    piy, pix = _field(h, w, 0.0, 0.0)
    got, = reproj_gather([torch.from_numpy(src)], torch.from_numpy(piy),
                         torch.from_numpy(pix))
    want, = gather_ref([jnp.asarray(src)], jnp.asarray(piy),
                       jnp.asarray(pix))
    got, want = got.numpy(), np.asarray(want)
    np.testing.assert_array_equal(got.view(np.uint32), u)
    ref = want.view(np.uint32)
    np.testing.assert_array_equal(ref[:, 0], 0)
    np.testing.assert_array_equal(ref[:, 1], u[:, 1] | 0x400000)
    np.testing.assert_array_equal(ref[:, 2:], u[:, 2:])

