"""FSR 1.0 of hikari_tpu_torch (ops/fsr.py: EASU and RCAS) against
hikari_tpu's (ops/fsr.py, XLA ops run eagerly, op by op, so that no FMA
contraction enters), on seeded images at every upscale ratio the
settings clamp to [1, 2].

Tolerance: float32 round-off, |got - ref| <= 1e-6 + 1e-5 * |ref|. EASU's
source coordinates are compared bit for bit in tests/test_torch_upscale.py.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hikari_tpu.ops import fsr as fsr_ref
from hikari_tpu_torch.frame import scaled_size
from hikari_tpu_torch.ops import fsr
from tests.torch_threads import one_torch_thread  # noqa: F401

FULL = (30, 52)
RTOL, ATOL = 1e-5, 1e-6


def _image(seed, size, channels=4):
    """Seeded colours with hard edges (blocks of 3x3 texels) and noise, so
    that EASU's edge directions and RCAS's lobe vary."""
    rng = np.random.default_rng(seed)
    h, w = size
    blocks = rng.uniform(0.0, 1.0, (-(-h // 3), -(-w // 3), channels))
    img = np.repeat(np.repeat(blocks, 3, 0), 3, 1)[:h, :w]
    img = img + rng.normal(0.0, 0.05, img.shape)
    if channels == 4:
        img[..., 3] = 1.0
    return img.astype(np.float32)


def _close(got, ref):
    got = got.numpy()
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("ratio", [1.0, 1.3, 1.5, 2.0])
def test_easu_matches_reference(ratio):
    """EASU from the render size of `ratio` to the output size: RGB only."""
    img = _image(int(ratio * 10), scaled_size(FULL, ratio))
    got = fsr.easu(torch.from_numpy(img), FULL)
    ref = fsr_ref.easu(jnp.asarray(img), FULL)
    assert got.shape == FULL + (3,)
    _close(got, ref)


@pytest.mark.parametrize("sharpness", [0.0, 0.2])
@pytest.mark.parametrize("ratio", [1.0, 1.3, 1.5, 2.0])
def test_easu_then_rcas_matches_reference(ratio, sharpness):
    """The post chain's FSR: EASU, an alpha of ones, RCAS at the
    sharpness (stops; 0 = the strongest)."""
    img = _image(int(ratio * 10) + 1, scaled_size(FULL, ratio))
    ones = np.ones(FULL + (1,), np.float32)
    up = fsr.easu(torch.from_numpy(img), FULL)
    got = fsr.rcas(torch.cat([up, torch.from_numpy(ones)], -1), sharpness)
    up_ref = fsr_ref.easu(jnp.asarray(img), FULL)
    ref = fsr_ref.rcas(jnp.concatenate([up_ref, jnp.asarray(ones)], -1),
                       sharpness)
    assert got.shape == FULL + (4,)
    _close(got, ref)
    np.testing.assert_array_equal(got[..., 3].numpy(), 1.0)


@pytest.mark.parametrize("channels", [3, 4])
def test_rcas_matches_reference(channels):
    """RCAS alone on 3 and 4 channels (the alpha passes through)."""
    img = _image(7, FULL, channels)
    _close(fsr.rcas(torch.from_numpy(img), 0.5),
           fsr_ref.rcas(jnp.asarray(img), 0.5))


def test_rcas_wraps_at_the_borders():
    """hikari_tpu's RCAS reads its neighbours with jnp.roll, so a border
    pixel sees the opposite edge (AMD's RCAS clamps to the edge); the port
    keeps the wrap. Changing the last column changes the first column's
    output in both, and a clamp-to-edge RCAS would not."""
    img = _image(8, FULL, 3)
    moved = img.copy()
    moved[:, -1] = 1.0 - moved[:, -1]
    outs = {}
    for name, x in (("img", img), ("moved", moved)):
        outs[name] = fsr.rcas(torch.from_numpy(x), 0.0).numpy()
        _close(torch.from_numpy(outs[name]), fsr_ref.rcas(jnp.asarray(x),
                                                          0.0))
    first = np.abs(outs["img"][:, 0] - outs["moved"][:, 0]).max()
    assert first > 1e-3, first
    # the interior column next to the first reads no wrapped neighbour
    np.testing.assert_array_equal(outs["img"][:, 2], outs["moved"][:, 2])
