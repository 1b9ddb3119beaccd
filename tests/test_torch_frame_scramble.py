"""HikariSettings() on the box with the spatial tap scramble on
(HikariSettings.spatial_tap_scramble): temporal and indirect spatial
reuse on the modular lighting path (kernel 10 takes no scramble), the
per-pixel rotation of each spiral tap picked by the blue noise's third
channel. hikari_tpu_torch.Renderer on the CPU against hikari_tpu.Renderer
as in tests/test_torch_frame_spatial_noreuse.py (its helpers, sizes and
bars: three frames at 48x256, SSIM >= 0.98 and mean abs diff < 1e-3 each;
the indirect spatial carry's fields within rtol 1e-2 / atol 1e-3 on >= 99%
of pixels)."""

from __future__ import annotations

import pytest

from tests.test_torch_frame_spatial_noreuse import (FRAMES, check_frame,
                                                    check_modular_spatial,
                                                    check_spatial_carry,
                                                    render_both)
from tests.torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def frames():
    return render_both(spatial_tap_scramble=True)


def test_scramble_pass_is_modular(frames):
    assert frames[0].settings.temporal_reuse
    check_modular_spatial(frames)


@pytest.mark.parametrize("f", range(FRAMES))
def test_scramble_frames_match_reference(frames, f):
    check_frame(frames, f)


def test_scramble_carry_matches_reference(frames):
    check_spatial_carry(frames)
