"""Path S, the flagship frame with temporal and spatial reuse:
hikari_tpu_torch.Renderer on the CPU against hikari_tpu.Renderer with its
fused Pallas kernels in interpret mode (see test_torch_frame.py)."""

from __future__ import annotations

import pytest

from tests.test_torch_frame import PATHS, assert_frames_close, render_both
from tests.torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("pan", [False, True], ids=["static", "pan"])
def test_spatial_reuse_frame_matches_reference(monkeypatch, pan):
    """Path S over 4 frames."""
    assert_frames_close(*render_both(monkeypatch, PATHS["S"], pan))
