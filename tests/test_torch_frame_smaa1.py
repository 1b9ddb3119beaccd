"""SMAA TU4X at ratio 1 (its supersampling) on the box's whole frame
against hikari_tpu's: see tests/test_torch_frame_upscale.py."""

from __future__ import annotations

from tests.test_torch_frame_upscale import check_case
from tests.torch_threads import one_torch_thread  # noqa: F401


def test_smaa_ratio_1_frame_matches_reference(monkeypatch):
    """SMAA at ratio 1: the render size is the output size, SMAA's output
    and TAA's history twice it."""
    port_r = check_case(monkeypatch, "smaa_1.0")
    assert port_r.carry["prev_tone"].shape == (48, 128, 4)
    assert port_r.carry["prev_taa"].shape == (96, 256, 4)
