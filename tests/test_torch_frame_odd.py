"""SMAA TU4X at ratio 2 at an odd output size on the box's whole frame
against hikari_tpu's: see tests/test_torch_frame_upscale.py."""

from __future__ import annotations

from tests.test_torch_frame_upscale import check_case
from tests.torch_threads import one_torch_thread  # noqa: F401


def test_ratio_2_at_an_odd_size_matches_reference(monkeypatch):
    """47x255 at ratio 2 renders 24x128 through the generic resample:
    kernel A's full-only call and no parity quads (kernel 8 does not
    launch)."""
    from hikari_tpu_torch.ops import prepass_fused

    calls = []
    real = prepass_fused.prepass_quads_kernel
    monkeypatch.setattr(prepass_fused, "prepass_quads_kernel",
                        lambda *a: calls.append(1) or real(*a))
    port_r = check_case(monkeypatch, "smaa_2.0_odd")
    assert calls == []
    assert port_r.carry["prev_tone"].shape == (24, 128, 4)
