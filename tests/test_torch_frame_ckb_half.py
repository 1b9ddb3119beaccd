"""Checkerboard lighting with SMAA TU4X at ratio 2 on the box's whole frame
against hikari_tpu's: see tests/test_torch_frame_upscale.py."""

from __future__ import annotations

from tests.test_torch_frame_upscale import check_case
from tests.torch_threads import one_torch_thread  # noqa: F401


def test_checkerboard_at_ratio_2_matches_reference(monkeypatch):
    """Kernel B lights the compressed 24x64 domain of the decimated
    G-buffer, kernel 8 copies the parity quads, one reconstruction fills
    the unlit half."""
    from hikari_tpu_torch.ops import light_fused

    lit = []
    real = light_fused.lighting_kernel
    monkeypatch.setattr(light_fused, "lighting_kernel",
                        lambda *a, **k: lit.append(tuple(a[6].shape))
                        or real(*a, **k))
    check_case(monkeypatch, "ckb_smaa_2.0")
    assert lit == [(24, 64, 4)] * 4
