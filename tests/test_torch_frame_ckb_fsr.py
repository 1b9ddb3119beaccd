"""Checkerboard lighting with FSR 1.0 at ratio 1.5 on the box's frame
against hikari_tpu's, with the camera panning one output pixel a frame:
see tests/test_torch_frame_upscale.py. The whole port misses the frame bar
here under motion, at knife edges of kernel A's last bits
(tests/torch_pan_witness.py ckb_fsr1_1.5), so this case takes the exact
check: the port fed hikari_tpu's G-buffer, hikari_tpu's resample and post
chain as written, the image within 1e-5 mean abs diff."""

from __future__ import annotations

from tests.test_torch_frame_upscale import check_case
from tests.torch_threads import one_torch_thread  # noqa: F401


def test_checkerboard_with_fsr_at_ratio_1_5_matches_reference(monkeypatch):
    """Kernel B lights the compressed 32x64 domain of the generic
    resample's 32x128 G-buffer, one reconstruction fills the unlit half,
    TAA runs at 32x128 and FSR upscales to 48x192; kernel 8 does not
    launch."""
    from hikari_tpu_torch.ops import light_fused, prepass_fused

    lit, quads = [], []
    real = light_fused.lighting_kernel
    monkeypatch.setattr(light_fused, "lighting_kernel",
                        lambda *a, **k: lit.append(tuple(a[6].shape))
                        or real(*a, **k))
    real_quads = prepass_fused.prepass_quads_kernel
    monkeypatch.setattr(prepass_fused, "prepass_quads_kernel",
                        lambda *a: quads.append(1) or real_quads(*a))
    port_r = check_case(monkeypatch, "ckb_fsr1_1.5", exact=True)
    assert lit == [(32, 64, 4)] * 4
    assert quads == []
    assert port_r.carry["prev_taa"].shape == (32, 128, 4)
