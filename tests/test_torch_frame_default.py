"""Path D, the literal HikariSettings() (bench.py's frame_ms_default:
temporal reuse, indirect spatial reuse, denoise, TAA Jasmine, SMAA TU4X at
ratio 2): hikari_tpu_torch.Renderer on the CPU against hikari_tpu.Renderer
with its fused Pallas kernels in interpret mode and an exact gather (see
tests/test_torch_frame_post.py), over frames with the camera panning."""

from __future__ import annotations

from tests.test_torch_frame_post import (SIZE, assert_frames_close,
                                         assert_history_close, render_both)
from tests.test_torch_light_temporal import _assert_planes_close
from tests.torch_threads import one_torch_thread  # noqa: F401

# the box has no sun: the direct channel traces nothing and keeps its carry
RESERVOIRS = ("emissive_temporal", "indirect_temporal", "spatial_indirect")


def test_default_frame_matches_reference(monkeypatch):
    """Path D over 4 frames: the image, the post history and the
    render-size reservoir planes (each unpacked field within rtol 1e-2 /
    atol 1e-3 on >= 99% of pixels)."""
    port_r, ref_r, got, ref = render_both(monkeypatch, "D")
    assert_frames_close(got, ref, size=SIZE)
    assert_history_close(port_r.carry, ref_r.carry)
    for k in RESERVOIRS:
        planes = port_r.carry[k].numpy()
        assert planes.shape == (SIZE[0] // 2, 16, SIZE[1] // 2), k
        _assert_planes_close(k, planes, ref_r.carry[k])
