"""Path K, the flagship frame with checkerboard lighting (bench.py's
frame_ms_ckb): hikari_tpu_torch.Renderer on the CPU (the plain versions of
its kernels) against hikari_tpu.Renderer with its fused Pallas kernels in
interpret mode, over frames with the camera panning one pixel per frame.
Kernel B lights the compressed [h, w/2] domain; the unlit half is
reconstructed before the denoiser."""

from __future__ import annotations

import dataclasses

import numpy as np

import hikari_tpu as hj
import hikari_tpu_torch as ht
from tests.cornell_box import build_cornell_box
from tests.test_torch_frame import SIZE, assert_frames_close, flagship
from tests.test_torch_frame_ckb_reuse import camera, reference_renderer
from tests.torch_threads import one_torch_thread  # noqa: F401

FRAMES = 4


def settings(pkg):
    """bench.py:140-141: the flagship with checkerboard lighting."""
    return dataclasses.replace(flagship(pkg), checkerboard_lighting=True)


def port_renderer():
    return ht.Renderer(build_cornell_box("hikari_tpu_torch"), camera(ht, 0),
                       settings(ht), device="cpu")


def test_checkerboard_frame_matches_reference(monkeypatch):
    """Path K over 4 frames (both parities twice) with the camera
    panning."""
    ref_r = reference_renderer(monkeypatch, settings(hj))
    port_r = port_renderer()
    for i in range(FRAMES):
        ref_r.camera = camera(hj, i)
        port_r.camera = camera(ht, i)
        ref = np.asarray(ref_r.render_frame())
        got = port_r.render_frame().numpy()
    assert_frames_close(got, ref)


def test_checkerboard_lights_half_the_pixels(monkeypatch):
    """Kernel B's plain version runs over the compressed 48x32 domain,
    on this frame's lit pixels."""
    from hikari_tpu_torch.ops import light_fused

    calls = []
    real = light_fused.lighting_kernel

    def spy(*a, **k):
        calls.append(a[6])               # the position plane it lights
        return real(*a, **k)

    monkeypatch.setattr(light_fused, "lighting_kernel", spy)
    r = port_renderer()
    r.render(2)
    assert [tuple(p.shape) for p in calls] == [(SIZE[0], SIZE[1] // 2, 4)] * 2
    assert not np.array_equal(calls[0].numpy(), calls[1].numpy())


def test_checkerboard_state_resumes_bit_exactly(tmp_path):
    """Path K restored from a saved state renders what the original
    renders next, bit for bit (the frame number picks the parity)."""
    a = port_renderer()
    a.render(1)
    path = str(tmp_path / "state.pkl")
    a.save_state(path)
    b = port_renderer()
    b.load_state(path)
    np.testing.assert_array_equal(b.render(2), a.render(2))
