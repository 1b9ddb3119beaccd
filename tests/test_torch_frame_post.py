"""Path P, the flagship frame with SMAA TU4X at ratio 2 and TAA Jasmine
(bench.py's frame_ms_smaa2): hikari_tpu_torch.Renderer on the CPU (the
plain versions of its kernels) against hikari_tpu.Renderer with its fused
Pallas kernels in interpret mode, over frames with the camera panning one
pixel per frame.

The output is 48x256 (lighting at 24x128): hikari_tpu's banded warp is
exact only on whole 128-wide groups (tests/test_torch_post.py), so both
the TAA fetch (256 wide) and SMAA's tone fetch (128 wide) stay in band.
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch

import hikari_tpu as hj
import hikari_tpu.ops.reproj_gather as reproj_ref
import hikari_tpu_torch as ht
from tests.cornell_box import EYE, TARGET, build_cornell_box
from tests.test_torch_frame import assert_frames_close, exact_gather, flagship
from tests.torch_threads import one_torch_thread  # noqa: F401

SIZE = (48, 256)
FRAMES = 4
# one pixel of sideways camera motion per frame at the box's depth
PAN_PX = 2.0 * 3.2 * np.tan(np.pi / 8.0) / SIZE[0]


def path_settings(pkg, path):
    """P: the flagship + TAA Jasmine + SMAA TU4X 2.0 (bench.py:142-144);
    D: the literal HikariSettings() (bench.py:148)."""
    if path == "D":
        return pkg.HikariSettings()
    return dataclasses.replace(flagship(pkg), taa=pkg.Taa.JASMINE,
                               upscale=pkg.Upscale.smaa_tu4x(2.0))


def camera(pkg, i):
    d = (PAN_PX * i, 0.0, 0.0)
    return pkg.Camera.from_look_at(tuple(np.add(EYE, d)),
                                   tuple(np.add(TARGET, d)),
                                   width=SIZE[1], height=SIZE[0])


_REFERENCE = {}


def reference_renderer(monkeypatch, path):
    """hikari_tpu's Renderer for the path, reset, with the fused Pallas
    kernels (interpret mode) and the exact gather (see
    tests/test_torch_frame.py:reference_renderer)."""
    if path not in _REFERENCE:
        _REFERENCE[path] = hj.Renderer(build_cornell_box("hikari_tpu"),
                                       camera(hj, 0), path_settings(hj, path))
    r = _REFERENCE[path]
    monkeypatch.setattr(r.tracer, "kind", "brute_force_pallas",
                        raising=False)
    monkeypatch.setattr(reproj_ref, "reproj_gather", exact_gather)
    r.reset()
    return r


def port_renderer(path):
    return ht.Renderer(build_cornell_box("hikari_tpu_torch"), camera(ht, 0),
                       path_settings(ht, path), device="cpu")


def render_both(monkeypatch, path, frames=FRAMES):
    """`frames` frames of the panning camera through both renderers.
    Returns (port renderer, reference renderer, port image, reference
    image) after the last."""
    ref_r = reference_renderer(monkeypatch, path)
    port_r = port_renderer(path)
    for i in range(frames):
        ref_r.camera = camera(hj, i)
        port_r.camera = camera(ht, i)
        ref = np.asarray(ref_r.render_frame())
        got = port_r.render_frame().numpy()
    return port_r, ref_r, got, ref


def assert_history_close(port_carry, ref_carry):
    """The post chain's history against the reference's with the frame
    bar: prev_taa (the TAA output) and prev_tone (the tone image)."""
    for k in ("prev_taa", "prev_tone"):
        got = port_carry[k].numpy()
        ref = np.asarray(ref_carry[k])
        assert got.shape == ref.shape, k
        assert_frames_close(got, ref, size=ref.shape[:2])


def test_smaa_taa_frame_matches_reference(monkeypatch):
    """Path P over 4 frames: the image and the post history."""
    port_r, ref_r, got, ref = render_both(monkeypatch, "P")
    assert_frames_close(got, ref, size=SIZE)
    assert_history_close(port_r.carry, ref_r.carry)


def test_carry_from_jax_continues_the_reference(monkeypatch):
    """The port resumes hikari_tpu's path P from its carry: the view
    matrices and the post history convert bit for bit, and the next frame
    agrees with the frame bar."""
    port_r, ref_r, _, _ = render_both(monkeypatch, "P", frames=2)
    carry = jax.tree.map(np.asarray, ref_r.carry)
    resumed = port_renderer("P")
    resumed.carry = ht.frame.carry_from_jax(carry, resumed.settings, "cpu",
                                            full_size=SIZE)
    resumed._frame_index = 2
    resumed._prev_view_initialized = True
    assert set(resumed.carry) == set(port_r.carry)
    flat = {k: v for k, v in resumed.carry.items() if k != "prev_gbuffer"}
    flat.update({f"prev_gbuffer.{k}": v
                 for k, v in resumed.carry["prev_gbuffer"].items()})
    for k, v in flat.items():
        want = carry[k] if "." not in k else carry["prev_gbuffer"][k[13:]]
        np.testing.assert_array_equal(v.numpy().view(np.uint32),
                                      want.view(np.uint32), err_msg=k)
    ref_r.camera = camera(hj, 2)
    resumed.camera = camera(ht, 2)
    ref = np.asarray(ref_r.render_frame())
    assert_frames_close(resumed.render_frame().numpy(), ref, size=SIZE)


def test_post_state_resumes_bit_exactly(tmp_path):
    """Path P restored from a saved state (the nested previous G-buffer
    included) renders what the original renders next, bit for bit."""
    a = port_renderer("P")
    a.render(2)
    path = str(tmp_path / "state.pkl")
    a.save_state(path)
    b = port_renderer("P")
    b.load_state(path)
    assert set(b.carry["prev_gbuffer"]) == set(ht.frame.PREV_GBUFFER_KEYS)
    for k, v in a.carry["prev_gbuffer"].items():
        assert torch.equal(b.carry["prev_gbuffer"][k].view(torch.int32),
                           v.view(torch.int32)), k
    np.testing.assert_array_equal(b.render(2), a.render(2))


@pytest.mark.parametrize("path", ["P", "D"])
def test_update_settings_rebuilds_the_post_carry(path):
    """A static change into the path rebuilds the frame and the carry at
    the render size: reservoirs at 24x128, the tone history at 24x128, the
    TAA history and the previous G-buffer at 48x256."""
    r = ht.Renderer(build_cornell_box("hikari_tpu_torch"), camera(ht, 0),
                    flagship(ht), device="cpu")
    r.render(1)
    s = path_settings(ht, path)
    r.update_settings(**{f.name: getattr(s, f.name)
                         for f in dataclasses.fields(s)})
    assert r._frame_index == 0
    assert r.carry["prev_tone"].shape == (24, 128, 4)
    assert r.carry["prev_taa"].shape == SIZE + (4,)
    assert r.carry["prev_gbuffer"]["position"].shape == SIZE + (4,)
    if path == "D":
        assert r.carry["indirect_temporal"].shape == (24, 16, 128)
    assert np.isfinite(r.render(1)).all()
