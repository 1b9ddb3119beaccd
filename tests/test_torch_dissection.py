"""Renderer.render_dissection (build_render_frame(debug=True)) on the box
at path D's settings (the literal HikariSettings(): temporal and indirect
spatial reuse, TAA, SMAA TU4X 2.0) against hikari_tpu's, whose fused
kernels run in interpret mode and whose gather is exact (as
tests/test_torch_frame_post.py sets it up). 48x256 output, lighting at
24x128: hikari_tpu's banded kernels are exact only on whole 128-wide
groups (ROADMAP, reference item 7).

Bars, per plane of the first frame's dissection:
* the G-buffer planes and the albedo within 1e-5 * max(|ref|, 1) on
  >= 99.9% of values: a few knife-edge pixels take another triangle where
  kernel A's words differ in the last bits (ROADMAP, port fault 1);
* the raw channel renders within 1e-4 * max(|ref|, 1) and the variances
  within 1e-3 * max(|ref|, 1), each on >= 99.9% of values (f32
  round-off; a variance is a difference of squares);
* the denoised channels, the tone-mapped image and `final` with the frame
  bar (SSIM >= 0.98 and mean abs diff < 1e-3) at the plane's own scale
  (divided by max(max |ref|, 1): the channels are HDR): kernel C works on
  bf16 planes, so a last-bit difference of its inputs can move a value by
  a bf16 step.

The carry after the dissection: the reservoir planes within
tests/test_torch_light_temporal.py's bar and the post history with the
frame bar, against hikari_tpu's carry after its dissection (whose fused
spatial carries its dissection transposes back to [h,16,w]); the port's
next frame from its own carry against its next frame from hikari_tpu's
carry (carry_from_jax) with the frame bar. Also: the dissection never
runs the fused lighting or spatial kernels, it writes hikari_tpu's PNG
names, a settings change and a recompiled scene drop its frame
function, and to_srgb_u8 equals
hikari_tpu's bit for bit.
"""

from __future__ import annotations

import os

import jax
import numpy as np
import pytest
import torch

import hikari_tpu as hj
import hikari_tpu.ops.reproj_gather as reproj_ref
import hikari_tpu_torch as ht
from hikari_tpu_torch import frame as frame_port
from hikari_tpu_torch.ops import light_fused, spatial_fused
from tests.cornell_box import EYE, TARGET, build_cornell_box
from tests.test_torch_frame import assert_frames_close, exact_gather
from tests.test_torch_light_temporal import _assert_planes_close
from tests.torch_threads import one_torch_thread  # noqa: F401

SIZE = (48, 256)
GBUFFER = ("gbuffer_position", "gbuffer_normal", "gbuffer_depth_gradient",
           "gbuffer_velocity_uv", "albedo")
RAW = ("direct_raw", "emissive_raw", "indirect_raw")
VARIANCES = ("direct_variance", "emissive_variance", "indirect_variance")
FRAME_BAR = ("direct_denoised", "emissive_denoised", "indirect_denoised",
             "tone_mapping", "final")
RESERVOIRS = ("emissive_temporal", "indirect_temporal", "spatial_indirect")


def camera(pkg):
    return pkg.Camera.from_look_at(EYE, TARGET, width=SIZE[1],
                                   height=SIZE[0])


def port_renderer():
    return ht.Renderer(build_cornell_box("hikari_tpu_torch"), camera(ht),
                       ht.HikariSettings(), device="cpu")


@pytest.fixture(scope="module")
def dissections():
    """The first frame's dissection through both renderers: (port
    renderer, its planes, hikari_tpu's carry after its dissection as
    numpy, hikari_tpu's planes)."""
    mp = pytest.MonkeyPatch()
    mp.setattr(reproj_ref, "reproj_gather", exact_gather)
    ref_r = hj.Renderer(build_cornell_box("hikari_tpu"), camera(hj),
                        hj.HikariSettings())
    # the fused kernels' gates (interpret mode on the CPU), as
    # tests/test_torch_frame_post.py sets them
    mp.setattr(ref_r.tracer, "kind", "brute_force_pallas", raising=False)
    ref_r.reset()
    ref = ref_r.render_dissection()
    ref_carry = jax.tree.map(np.asarray, ref_r.carry)
    mp.undo()
    port_r = port_renderer()
    mp.setattr(light_fused, "fused_lighting", _refuse)
    mp.setattr(spatial_fused, "spatial_fused", _refuse)
    got = port_r.render_dissection()
    mp.undo()
    return port_r, got, ref_carry, {k: np.asarray(v) for k, v in ref.items()}


def _refuse(*a, **k):
    raise AssertionError("the dissection ran a fused lighting kernel")


def _within(got, ref, rtol, share=0.999):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    assert np.isfinite(got).all()
    ok = np.abs(got - ref) <= rtol * np.maximum(np.abs(ref), 1.0)
    return ok.mean() >= share, ok.mean()


def test_dissection_keys_and_shapes(dissections):
    _, got, _, ref = dissections
    assert list(got) == list(frame_port.DEBUG_KEYS) + ["final"]
    assert set(got) == set(ref)
    for k in got:
        assert got[k].shape == ref[k].shape and got[k].dtype == np.float32, k


@pytest.mark.parametrize("key", GBUFFER + RAW + VARIANCES)
def test_dissection_planes_match_reference(dissections, key):
    _, got, _, ref = dissections
    rtol = 1e-5 if key in GBUFFER else 1e-4 if key in RAW else 1e-3
    ok, share = _within(got[key], ref[key], rtol)
    assert ok, (key, share)


@pytest.mark.parametrize("key", FRAME_BAR)
def test_dissection_images_match_reference(dissections, key):
    _, got, _, ref = dissections
    g, r = got[key], ref[key]
    scale = max(float(np.abs(r).max()), 1.0)
    assert_frames_close(g / scale, r / scale, size=r.shape[:2])
    if key == "final":
        assert float(g[..., :3].mean()) > 0.01


def test_carry_after_dissection_matches_reference(dissections):
    """The carry keeps the layout render_frame expects ([h,16,w] planes)
    and the reference's values; the next frame from it agrees with the
    port's next frame from hikari_tpu's carry."""
    port_r, _, ref_carry, _ = dissections
    fresh = frame_port.init_carry(SIZE, port_r.settings, "cpu")
    assert set(port_r.carry) == set(fresh)
    for k, v in fresh.items():
        if isinstance(v, torch.Tensor):
            assert port_r.carry[k].shape == v.shape, k
    assert port_r._frame_index == 1 and port_r._prev_view_initialized
    for k in RESERVOIRS:
        assert ref_carry[k].shape == (SIZE[0] // 2, 16, SIZE[1] // 2), k
        _assert_planes_close(k, port_r.carry[k].numpy(), ref_carry[k])
    for k in ("prev_taa", "prev_tone"):
        assert_frames_close(port_r.carry[k].numpy(), ref_carry[k],
                            size=ref_carry[k].shape[:2])
    resumed = port_renderer()
    resumed.carry = ht.frame.carry_from_jax(ref_carry, resumed.settings,
                                            "cpu", full_size=SIZE)
    resumed._frame_index = 1
    resumed._prev_view_initialized = True
    want = resumed.render_frame().numpy()
    own = port_renderer()
    own.render_dissection()
    got = own.render_frame().numpy()
    assert own._frame_index == 2
    assert float(got[..., :3].mean()) > 0.01
    assert_frames_close(got, want, size=SIZE)


def test_dissection_writes_reference_pngs(tmp_path):
    """hikari_tpu's file names (one per key, `final` included), 8-bit RGB
    images of the planes' sizes; a settings change and update_scene(fast=
    False) drop the dissection's frame function."""
    from PIL import Image

    r = ht.Renderer(build_cornell_box("hikari_tpu_torch"),
                    ht.Camera.from_look_at(EYE, TARGET, width=64, height=48),
                    ht.HikariSettings(), device="cpu")
    out = str(tmp_path / "passes")
    got = r.render_dissection(out)
    assert sorted(os.listdir(out)) == sorted(f"{k}.png" for k in got)
    for k, v in got.items():
        img = Image.open(os.path.join(out, f"{k}.png"))
        assert img.size == (v.shape[1], v.shape[0]), k
    assert r._debug_fn is not None
    r.update_settings(denoise=False)
    assert r._debug_fn is None
    assert "direct_denoised" in r.render_dissection()
    r.update_scene(build_cornell_box("hikari_tpu_torch"))
    assert r._debug_fn is None
    assert "final" in r.render_dissection()


def test_to_srgb_u8_matches_reference():
    g = np.random.default_rng(4)
    img = g.uniform(-0.5, 1.5, (16, 24, 4)).astype(np.float32)
    img[0, :4, 0] = (0.0031308, 0.0031309, 0.0, 1.0)
    got = ht.Renderer.to_srgb_u8(img)
    ref = hj.Renderer.to_srgb_u8(img)
    assert got.dtype == ref.dtype == np.uint8
    np.testing.assert_array_equal(got, ref)


def test_save_png_writes_the_frame(tmp_path):
    from PIL import Image

    r = ht.Renderer(build_cornell_box("hikari_tpu_torch"),
                    ht.Camera.from_look_at(EYE, TARGET, width=32, height=24),
                    device="cpu")
    path = str(tmp_path / "frame.png")
    r.save_png(path)
    assert r._frame_index == 1
    img = np.asarray(Image.open(path))
    assert img.shape == (24, 32, 3)
    img2 = r.render_frame()
    r.save_png(path, img2)
    np.testing.assert_array_equal(np.asarray(Image.open(path)),
                                  ht.Renderer.to_srgb_u8(img2.numpy()))
