"""The port's whole frame: hikari_tpu_torch.Renderer on the CPU (the plain
versions of its kernels) against hikari_tpu.Renderer with its fused Pallas
kernels in interpret mode, at the flagship settings of bench.py, without
reuse, with temporal reuse (path R) and with temporal + spatial reuse
(path S, the latter in test_torch_frame_spatial.py)."""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hikari_tpu as hj
import hikari_tpu.ops.reproj_gather as reproj_ref
import hikari_tpu_torch as ht
from hikari_tpu.utils.image import ssim
from tests.cornell_box import EYE, TARGET, build_cornell_box
from tests.torch_threads import one_torch_thread  # noqa: F401

SIZE = (48, 64)
FRAMES = 3


def flagship(pkg):
    """bench.py:96-101 (BASELINE config 2)."""
    return dataclasses.replace(
        pkg.HikariSettings(), temporal_reuse=False, denoise=True,
        indirect_bounces=1, taa=pkg.Taa.NONE, upscale=pkg.Upscale.none(),
        emissive_spatial_reuse=False, indirect_spatial_reuse=False,
        checkerboard_lighting=False)


REUSE_FRAMES = 4
PATHS = {
    "R": dict(temporal_reuse=True),
    "S": dict(temporal_reuse=True, emissive_spatial_reuse=True,
              indirect_spatial_reuse=True),
}
# one pixel of sideways camera motion per frame at the box's depth
PAN_PX = 2.0 * 3.2 * np.tan(np.pi / 8.0) / SIZE[0]


def port_renderer(**changes):
    cam = ht.Camera.from_look_at(EYE, TARGET, width=SIZE[1], height=SIZE[0])
    return ht.Renderer(build_cornell_box("hikari_tpu_torch"), cam,
                       dataclasses.replace(flagship(ht), **changes),
                       device="cpu")


def exact_gather(sources, piy, pix, interpret=False, mesh=None):
    """hikari_tpu's reprojection gather contract (out[y, :, x] =
    src[piy, :, pix], zeros where rejected) as a pure selection. The
    banded Pallas gather sums masked slabs, which flushes packed words
    that read as float32 denormals (a bf16 pair whose high half is 0, such
    as count with w = 0) and quiets the signalling-NaN ones (a snorm8
    normal with the sample flag set) on the CPU; the whole-frame reference
    takes the contract's side, as the port does."""
    out = []
    for s in sources:
        hs, _, w = s.shape
        ok = (piy >= 0) & (piy < hs) & (pix >= 0) & (pix < w)
        g = s[jnp.clip(piy, 0, hs - 1), :, jnp.clip(pix, 0, w - 1)]
        out.append(jnp.where(ok[..., None], g, 0.0).transpose(0, 2, 1))
    return out


_REFERENCE = {}


def reference_renderer(monkeypatch, **changes):
    """hikari_tpu's Renderer at these settings, reset; one per settings
    in this process, so a second run reuses its compiled frame."""
    key = tuple(sorted(changes.items()))
    if key not in _REFERENCE:
        cam = hj.Camera.from_look_at(EYE, TARGET, width=SIZE[1],
                                     height=SIZE[0])
        _REFERENCE[key] = hj.Renderer(
            build_cornell_box("hikari_tpu"), cam,
            dataclasses.replace(flagship(hj), **changes))
    r = _REFERENCE[key]
    # on the CPU make_tracer yields kind 'brute_force', which fails the
    # fused gates; the stub routes the reference frame through the fused
    # Pallas kernels (interpret mode), the path the port reproduces, and
    # the reset rebuilds the carry in that path's layout
    monkeypatch.setattr(r.tracer, "kind", "brute_force_pallas",
                        raising=False)
    monkeypatch.setattr(reproj_ref, "reproj_gather", exact_gather)
    r.reset()
    return r


def render_both(monkeypatch, changes, pan: bool):
    """REUSE_FRAMES frames through both renderers; the camera moves
    sideways by one pixel per frame when `pan`. Returns the last images."""
    ref_r = reference_renderer(monkeypatch, **changes)
    port_r = port_renderer(**changes)
    for i in range(REUSE_FRAMES):
        d = (PAN_PX * i if pan else 0.0, 0.0, 0.0)
        eye = tuple(a + b for a, b in zip(EYE, d))
        target = tuple(a + b for a, b in zip(TARGET, d))
        ref_r.camera = hj.Camera.from_look_at(eye, target, width=SIZE[1],
                                              height=SIZE[0])
        port_r.camera = ht.Camera.from_look_at(eye, target, width=SIZE[1],
                                               height=SIZE[0])
        ref = np.asarray(ref_r.render_frame())
        got = port_r.render_frame().numpy()
    return got, ref


def assert_frames_close(got, ref, size=SIZE):
    """SSIM >= 0.98 and mean abs diff < 1e-3 (ROADMAP's whole-frame
    bounds) of two [*size, 4] images."""
    assert got.shape == ref.shape == tuple(size) + (4,)
    assert np.isfinite(got).all()
    s = ssim(np.clip(got[..., :3], 0, 1), np.clip(ref[..., :3], 0, 1))
    assert s >= 0.98, s
    assert np.abs(got - ref).mean() < 1e-3, np.abs(got - ref).mean()


def test_frame_matches_reference(monkeypatch):
    """The no-reuse flagship over 3 frames."""
    ref = reference_renderer(monkeypatch).render(FRAMES)
    assert_frames_close(port_renderer().render(FRAMES), ref)


@pytest.mark.parametrize("pan", [False, True], ids=["static", "pan"])
def test_temporal_reuse_frame_matches_reference(monkeypatch, pan):
    """Path R over 4 frames."""
    assert_frames_close(*render_both(monkeypatch, PATHS["R"], pan))


def test_carry_from_jax_continues_the_reference(monkeypatch):
    """The port resumes hikari_tpu's path R from its carry: the carry
    converts bit for bit, and the next frame agrees (SSIM >= 0.98, mean
    abs diff < 1e-3)."""
    import jax

    ref_r = reference_renderer(monkeypatch, **PATHS["R"])
    ref_r.camera = hj.Camera.from_look_at(EYE, TARGET, width=SIZE[1],
                                          height=SIZE[0])
    ref_r.render(2)
    carry = jax.tree.map(np.asarray, ref_r.carry)
    port_r = port_renderer(**PATHS["R"])
    port_r.carry = ht.frame.carry_from_jax(carry, port_r.settings, "cpu")
    port_r._frame_index = 2
    port_r._prev_view_initialized = True
    assert set(port_r.carry) == {"prev_view_proj", "prev_inverse_view_proj",
                                 *ht.frame.TEMPORAL_KEYS}
    for k, v in port_r.carry.items():
        np.testing.assert_array_equal(v.numpy().view(np.uint32),
                                      carry[k].view(np.uint32), err_msg=k)
    ref = np.asarray(ref_r.render_frame())
    assert_frames_close(port_r.render_frame().numpy(), ref)


def test_temporal_reuse_resumes_bit_exactly(tmp_path):
    """Path R restored from a saved state (reservoir planes included)
    renders what the original renders next, bit for bit."""
    a = port_renderer(**PATHS["R"])
    a.render(2)
    path = str(tmp_path / "state.pkl")
    a.save_state(path)
    b = port_renderer(**PATHS["R"])
    b.load_state(path)
    for k, v in a.carry.items():
        assert torch.equal(b.carry[k].view(torch.int32),
                           v.view(torch.int32)), k
    np.testing.assert_array_equal(b.render(2), a.render(2))


def test_save_load_state_resumes_the_sequence(tmp_path):
    """A renderer restored from a saved state renders the frame the
    original renders next (the frame number drives the noise)."""
    a = port_renderer()
    a.render(2)
    path = str(tmp_path / "state.pkl")
    a.save_state(path)
    b = port_renderer()
    b.load_state(path)
    assert b._frame_index == 2
    np.testing.assert_array_equal(b.render(1), a.render(1))


def test_reset_restarts_the_sequence():
    r = port_renderer()
    first = r.render(1)
    r.render(1)
    r.reset()
    np.testing.assert_array_equal(r.render(1), first)


def test_update_settings():
    r = port_renderer(denoise=False)
    raw = r.render(1)
    r.update_settings(max_indirect_luminance=5.0)   # dynamic: no rebuild
    assert r._frame_index == 1
    r.update_settings(denoise=True)                 # static: rebuild+reset
    assert r._frame_index == 0
    assert not np.array_equal(r.render(1), raw)
    # into temporal and spatial reuse with the tap scramble: a new frame
    # function (the modular path) and carry
    r.update_settings(temporal_reuse=True, indirect_spatial_reuse=True,
                      spatial_tap_scramble=True)
    assert r._frame_index == 0 and r.settings.spatial_tap_scramble
    assert set(ht.frame.TEMPORAL_KEYS + ht.frame.SPATIAL_KEYS) <= set(r.carry)
    assert torch.isfinite(r.render_frame()).all()
    r.update_settings(temporal_reuse=False, indirect_spatial_reuse=False,
                      spatial_tap_scramble=False)
    assert r.settings.upscale == ht.Upscale.none()
    assert isinstance(r.render_frame(), torch.Tensor)
    # into FSR at ratio 2: a new frame and carry (TAA off: no history)
    r.render_frame()
    r.update_settings(upscale=ht.Upscale.fsr1(2.0))
    assert r._frame_index == 0 and set(r.carry) == {
        "prev_view_proj", "prev_inverse_view_proj"}
    img = r.render(2)
    assert img.shape == SIZE + (4,) and np.isfinite(img).all()
