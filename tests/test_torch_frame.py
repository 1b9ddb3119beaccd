"""The port's whole frame: hikari_tpu_torch.Renderer on the CPU (the plain
versions of kernels A, B and C) against hikari_tpu.Renderer with its fused
Pallas kernels in interpret mode, at the flagship settings of bench.py."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import hikari_tpu as hj
import hikari_tpu_torch as ht
from hikari_tpu.utils.image import ssim
from tests.cornell_box import EYE, TARGET, build_cornell_box

SIZE = (48, 64)
FRAMES = 3


def flagship(pkg):
    """bench.py:96-101 (BASELINE config 2)."""
    return dataclasses.replace(
        pkg.HikariSettings(), temporal_reuse=False, denoise=True,
        indirect_bounces=1, taa=pkg.Taa.NONE, upscale=pkg.Upscale.none(),
        emissive_spatial_reuse=False, indirect_spatial_reuse=False,
        checkerboard_lighting=False)


def port_renderer(**changes):
    cam = ht.Camera.from_look_at(EYE, TARGET, width=SIZE[1], height=SIZE[0])
    return ht.Renderer(build_cornell_box("hikari_tpu_torch"), cam,
                       dataclasses.replace(flagship(ht), **changes),
                       device="cpu")


def test_frame_matches_reference(monkeypatch):
    cam = hj.Camera.from_look_at(EYE, TARGET, width=SIZE[1], height=SIZE[0])
    ref_r = hj.Renderer(build_cornell_box("hikari_tpu"), cam, flagship(hj))
    # on the CPU make_tracer yields kind 'brute_force', which fails the
    # fused gates; the stub routes the reference frame through the fused
    # Pallas kernels (interpret mode), the path the port reproduces
    monkeypatch.setattr(ref_r.tracer, "kind", "brute_force_pallas",
                        raising=False)
    ref = ref_r.render(FRAMES)
    got = port_renderer().render(FRAMES)
    assert got.shape == ref.shape == SIZE + (4,)
    assert np.isfinite(got).all()
    s = ssim(np.clip(got[..., :3], 0, 1), np.clip(ref[..., :3], 0, 1))
    assert s >= 0.98, s
    assert np.abs(got - ref).mean() < 1e-3, np.abs(got - ref).mean()


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
    with pytest.raises(NotImplementedError):
        r.update_settings(taa=ht.Taa.JASMINE)
    assert r.settings.taa == ht.Taa.NONE
    assert isinstance(r.render_frame(), torch.Tensor)
