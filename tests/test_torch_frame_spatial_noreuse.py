"""HikariSettings() on the box with temporal reuse off (indirect spatial
reuse alone; the tap scramble's case, on the same helpers, is
tests/test_torch_frame_scramble.py): hikari_tpu_torch.Renderer
on the CPU (the plain versions of its kernels) against hikari_tpu.Renderer,
three frames at 48x256 output (24x128 render: whole 128-wide groups for
hikari_tpu's banded warps), static camera. Both take the modular lighting
path (kernel 10 needs temporal reuse and no scramble), whose rays go
through kernels 5, 6 and 7 (hikari_tpu: its Pallas engine in interpret
mode, tests/test_torch_modular.py PallasTracer), with the exact
reprojection gather (tests/test_torch_frame.py exact_gather).

Bars: each frame SSIM >= 0.98 and mean abs diff < 1e-3; the indirect
spatial carry (hikari_tpu's packed [h,w,16] rows) after the last frame,
each field within rtol 1e-2 / atol 1e-3 on >= 99% of pixels."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import hikari_tpu as hj
import hikari_tpu.ops.reproj_gather as reproj_ref
import hikari_tpu.renderer as renderer_ref
import hikari_tpu_torch as ht
from tests.cornell_box import EYE, TARGET, build_cornell_box
from tests.test_torch_frame import assert_frames_close, exact_gather
from tests.test_torch_frame_ckb_reuse import assert_planes_close
from tests.test_torch_modular import PallasTracer
from tests.torch_threads import one_torch_thread  # noqa: F401

SIZE = (48, 256)
FRAMES = 3


def camera(pkg):
    return pkg.Camera.from_look_at(EYE, TARGET, width=SIZE[1],
                                   height=SIZE[0])


def render_both(**changes):
    """FRAMES frames of HikariSettings() with `changes` through both
    renderers. Returns (port renderer, reference renderer, images)."""
    mp = pytest.MonkeyPatch()
    mp.setattr(renderer_ref, "make_tracer", lambda n, **kw: PallasTracer())
    mp.setattr(reproj_ref, "reproj_gather", exact_gather)
    try:
        ref_r = hj.Renderer(build_cornell_box("hikari_tpu"), camera(hj),
                            dataclasses.replace(hj.HikariSettings(),
                                                **changes))
        port_r = ht.Renderer(build_cornell_box("hikari_tpu_torch"),
                             camera(ht), dataclasses.replace(
                                 ht.HikariSettings(), **changes),
                             device="cpu")
        images = [(port_r.render_frame().numpy(),
                   np.asarray(ref_r.render_frame())) for _ in range(FRAMES)]
    finally:
        mp.undo()
    return port_r, ref_r, images


@pytest.fixture(scope="module")
def frames():
    return render_both(temporal_reuse=False)


def check_modular_spatial(frames):
    """Kernel 10 does not serve the frame; the carry holds the spatial
    reservoirs, and the temporal ones only with temporal reuse."""
    from hikari_tpu_torch import frame

    port_r = frames[0]
    s = port_r.settings
    assert not frame.spatial_fused_active(
        port_r.scene_dev, s, port_r.tracer.kind, True, 1, False, SIZE)
    keys = set(port_r.carry) & set(frame.TEMPORAL_KEYS + frame.SPATIAL_KEYS)
    assert keys == set(frame.SPATIAL_KEYS) | (
        set(frame.TEMPORAL_KEYS) if s.temporal_reuse else set())


def check_frame(frames, f):
    got, ref = frames[2][f]
    assert float(got[..., :3].mean()) > 0.01
    assert_frames_close(got, ref, SIZE)


def check_spatial_carry(frames):
    port_r, ref_r, _ = frames
    ref_sp = np.asarray(ref_r.carry["spatial_indirect"])
    assert ref_sp.shape == (SIZE[0] // 2, SIZE[1] // 2, 16)
    assert_planes_close(port_r.carry["spatial_indirect"],
                        ref_sp.transpose(0, 2, 1), "spatial_indirect")
    assert (port_r.carry["spatial_indirect"].view(torch.int32) != 0).any()


def test_spatial_pass_is_modular(frames):
    check_modular_spatial(frames)


@pytest.mark.parametrize("f", range(FRAMES))
def test_spatial_frames_match_reference(frames, f):
    check_frame(frames, f)


def test_spatial_carry_matches_reference(frames):
    check_spatial_carry(frames)
