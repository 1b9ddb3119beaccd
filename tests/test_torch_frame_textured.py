"""Path T, the textured simple scene (BASELINE config 3: examples/simple.py
with a procedural Earth on both emissive spheres, 2,510 triangles, a sun):
the port's Renderer on the CPU (the plain versions of its kernels: the
non-fused prepass over kernel 13's walk, the primary surfaces through
kernel 14's plain version, the modular lighting path with emissive and
indirect spatial reuse) against hikari_tpu's Renderer on the CPU, at the
example's HikariSettings() with emissive spatial reuse (SMAA 2.0, TAA),
48x256 output (24x128 render: whole 128-wide groups for the reference's
banded warp), four frames from the example's camera.

hikari_tpu renders the same compiled scene without its bf16 atlas layouts
(its samplers then take the exact gather; kernel 14's window is held by
tests/test_torch_texture.py), with the exact reprojection gather and the
nearest-hit walk (tests/test_torch_frame_city.py). Bars: each frame SSIM
>= 0.98 and mean abs diff < 1e-3; the carries after the last frame within
rtol 1e-2 / atol 1e-3 on >= 99% of pixels. The reference Renderer is built
once per module."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

import hikari_tpu as hj
import hikari_tpu.ops.reproj_gather as reproj_ref
import hikari_tpu.ops.trace as trace_ref
import hikari_tpu_torch as ht
from hikari_tpu_torch.examples import simple
from tests.test_torch_frame import assert_frames_close, exact_gather
from tests.test_torch_frame_city import nearest_walk
from tests.test_torch_frame_ckb_reuse import assert_planes_close
from tests.test_torch_texture import reference_arrays, textured_simple_scenes
from tests.torch_threads import one_torch_thread  # noqa: F401

SIZE = (48, 256)
FRAMES = 4


def camera(pkg):
    return pkg.Camera.from_look_at(simple.EYE, simple.TARGET, width=SIZE[1],
                                   height=SIZE[0])


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    """FRAMES frames through both renderers. Returns (port renderer,
    reference renderer, images)."""
    got, ref = textured_simple_scenes(str(tmp_path_factory.mktemp("assets")))
    ref.arrays = reference_arrays(ref)
    mp = pytest.MonkeyPatch()
    mp.setattr(reproj_ref, "reproj_gather", exact_gather)
    mp.setattr(trace_ref, "traverse_bvh", nearest_walk)
    try:
        settings = dataclasses.replace(hj.HikariSettings(),
                                       emissive_spatial_reuse=True)
        ref_r = hj.Renderer(ref, camera(hj), settings)
        assert ref_r.tracer.kind == "bvh" and not ref_r.no_texture
        port_r = ht.Renderer(got, camera(ht), simple.settings(), device="cpu")
        images = []
        for _ in range(FRAMES):
            images.append((port_r.render_frame().numpy(),
                           np.asarray(ref_r.render_frame())))
    finally:
        mp.undo()
    return port_r, ref_r, images


def test_textured_scene_takes_the_modular_branches(frames):
    """Textures keep the scene off kernels A, B, 4 and 10 (their gates),
    as in hikari_tpu; kernel 13 traces (2,510 triangles)."""
    from hikari_tpu_torch import frame

    port_r = frames[0]
    scene, kind = port_r.scene_dev, port_r.tracer.kind
    assert kind == "cull" and port_r.gpu_scene.num_textures == 1
    assert not frame.prepass_fused_eligible(scene, no_texture=False,
                                            tracer_kind=kind)
    assert not frame.spatial_fused_active(scene, port_r.settings, kind,
                                          False, 2, True, SIZE)


@pytest.mark.parametrize("f", range(FRAMES))
def test_textured_frames_match_reference(frames, f):
    got, ref = frames[2][f]
    assert float(got[..., :3].mean()) > 0.01
    assert_frames_close(got, ref, SIZE)


def test_textured_carries_match_reference(frames):
    """The three temporal reservoir planes and both spatial carries
    (hikari_tpu's packed [h,w,16] rows on its modular path) after the last
    frame."""
    port_r, ref_r, _ = frames
    for k in ht.frame.TEMPORAL_KEYS:
        assert_planes_close(port_r.carry[k], np.asarray(ref_r.carry[k]), k)
    for k in ht.frame.SPATIAL_KEYS:
        ref_sp = np.asarray(ref_r.carry[k])
        assert ref_sp.shape == (SIZE[0] // 2, SIZE[1] // 2, 16)
        assert_planes_close(port_r.carry[k], ref_sp.transpose(0, 2, 1), k)


def test_texture_changes_the_spheres(frames):
    """The same frame of the untextured scene differs on the spheres: the
    texture is sampled."""
    port_r, _, images = frames
    plain = ht.Renderer(simple.build_scene(None), camera(ht),
                        simple.settings(), device="cpu").render(FRAMES)
    textured = images[-1][0]
    diff = np.abs(textured[..., :3] - plain[..., :3]).max(-1)
    assert (diff > 0.02).sum() >= 20, (diff > 0.02).sum()
