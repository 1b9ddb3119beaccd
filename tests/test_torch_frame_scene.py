"""Path F, the scene of examples/scene.py (BASELINE config 4): the port's
Renderer on the CPU (the plain versions of its kernels: the non-fused
prepass over kernel 13's plain walk, the modular lighting path with 4
bounces and indirect spatial reuse at the 32x128 render size, TAA at the
render size, then FSR 1.0 to 64x256) against hikari_tpu's Renderer on the
CPU at the example's settings and camera, whose make_tracer picks its
lockstep BVH walk there (kind "bvh"). Both build the example's scene
without its FlightHelmet glTF (examples.scene.ASSETS points to an empty
directory), 1,226 triangles.

As in tests/test_torch_frame_city.py, the reference gathers exactly and
its shadow rays take the nearest occluder (`nearest_walk`), the contract
of the port and of hikari_tpu's engine on the chip. Four frames of the
static camera: each image (SSIM >= 0.98, mean abs diff < 1e-3), the
reservoir carries (each unpacked field within rtol 1e-2 / atol 1e-3 on
>= 99% of pixels), the TAA history (the frame bar), and the port resuming
from the reference's carry through carry_from_jax, bit for bit.

The reference Renderer is built once per module: its frame program takes
most of this file's time to compile. The resumed port renders the last
frame again from the reference's carry before it, so the reference renders
no frame beyond the four."""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest

import hikari_tpu as hj
import hikari_tpu.ops.reproj_gather as reproj_ref
import hikari_tpu.ops.trace as trace_ref
import hikari_tpu_torch as ht
from examples import scene as scene_ref
from hikari_tpu_torch.examples import scene
from tests.test_torch_frame import assert_frames_close, exact_gather
from tests.test_torch_frame_ckb_reuse import assert_planes_close
from tests.test_torch_frame_city import nearest_walk
from tests.torch_threads import one_torch_thread  # noqa: F401

SIZE = (64, 256)
RENDER = (32, 128)
FRAMES = 4


def camera(pkg):
    return pkg.Camera.from_look_at(scene.EYE, scene.TARGET, width=SIZE[1],
                                   height=SIZE[0])


def ref_settings():
    """examples/scene.py:50-51."""
    return dataclasses.replace(hj.HikariSettings(), indirect_bounces=4,
                               upscale=hj.Upscale.fsr1(2.0))


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    """FRAMES frames through both renderers. Returns (port renderer,
    reference renderer, [(port image, reference image)], the reference's
    carry before its last frame, on the host)."""
    mp = pytest.MonkeyPatch()
    mp.setattr(scene_ref, "ASSETS", str(tmp_path_factory.mktemp("assets")))
    mp.setattr(reproj_ref, "reproj_gather", exact_gather)
    mp.setattr(trace_ref, "traverse_bvh", nearest_walk)
    ref_r = hj.Renderer(scene_ref.build_scene(), camera(hj), ref_settings())
    port_r = ht.Renderer(scene.build_scene(), camera(ht), scene.settings(),
                         device="cpu")
    images = []
    for _ in range(FRAMES):
        # a copy: the frame program donates the carry's buffers
        before_last = jax.tree.map(np.array, ref_r.carry)
        ref = np.asarray(ref_r.render_frame())
        got = port_r.render_frame().numpy()
        images.append((got, ref))
    yield port_r, ref_r, images, before_last
    mp.undo()


def test_scene_is_the_example_without_its_model(frames):
    """The same 1,226 triangles, the tracers and branches of a scene above
    the fused kernels' caps."""
    port_r, ref_r = frames[:2]
    from hikari_tpu_torch import frame

    assert port_r.gpu_scene.num_triangles == ref_r.gpu_scene.num_triangles
    assert port_r.gpu_scene.num_triangles == 1226
    assert (port_r.tracer.kind, ref_r.tracer.kind) == ("cull", "bvh")
    assert port_r.settings.upscale == ht.Upscale.fsr1(2.0)
    assert port_r.settings.indirect_bounces == 4
    scene_dev, kind = port_r.scene_dev, port_r.tracer.kind
    assert not frame.prepass_fused_eligible(scene_dev, no_texture=True,
                                            tracer_kind=kind)


@pytest.mark.parametrize("f", range(FRAMES))
def test_scene_frames_match_reference(frames, f):
    got, ref = frames[2][f]
    assert float(got[..., :3].mean()) > 0.01
    assert_frames_close(got, ref, SIZE)


def test_scene_carries_match_reference(frames):
    """The temporal reservoir planes, the indirect spatial carry
    (hikari_tpu's packed [h,w,16] rows on its modular path) and the TAA
    history at the render size, after the last frame."""
    port_r, ref_r = frames[:2]
    for k in ht.frame.TEMPORAL_KEYS:
        assert port_r.carry[k].shape == (RENDER[0], 16, RENDER[1])
        assert_planes_close(port_r.carry[k], np.asarray(ref_r.carry[k]), k)
    ref_sp = np.asarray(ref_r.carry["spatial_indirect"])
    assert ref_sp.shape == RENDER + (16,)
    assert_planes_close(port_r.carry["spatial_indirect"],
                        ref_sp.transpose(0, 2, 1), "spatial_indirect")
    taa = port_r.carry["prev_taa"].numpy()
    assert taa.shape == RENDER + (4,)
    assert_frames_close(taa, np.asarray(ref_r.carry["prev_taa"]), RENDER)
    assert "prev_tone" not in port_r.carry


def test_carry_from_jax_continues_the_reference(frames):
    """The port resumes hikari_tpu's path F from its carry before the last
    frame (the spatial rows transposed, the TAA history at the render
    size, prev_upscale left out) bit for bit, and renders that frame in
    agreement with the reference's (the frame bar)."""
    carry = frames[3]
    resumed = ht.Renderer(scene.build_scene(), camera(ht), scene.settings(),
                          device="cpu")
    resumed.carry = ht.frame.carry_from_jax(carry, resumed.settings, "cpu",
                                            full_size=SIZE)
    resumed._frame_index = FRAMES - 1
    resumed._prev_view_initialized = True
    assert "prev_upscale" not in resumed.carry
    for k in ht.frame.SPATIAL_KEYS:
        np.testing.assert_array_equal(
            resumed.carry[k].numpy().view(np.uint32),
            carry[k].transpose(0, 2, 1).view(np.uint32), err_msg=k)
    for k in ht.frame.TEMPORAL_KEYS + ("prev_taa",):
        np.testing.assert_array_equal(
            resumed.carry[k].numpy().view(np.uint32),
            carry[k].view(np.uint32), err_msg=k)
    for k, v in resumed.carry["prev_gbuffer"].items():
        np.testing.assert_array_equal(
            v.numpy().view(np.uint32),
            carry["prev_gbuffer"][k].view(np.uint32), err_msg=k)
    assert_frames_close(resumed.render_frame().numpy(), frames[2][-1][1],
                        SIZE)
