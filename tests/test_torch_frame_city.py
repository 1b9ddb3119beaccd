"""The city (BASELINE config 5, bench.py's frame_ms_city): the port's
Renderer on the CPU (the plain versions of its kernels: the non-fused
prepass and the modular lighting path over kernel 13's plain walk, with
indirect spatial reuse) against hikari_tpu's Renderer on the CPU, whose
make_tracer picks its lockstep BVH walk there (kind "bvh"; no frame code
outside ops/trace.py branches on it), at HikariSettings() with SMAA 2.0
and an HDR camera, 48x256 output (24x128 render: whole 128-wide groups for
the reference's banded warp). Four frames with update_scene(rotate_sphere,
fast=True) between them (the reference's on the host): the images, the
reservoir carries, and the
modular path's packed [h,w,16] spatial carry through carry_from_jax.

hikari_tpu's CPU walk honours the shadow rays' early_distance (an any-hit
query: the first occluder in walk order below it), which its engine on the
chip (cull_trace) ignores, as the port does; the reference here takes the
nearest occluder too (`nearest_walk`), so an occluded sample stores the
same occluder's position.

The reference Renderer is built once per module: its frame and refit
programs take most of this file's time to compile."""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

import hikari_tpu as hj
import hikari_tpu.ops.reproj_gather as reproj_ref
import hikari_tpu.ops.trace as trace_ref
import hikari_tpu_torch as ht
from examples import city as city_ref
from hikari_tpu_torch.examples import city
from tests.test_torch_frame import assert_frames_close, exact_gather
from tests.test_torch_frame_ckb_reuse import assert_planes_close
from tests.torch_threads import one_torch_thread  # noqa: F401

SIZE = (48, 256)
FRAMES = 4
EYE, TARGET = (0.0, 2.5, 20.0), (0.0, 0.0, 0.0)


def camera(pkg):
    return pkg.Camera.from_look_at(EYE, TARGET, width=SIZE[1],
                                   height=SIZE[0], hdr=True)


def angle(f):
    """bench.py:184's sphere angle of frame f."""
    return 0.2 * (f + 1) / 60.0


def nearest_walk(scene, ro, rd, max_t, exclude_instance=None,
                 include_instance=None, early_distance=None, max_steps=None):
    """hikari_tpu's traverse_bvh without its early_distance any-hit exit
    (cull_trace's contract)."""
    return _TRAVERSE(scene, ro, rd, max_t, exclude_instance,
                     include_instance)


_TRAVERSE = trace_ref.traverse_bvh


@pytest.fixture(scope="module")
def reference():
    """hikari_tpu's city Renderer (exact gather, nearest occluders),
    unrendered."""
    mp = pytest.MonkeyPatch()
    mp.setattr(reproj_ref, "reproj_gather", exact_gather)
    mp.setattr(trace_ref, "traverse_bvh", nearest_walk)
    sc = city_ref.build_scene(3)
    r = hj.Renderer(sc, camera(hj), hj.HikariSettings())
    assert r.tracer.kind == "bvh"
    yield r, sc
    mp.undo()


@pytest.fixture(scope="module")
def frames(reference):
    """FRAMES frames through both renderers, the sphere turning between
    them. Returns (port renderer, reference renderer, images)."""
    ref_r, ref_sc = reference
    sc = city.build_scene(3)
    port_r = ht.Renderer(sc, camera(ht), ht.HikariSettings(), device="cpu")
    images = []
    for f in range(FRAMES):
        if f:
            # the reference moves the sphere on the host (its device refit
            # program would double this file's compile time; the refits
            # are held against each other in tests/test_torch_refit.py)
            ref_r.update_scene(city_ref.rotate_sphere(ref_sc, angle(f)),
                               fast=True, device=False)
            port_r.update_scene(city.rotate_sphere(sc, angle(f)), fast=True)
        ref = np.asarray(ref_r.render_frame())
        got = port_r.render_frame().numpy()
        images.append((got, ref))
    return port_r, ref_r, images


def test_city_path_takes_the_large_scene_branches(frames):
    port_r = frames[0]
    from hikari_tpu_torch import frame

    scene, kind = port_r.scene_dev, port_r.tracer.kind
    assert kind == "cull"
    assert not frame.prepass_fused_eligible(scene, no_texture=True,
                                            tracer_kind=kind)
    assert not frame.spatial_fused_active(scene, port_r.settings, kind,
                                          True, 1, True, SIZE)


@pytest.mark.parametrize("f", range(FRAMES))
def test_city_frames_match_reference(frames, f):
    got, ref = frames[2][f]
    assert float(got[..., :3].mean()) > 0.01
    assert_frames_close(got, ref, SIZE)


def test_city_carries_match_reference(frames):
    """The three temporal reservoir planes and the indirect spatial carry
    (hikari_tpu's packed [h,w,16] rows) after the last frame, each field
    within rtol 1e-2 / atol 1e-3 on >= 99% of pixels."""
    port_r, ref_r, _ = frames
    for k in ht.frame.TEMPORAL_KEYS:
        assert_planes_close(port_r.carry[k], np.asarray(ref_r.carry[k]), k)
    ref_sp = np.asarray(ref_r.carry["spatial_indirect"])
    assert ref_sp.shape == (SIZE[0] // 2, SIZE[1] // 2, 16)
    assert_planes_close(port_r.carry["spatial_indirect"],
                        ref_sp.transpose(0, 2, 1), "spatial_indirect")


def test_carry_from_jax_transposes_the_spatial_carries(frames):
    """The port resumes hikari_tpu's city from its carry: the packed
    spatial rows become [h,16,w] planes bit for bit, and the next frame
    agrees with the frame bar."""
    _, ref_r, _ = frames
    carry = jax.tree.map(np.asarray, ref_r.carry)
    resumed = ht.Renderer(city.build_scene(3), camera(ht),
                          ht.HikariSettings(), device="cpu")
    resumed.carry = ht.frame.carry_from_jax(carry, resumed.settings, "cpu",
                                            full_size=SIZE)
    resumed._frame_index = FRAMES
    resumed._prev_view_initialized = True
    for k in ht.frame.SPATIAL_KEYS:
        np.testing.assert_array_equal(
            resumed.carry[k].numpy().view(np.uint32),
            carry[k].transpose(0, 2, 1).view(np.uint32), err_msg=k)
    for k in ht.frame.TEMPORAL_KEYS:
        np.testing.assert_array_equal(
            resumed.carry[k].numpy().view(np.uint32),
            carry[k].view(np.uint32), err_msg=k)
    ref = np.asarray(ref_r.render_frame())
    assert_frames_close(resumed.render_frame().numpy(), ref, SIZE)


def test_update_scene_recompiles_a_new_wave():
    """update_scene(fast=False) recompiles: a new wave of houses brings new
    instances, a new tracer and refitter, and renders."""
    sc = city.build_scene(1)
    cam = ht.Camera.from_look_at(EYE, TARGET, width=32, height=16, hdr=True)
    r = ht.Renderer(sc, cam, ht.HikariSettings(), device="cpu")
    r.render_frame()
    r.update_scene(city.rotate_sphere(sc, 0.1), fast=True)
    tracer = r.tracer
    r.update_scene(city.build_scene(2, 0.1), fast=False)
    assert r.gpu_scene.num_instances == 82 and r.tracer is not tracer
    assert r._refitter is None
    img = r.render_frame()
    assert torch.isfinite(img).all()
