"""The host refit (models/bvh.py refit_bvh, models/scene.py
GpuScene.update_transforms) against hikari_tpu's: every array hikari_tpu
writes equal bit for bit (its cluster tables and bf16 atlas layouts aside,
which the port replaces), the emissive BVH and its leaf order included;
kernel 13's tables recomputed from the plan made once equal to
walk_tables.scene_tables of the same arrays; and a frame after the host
refit against one after the device refit on a scene of at most 8
emissives (hikari_tpu's tests/test_refit_device.py:110-125)."""

from __future__ import annotations

import dataclasses
import importlib

import numpy as np
import pytest

import hikari_tpu_torch as ht
from hikari_tpu.models import bvh as ref_bvh
from hikari_tpu_torch.models import bvh, walk_tables
from tests.city_lamps import (FIRST_LAMP, LAMPS, build_city_lamps,
                              city_module, lamp_transforms)
from tests.torch_threads import one_torch_thread  # noqa: F401


def _modules(package):
    return (importlib.import_module(f"{package}.models.scene"),
            importlib.import_module(f"{package}.models.mesh"),
            importlib.import_module(f"{package}.models.material"))


def moving_scene(package, t):
    """tests/test_dynamic_scene.py's moving_scene in either package: a
    cube at x = t (its previous transform 0.1 behind) over a plane."""
    scene_mod, shapes, material = _modules(package)
    T, Mat = scene_mod.make_transform, material.StandardMaterial
    sc = scene_mod.Scene()
    cube = sc.add_mesh(shapes.cube(1.0))
    plane = sc.add_mesh(shapes.plane(8.0))
    m0 = sc.add_material(Mat.from_color(0.8, 0.2, 0.2))
    m1 = sc.add_material(Mat.from_color(0.3, 0.5, 0.3))
    sc.spawn(cube, m0, T((t, 0.5, 0.0)),
             prev_transform=T((t - 0.1, 0.5, 0.0)))
    sc.spawn(plane, m1)
    return sc


def spinning_scene(package, t, spin):
    """hikari_tpu's tests/test_refit_device.py build(t, spin) in either
    package: a spinning cube, a plane and one emissive sphere (so at most
    8 emissives: the device refit serves it)."""
    scene_mod, shapes, material = _modules(package)
    T, Mat = scene_mod.make_transform, material.StandardMaterial
    sc = scene_mod.Scene()
    cube = sc.add_mesh(shapes.cube(1.0))
    plane = sc.add_mesh(shapes.plane(8.0))
    sphere = sc.add_mesh(shapes.uv_sphere(0.4, 12, 8))
    m0 = sc.add_material(Mat.from_color(0.8, 0.2, 0.2))
    m1 = sc.add_material(Mat.from_color(0.3, 0.5, 0.3))
    me = sc.add_material(Mat(emissive=(4.0, 3.0, 2.0, 1.0)))
    c, s = np.cos(spin), np.sin(spin)
    rot = np.array([[c, 0, s, t], [0, 1, 0, 0.5], [-s, 0, c, 0],
                    [0, 0, 0, 1]], np.float32)
    sc.spawn(cube, m0, rot, prev_transform=T((t - 0.1, 0.5, 0.0)))
    sc.spawn(plane, m1)
    sc.spawn(sphere, me, T((0.0, 1.5 + t, 0.0)),
             prev_transform=T((0.0, 1.5 + t - 0.05, 0.0)))
    return sc


def lamp_city_moved(package, step):
    """The lamp city after `step` frames: the sphere turned, and lamps 0
    and 1 (at x = -14 and -10 on the z = -4 street) moved 3 m a step
    towards and then past each other."""
    sc = build_city_lamps(package)
    city = city_module(package)
    city.rotate_sphere(sc, 0.4 * step)
    for lamp, direction in ((0, 1.0), (1, -1.0)):
        x, z = LAMPS[lamp]
        pole, head = lamp_transforms(package, x + 3.0 * step * direction, z)
        first = FIRST_LAMP + 2 * lamp
        for inst, m in zip(sc.instances[first:first + 2], (pole, head)):
            inst.prev_transform = inst.transform
            inst.transform = m
    return sc


def reference_keys(ref_arrays):
    """The arrays hikari_tpu writes that the port keeps (its cluster
    tables and bf16 atlas layouts are replaced in the port)."""
    return [k for k in ref_arrays
            if not k.startswith(("cl_", "atlas_panels", "atlas_quad"))]


def assert_arrays_equal(port, ref):
    keys = reference_keys(ref)
    assert set(keys) <= set(port)
    for k in keys:
        a, b = np.asarray(port[k]), np.asarray(ref[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8),
                                      err_msg=k)


@pytest.mark.parametrize("method", ["auto", "lbvh"])
def test_refit_bvh_matches_reference(method):
    """refit_bvh on a BVH of 300 seeded boxes, refit to moved boxes: the
    node boxes bit for bit, the topology kept."""
    rng = np.random.default_rng(5)
    lo = rng.uniform(-10, 10, (300, 3))
    hi = lo + rng.uniform(0.01, 2.0, (300, 3))
    move = rng.normal(0.0, 0.5, (300, 3))
    got = bvh.refit_bvh(bvh.build_bvh(lo, hi, method), lo + move, hi + move)
    want = ref_bvh.refit_bvh(ref_bvh.build_bvh(lo, hi, method), lo + move,
                             hi + move)
    for f in ("node_min", "node_max", "entry", "exit", "first", "last",
              "prim_order"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)


def _refit_both(scene_of, steps):
    """(port GpuScene, hikari_tpu GpuScene) after compiling scene_of(pkg,
    0) and refitting to scene_of(pkg, k) for k in steps."""
    out = []
    for package in ("hikari_tpu_torch", "hikari_tpu"):
        gpu = scene_of(package, 0).compile()
        for k in steps:
            gpu = gpu.update_transforms(scene_of(package, k))
        out.append(gpu)
    return out


@pytest.mark.parametrize("scene_of,steps", [
    pytest.param(lambda p, k: moving_scene(p, 0.5 * k), (1,),
                 id="moving_scene"),
    pytest.param(lamp_city_moved, (1, 2), id="lamp_city"),
])
def test_update_transforms_matches_reference(scene_of, steps):
    port, ref = _refit_both(scene_of, steps)
    assert_arrays_equal(port.arrays, ref.arrays)
    # kernel 13's tables from the plan made once, as if derived afresh
    want = walk_tables.scene_tables(port.arrays)
    assert set(port.tables) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(port.tables[k].view(np.int32),
                                      v.view(np.int32), err_msg=k)


def test_lamp_city_refit_moves_the_lamps_across_each_other():
    """After the two refits lamps 0 and 1 have traded sides: the emissive
    BVH rebuilt from the moved emitters, its leaves in a new order, on
    both sides alike."""
    compiled = build_city_lamps("hikari_tpu_torch").compile()
    port, ref = _refit_both(lamp_city_moved, (1, 2))
    em = port.arrays["em_position"]
    heads = [list(port.arrays["em_instance"]).index(FIRST_LAMP + 2 * i + 1)
             for i in (0, 1)]
    assert em[heads[0], 0] > em[heads[1], 0]
    np.testing.assert_array_equal(port.arrays["em_leaf_order"],
                                  ref.arrays["em_leaf_order"])
    assert not np.array_equal(port.arrays["em_leaf_order"],
                              compiled.arrays["em_leaf_order"])


def test_refit_keeps_the_walk_plan():
    """The plan of kernel 13's tables is made once for the topology and
    carried through every refit."""
    gpu = build_city_lamps("hikari_tpu_torch").compile()
    plan = gpu.plan()
    for step in (1, 2):
        gpu = gpu.update_transforms(lamp_city_moved("hikari_tpu_torch",
                                                    step))
        assert gpu.walk_plan is plan


def test_renderer_host_refit_matches_device_refit_image():
    """A frame after update_scene(fast=True, device=False) against one
    after the device refit, on a scene of one emissive (hikari_tpu's
    test_renderer_device_refit_matches_host_refit_image): the same
    geometry, so images within 5e-2 at every value."""
    settings = dataclasses.replace(
        ht.HikariSettings(), denoise=False, taa=ht.Taa.NONE,
        upscale=ht.Upscale.none(), temporal_reuse=False,
        emissive_spatial_reuse=False, indirect_spatial_reuse=False)
    cam = ht.Camera.from_look_at((-2, 2.5, 5), (0, 0, 0), width=64,
                                 height=40)
    images = {}
    for device in (False, True):
        r = ht.Renderer(spinning_scene("hikari_tpu_torch", 0.0, 0.0), cam,
                        settings, device="cpu")
        r.render_frame()
        r.update_scene(spinning_scene("hikari_tpu_torch", 0.6, 0.4),
                       fast=True, device=device)
        images[device] = r.render_frame().numpy()
        assert (r._refitter is None) != device
    a, b = images[False], images[True]
    assert np.isfinite(a).all() and np.isfinite(b).all()
    assert np.abs(a - b).max() < 5e-2, np.abs(a - b).max()


def test_host_refit_uploads_only_what_moved(monkeypatch):
    """The Renderer's host refit uploads only the arrays the refit
    replaced and kernel 13's tables, and writes them into the scene's
    device tensors in place (a captured frame keeps reading them): every
    device tensor stays the same object, the moved ones holding the
    refit's arrays."""
    from hikari_tpu_torch import renderer as renderer_mod

    sc = build_city_lamps("hikari_tpu_torch")
    cam = ht.Camera.from_look_at((0, 2.5, 20), (0, 0, 0), width=16,
                                 height=12, hdr=True)
    r = ht.Renderer(sc, cam, ht.HikariSettings(), device="cpu")
    before = dict(r.scene_dev)
    uploaded, real_upload = set(), renderer_mod.upload

    def spy(arrays, device):
        uploaded.update(arrays)
        return real_upload(arrays, device)

    monkeypatch.setattr(renderer_mod, "upload", spy)
    r.update_scene(city_module("hikari_tpu_torch").rotate_sphere(sc, 0.1),
                   fast=True)
    assert all(r.scene_dev[k] is before[k] for k in before)
    for k in ("atlas", "mat_packed", "alias_packed", "tri_uv"):
        assert k not in uploaded
    for k in ("tri_pos_flat", "bvh_packed", "em_bvh_packed", "em_packed",
              *walk_tables.TABLE_KEYS):
        assert k in uploaded
        np.testing.assert_array_equal(
            r.scene_dev[k].numpy(),
            {**r.gpu_scene.arrays, **r.gpu_scene.tables}[k], err_msg=k)
