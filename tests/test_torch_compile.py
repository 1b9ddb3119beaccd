"""The port's scene compiler (hikari_tpu_torch.models) against
hikari_tpu's: every array it emits equals GpuScene.arrays[k]."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from examples.minimal import build_scene as minimal_reference
from hikari_tpu_torch.models import mesh as shapes
from hikari_tpu_torch.models.material import StandardMaterial
from hikari_tpu_torch.models.scene import (DirectionalLight, Scene,
                                           make_transform)
from tests.cornell_box import build_cornell_box
from tests.test_trace import emissive_scene as emissive_reference
from tests.torch_threads import one_torch_thread  # noqa: F401


def emissive_scene():
    """tests/test_trace.py:emissive_scene, built with the port."""
    sc = Scene()
    cube_id = sc.add_mesh(shapes.cube(1.0))
    plane_id = sc.add_mesh(shapes.plane(8.0))
    quad_id = sc.add_mesh(shapes.quad(1.0, 1.0))
    m0 = sc.add_material(StandardMaterial.from_color(0.8, 0.7, 0.6))
    m1 = sc.add_material(StandardMaterial.from_color(0.3, 0.5, 0.3))
    me = sc.add_material(StandardMaterial(emissive=(1.0, 0.8, 0.5, 1.0)))
    sc.spawn(cube_id, m0, make_transform((0, 0.5, 0)))
    sc.spawn(plane_id, m1, make_transform((0, 0, 0)))
    sc.spawn(quad_id, me, make_transform((0, 2.5, 0)))
    return sc


def minimal_scene():
    """examples/minimal.py:build_scene, built with the port."""
    sc = Scene()
    plane = sc.add_mesh(shapes.plane(5.0))
    cube = sc.add_mesh(shapes.cube(1.0))
    green = sc.add_material(StandardMaterial.from_color(0.3, 0.5, 0.3))
    tan = sc.add_material(StandardMaterial.from_color(0.8, 0.7, 0.6))
    sc.spawn(plane, green)
    sc.spawn(cube, tan, make_transform((0.0, 0.5, 0.0)))
    sc.directional_light = DirectionalLight.from_euler(
        -np.pi / 4, np.pi / 4, 0.0, illuminance=10000.0)
    return sc


SCENES = {
    "emissive": (emissive_reference, emissive_scene),
    "minimal": (minimal_reference, minimal_scene),
    "cornell_box": (lambda: build_cornell_box("hikari_tpu"),
                    lambda: build_cornell_box("hikari_tpu_torch")),
}


@pytest.mark.parametrize("name", sorted(SCENES))
def test_compiled_arrays_equal_reference(name):
    build_ref, build_port = SCENES[name]
    ref = build_ref().compile()
    got = build_port().compile()
    # everything but hikari_tpu's bf16 panel tiling of the atlas (a TPU
    # window-DMA layout the port replaces by per-pixel gathers)
    assert set(ref.arrays) - set(got.arrays) == {"atlas_panels"}
    for k, v in got.arrays.items():
        r = ref.arrays[k]
        assert v.dtype == r.dtype, k
        np.testing.assert_array_equal(v, r, err_msg=k)
    for attr in ("num_triangles", "num_nodes", "num_instances",
                 "num_emissives", "num_textures", "has_sun"):
        assert getattr(got, attr) == getattr(ref, attr), attr


def test_scene_from_arrays_converts_reference_scene():
    from hikari_tpu_torch import scene_from_arrays

    t = scene_from_arrays(emissive_reference().compile().arrays, "cpu")
    got = emissive_scene().compile().as_pytree("cpu")
    assert got.keys() <= t.keys()
    for k, v in got.items():
        assert torch.equal(t[k], v), k

