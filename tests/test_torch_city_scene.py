"""The city of BASELINE config 5 in the port: uv_sphere, and the compiled
city of hikari_tpu_torch/examples/city.py against hikari_tpu's
(examples/city.py) after 0-3 house waves, and with the Earth image, bit
for bit on every array the port keeps."""

from __future__ import annotations

import numpy as np
import pytest

from examples import city as city_ref
from hikari_tpu.models import mesh as mesh_ref
from hikari_tpu_torch.examples import city
from hikari_tpu_torch.models import mesh
from tests.torch_threads import one_torch_thread  # noqa: F401

# hikari_tpu's arrays the port does not build: the bf16 layouts of the
# atlas (the port gathers from the f32 atlas) and the tile-cull cluster
# tables (kernel 13 walks bvh_packed instead)
NOT_PORTED = {"atlas_panels", "atlas_quad", "cl_aabb", "cl_tri_packed",
              "cl_attr_packed"}


def _bits_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return (a.dtype == b.dtype and a.shape == b.shape
            and np.array_equal(a.view(np.uint8), b.view(np.uint8)))


@pytest.mark.parametrize("args", [(), (0.5, 24, 12)],
                         ids=["default", "small"])
def test_uv_sphere_matches_reference(args):
    got, ref = mesh.uv_sphere(*args), mesh_ref.uv_sphere(*args)
    for k in ("positions", "normals", "uvs", "indices"):
        assert _bits_equal(getattr(got, k), getattr(ref, k)), k


@pytest.mark.parametrize("waves", [0, 1, 2, 3])
def test_compiled_city_matches_reference(waves):
    got = city.build_scene(waves).compile()
    ref = city_ref.build_scene(waves).compile()
    assert set(ref.arrays) - set(got.arrays) <= NOT_PORTED
    assert set(got.arrays) <= set(ref.arrays)
    for k, v in got.arrays.items():
        assert _bits_equal(v, ref.arrays[k]), k
    for k in ("num_triangles", "num_nodes", "num_instances",
              "num_emissives"):
        assert getattr(got, k) == getattr(ref, k), k
    assert got.num_triangles > 768 or waves == 0
    np.testing.assert_array_equal(got.bvh.prim_order, ref.bvh.prim_order)


def test_city_sizes():
    """The city after its last wave: 122 instances, 2,618 triangles, 7
    materials, a 5,235-node BVH, one emissive (the 1,224-triangle sphere,
    its alias table 1,224 slots) and a sun."""
    g = city.build_scene(3).compile()
    a = g.arrays
    assert (g.num_instances, g.num_triangles, g.num_nodes) == (122, 2618,
                                                               5235)
    assert a["mat_packed"].shape[0] == 7 and g.num_emissives == 1
    assert a["alias_packed"].shape[0] == 1224
    assert a["em_tri_pos_flat"].shape[0] == 1224 and g.has_sun


def test_rotate_sphere_moves_only_the_sphere():
    sc = city.build_scene(1)
    before = [i.transform.copy() for i in sc.instances]
    city.rotate_sphere(sc, 0.3)
    ref = city_ref.rotate_sphere(city_ref.build_scene(1), 0.3)
    for k, (inst, old) in enumerate(zip(sc.instances, before)):
        moved = k == city.SPHERE_INSTANCE
        assert np.array_equal(inst.transform, old) != moved
        np.testing.assert_array_equal(inst.transform,
                                      ref.instances[k].transform)
    np.testing.assert_array_equal(
        sc.instances[city.SPHERE_INSTANCE].prev_transform,
        before[city.SPHERE_INSTANCE])



def test_compiled_city_with_the_earth_image_matches_reference(
        tmp_path, monkeypatch):
    """With the Earth image under $HIKARI_ASSETS both cities texture the
    sphere's base colour and emissive slots with it (an image written here:
    the repository has none)."""
    from PIL import Image

    from hikari_tpu_torch.examples import simple

    path = tmp_path / "models" / "Earth" / "earth_daymap.jpg"
    path.parent.mkdir(parents=True)
    Image.fromarray(simple.procedural_earth(3).data).save(path,
                                                          format="PNG")
    monkeypatch.setenv("HIKARI_ASSETS", str(tmp_path))
    monkeypatch.setattr(city_ref, "ASSETS", str(tmp_path))
    got = city.build_scene(1).compile()
    ref = city_ref.build_scene(1).compile()
    assert set(ref.arrays) - set(got.arrays) <= NOT_PORTED
    for k, v in got.arrays.items():
        assert _bits_equal(v, ref.arrays[k]), k
    assert got.num_textures == ref.num_textures == 1
    assert got.arrays["atlas"].shape == (2048, 2048, 4)
