"""The port's glTF loader (models/gltf.py) against hikari_tpu's on the same
bytes, written by tests/torch_glb.py: the feature file as a GLB, as a
.gltf + .bin pair and as a .gltf with a data-URI buffer (u8/u16/u32
indices, a non-indexed and an interleaved primitive, a primitive without
normals, a skipped LINES primitive, TRS and matrix nodes in a hierarchy,
KHR_materials_emissive_strength, an embedded PNG scaled below its
max_texture_side), and the procedural Cornell box as a GLB. The loaded
Scenes (meshes, materials with their texels, instances) and the compiled
arrays are equal word for word."""

from __future__ import annotations

import numpy as np
import pytest

import hikari_tpu as hj
import hikari_tpu_torch as ht
from hikari_tpu.models.gltf import load_gltf_scene as load_ref
from hikari_tpu_torch.models.gltf import GltfFile, load_gltf_scene
from tests import torch_glb
from tests.test_torch_city_scene import NOT_PORTED, _bits_equal
from tests.torch_threads import one_torch_thread  # noqa: F401

MESH_FIELDS = ("positions", "normals", "uvs", "indices")
MAT_FIELDS = ("base_color", "emissive", "perceptual_roughness", "metallic",
              "reflectance")
TEXTURE_SLOTS = ("base_color_texture", "emissive_texture",
                 "metallic_roughness_texture", "occlusion_texture")
EXT = {"glb": ".glb", "gltf": ".gltf", "data_uri": ".gltf"}


def _load_both(path, **kw):
    got, ref = ht.Scene(), hj.Scene()
    ids = load_gltf_scene(path, got, **kw)
    ids_ref = load_ref(path, ref, **kw)
    assert ids == ids_ref
    return got, ref


def _assert_scenes_equal(got, ref):
    assert len(got.meshes) == len(ref.meshes)
    for a, b in zip(got.meshes, ref.meshes):
        for k in MESH_FIELDS:
            assert _bits_equal(getattr(a, k), getattr(b, k)), k
    assert len(got.materials) == len(ref.materials)
    for a, b in zip(got.materials, ref.materials):
        for k in MAT_FIELDS:
            # Python floats and tuples of them, from the same JSON
            assert getattr(a, k) == getattr(b, k), k
        for k in TEXTURE_SLOTS:
            ta, tb = getattr(a, k), getattr(b, k)
            assert (ta is None) == (tb is None), k
            if ta is not None:
                assert _bits_equal(ta.data, tb.data), k
                assert (ta.is_srgb, ta.repeat) == (tb.is_srgb, tb.repeat), k
    assert len(got.instances) == len(ref.instances)
    for a, b in zip(got.instances, ref.instances):
        assert (a.mesh, a.material, a.visible) == (b.mesh, b.material,
                                                   b.visible)
        assert _bits_equal(a.transform, b.transform)


def _assert_compiled_equal(got, ref):
    g, r = got.compile(), ref.compile()
    assert set(r.arrays) - set(g.arrays) <= NOT_PORTED
    assert set(g.arrays) <= set(r.arrays)
    for k, v in g.arrays.items():
        assert _bits_equal(v, r.arrays[k]), k
    for k in ("num_triangles", "num_nodes", "num_instances",
              "num_emissives", "num_textures"):
        assert getattr(g, k) == getattr(r, k), k
    return g


@pytest.mark.parametrize("fmt", list(EXT))
def test_feature_file_loads_as_reference(tmp_path, fmt):
    path = torch_glb.feature_file(str(tmp_path / f"features{EXT[fmt]}"),
                                  fmt)
    side = torch_glb.FEATURE_MAX_TEXTURE_SIDE
    got, ref = _load_both(path, max_texture_side=side)
    _assert_scenes_equal(got, ref)
    # what the file covers reached the scene: the LINES primitive was
    # skipped (4 primitives of 5 spawn), the texture was scaled down, the
    # emissive strength applied, the default material added
    assert len(got.instances) == 4
    tex = got.materials[0].base_color_texture
    assert max(tex.data.shape[:2]) == side
    assert max(torch_glb.FEATURE_TEXTURE_SHAPE) > side
    np.testing.assert_allclose(got.materials[0].emissive[:3],
                               (3.0, 2.4, 1.5))
    assert len(got.materials) == 3
    # the primitive without normals got unit flat normals
    fan = got.meshes[1]
    np.testing.assert_allclose(np.linalg.norm(fan.normals, axis=1), 1.0,
                               rtol=1e-5)
    g = _assert_compiled_equal(got, ref)
    assert g.num_textures == 1


def test_feature_file_without_textures(tmp_path):
    path = torch_glb.feature_file(str(tmp_path / "f.glb"), "glb", seed=3)
    got, ref = _load_both(path, load_textures=False)
    _assert_scenes_equal(got, ref)
    assert got.materials[0].base_color_texture is None
    _assert_compiled_equal(got, ref)


def test_gltf_file_parts(tmp_path):
    """GltfFile reads the GLB's JSON and BIN chunks, and the accessors of
    every component type the feature file uses."""
    path = torch_glb.feature_file(str(tmp_path / "f.glb"), "glb")
    f = GltfFile(path)
    assert f.json["asset"]["version"] == "2.0" and f.bin is not None
    types = {a["componentType"] for a in f.json["accessors"]}
    assert {torch_glb.U8, torch_glb.U16, torch_glb.U32,
            torch_glb.FLOAT} <= types
    assert f.image(0).shape == torch_glb.FEATURE_TEXTURE_SHAPE + (4,)


@pytest.mark.parametrize("package", ["hikari_tpu_torch", "hikari_tpu"])
def test_cornell_glb_loads_as_reference(tmp_path, package):
    """The box written from either package's Scene reads back the same in
    both loaders, and (without a sun, as the cornell example sets it)
    compiles to the procedural box's arrays."""
    from tests.cornell_box import build_cornell_box

    path = torch_glb.write_cornell_glb(str(tmp_path / "cornell.glb"),
                                       package)
    got, ref = _load_both(path)
    _assert_scenes_equal(got, ref)
    _assert_compiled_equal(got, ref)
    got.directional_light = ht.DirectionalLight(illuminance=0.0)
    g = got.compile()
    box = build_cornell_box("hikari_tpu_torch").compile()
    for k, v in box.arrays.items():
        assert _bits_equal(g.arrays[k], v), k
