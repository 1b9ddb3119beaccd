"""Textures in the port against hikari_tpu: srgb_to_linear, pack_atlas and
pack_materials' texture ids, the compiled textured simple scene
(BASELINE config 3 with a procedural Earth), the exact sampler
(ops/shading.py sample_atlas, retrieve_surface, retrieve_emissive), and
kernel 14's contract (ops/texture_pallas.py) against hikari_tpu's banded
sampler in interpret mode.

Bars: bit for bit for the atlas, the rects, the texture ids, the compiled
scene and the exact gather (hikari_tpu's sample_atlas without its
`atlas_quad`); within 2^-8 absolute of hikari_tpu's quad-atlas gather (the
quad is bf16, the texels lie in [0, 1]); kernel 14 within 2e-2 absolute of
hikari_tpu's window sampler (its own bar, tests/test_texture_pallas.py) on
the pixels whose footprint lies inside their group's window, which is
recomputed here as texture_pallas.py:157-191 does, with the share of such
pixels floored at what these fields give. The port has no window: where
a footprint leaves it, the port takes the exact bilinear and the reference
clamps.
"""

from __future__ import annotations

import ctypes
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import examples.simple as simple_ref
from hikari_tpu.models import material as material_ref
from hikari_tpu.models import mesh as mesh_ref
from hikari_tpu.models.scene import _atlas_quad_bf16, _atlas_panels_bf16
from hikari_tpu.ops import shading as shading_ref
from hikari_tpu.ops import texture_pallas as tx_ref
from hikari_tpu_torch.examples import simple
from hikari_tpu_torch.models import material
from hikari_tpu_torch.ops import shading
from hikari_tpu_torch.ops import texture_pallas as tx
from tests.torch_threads import one_torch_thread  # noqa: F401


def _bits_equal(a, b):
    a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
    return (a.dtype == b.dtype and a.shape == b.shape
            and np.array_equal(a.view(np.uint8), b.view(np.uint8)))


def _textures(pkg, rng, count):
    """Textures of odd sizes in every form _to_linear_f32 takes: RGBA and
    RGB uint8 sRGB, grey uint8 linear, float32 linear RGBA."""
    forms = [
        lambda: pkg.Texture(rng.integers(0, 256, (37, 53, 4), np.uint8)),
        lambda: pkg.Texture(rng.integers(0, 256, (21, 9, 3), np.uint8)),
        lambda: pkg.Texture(rng.integers(0, 256, (5, 131), np.uint8),
                            is_srgb=False),
        lambda: pkg.Texture(rng.random((64, 3, 4), np.float32),
                            is_srgb=False),
    ]
    return [forms[i]() for i in range(count)]


def test_srgb_to_linear_matches_reference():
    c = np.concatenate([np.arange(256, dtype=np.float32) / 255.0,
                        np.random.default_rng(0).random(4096, np.float32)])
    assert _bits_equal(material.srgb_to_linear(c),
                       material_ref.srgb_to_linear(c))


@pytest.mark.parametrize("count", [2, 3, 4])
def test_pack_atlas_matches_reference(count):
    got = material.pack_atlas(_textures(material, np.random.default_rng(1),
                                        count))
    ref = material_ref.pack_atlas(
        _textures(material_ref, np.random.default_rng(1), count))
    for g, r in zip(got, ref):
        assert _bits_equal(g, r)
    atlas, rects = got
    # every rect's 1-texel border is its opposite edge (repeat addressing)
    for x0, y0, tw, th in rects:
        inner = atlas[y0:y0 + th, x0:x0 + tw]
        assert np.array_equal(atlas[y0 - 1, x0:x0 + tw], inner[-1])
        assert np.array_equal(atlas[y0:y0 + th, x0 + tw], inner[:, 0])


def test_pack_atlas_without_textures():
    atlas, rects = material.pack_atlas([])
    ref_atlas, ref_rects = material_ref.pack_atlas([])
    assert _bits_equal(atlas, ref_atlas) and _bits_equal(rects, ref_rects)


def test_pack_materials_dedups_like_reference():
    """Texture ids by first use over the materials' slots in order, one
    atlas entry per texture object however many slots share it."""
    tables = []
    for pkg in (material, material_ref):
        a, b, c = _textures(pkg, np.random.default_rng(2), 3)
        M = pkg.StandardMaterial
        tables.append(pkg.pack_materials([
            M(base_color=(0.2, 0.3, 0.4, 1.0)),
            M(base_color_texture=b, emissive_texture=b,
              occlusion_texture=a),
            M(metallic_roughness_texture=c, normal_map_texture=a,
              emissive=(1.0, 1.0, 1.0, 0.5)),
            M(base_color_texture=c, occlusion_texture=c)]))
    (table, atlas, rects, n), ref = tables
    assert n == ref[3] == 3
    assert set(table) == set(ref[0])
    for k, v in table.items():
        assert _bits_equal(v, ref[0][k]), k
    assert _bits_equal(atlas, ref[1]) and _bits_equal(rects, ref[2])
    assert table["base_color_texture"].tolist() == [-1, 0, -1, 2]
    assert table["occlusion_texture"].tolist() == [-1, 1, -1, 2]


def _write_earth(root, tex):
    """The texture as a PNG at the path hikari_tpu's examples load the
    Earth image from (PIL opens it by its content)."""
    path = os.path.join(root, "models", "Earth", "earth_daymap.jpg")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(tex.data).save(path, format="PNG")
    return path


def textured_simple_scenes(root, seed=0):
    """The compiled textured simple scene through both packages, on the
    same procedural Earth image (hikari_tpu's read from a PNG written
    under `root`)."""
    tex = simple.procedural_earth(seed)
    _write_earth(root, tex)
    mp = pytest.MonkeyPatch()
    mp.setattr(simple_ref, "ASSETS", root)
    try:
        ref = simple_ref.build_scene().compile()
    finally:
        mp.undo()
    return simple.build_scene(tex).compile(), ref


def reference_arrays(gpu):
    """hikari_tpu's compiled arrays without its bf16 atlas layouts, so
    that its samplers take the exact gather (shading.py:108)."""
    return {k: v for k, v in gpu.arrays.items()
            if k not in ("atlas_panels", "atlas_quad")}


@pytest.fixture(scope="module")
def simple_scenes(tmp_path_factory):
    return textured_simple_scenes(str(tmp_path_factory.mktemp("assets")))


def test_procedural_earth():
    tex = simple.procedural_earth(0)
    assert tex.data.shape == (512, 1024, 4) and tex.data.dtype == np.uint8
    assert (tex.data[..., 3] == 255).all() and tex.is_srgb
    assert np.array_equal(simple.procedural_earth(0).data, tex.data)
    assert not np.array_equal(simple.procedural_earth(1).data, tex.data)


def test_compiled_textured_simple_scene_matches_reference(simple_scenes):
    """Every array the port builds, bit for bit; the reference's bf16
    atlas layouts are the ones it does not."""
    got, ref = simple_scenes
    assert set(ref.arrays) - set(got.arrays) == {
        "atlas_panels", "atlas_quad", "cl_aabb", "cl_tri_packed",
        "cl_attr_packed"}
    assert set(got.arrays) <= set(ref.arrays)
    for k, v in got.arrays.items():
        assert _bits_equal(v, ref.arrays[k]), k
    for k in ("num_triangles", "num_nodes", "num_instances",
              "num_emissives", "num_textures", "has_sun"):
        assert getattr(got, k) == getattr(ref, k), k
    a = got.arrays
    assert (got.num_triangles, got.num_textures, got.num_emissives) == (
        2510, 1, 2)
    assert a["atlas"].shape == (2048, 2048, 4)
    assert a["tex_rect"].tolist() == [[1, 1, 1024, 512]]
    # the spheres' base colour and emissive slots hold the one texture
    assert a["mat_packed"][:, 11:15].tolist() == (
        [[-1.0] * 4] * 4 + [[0.0, 0.0, -1.0, -1.0]] * 2)


def _atlas_scene(textures, pkg_tensor):
    atlas, rects = material_ref.pack_atlas(textures)
    return atlas, rects, {"atlas": pkg_tensor(atlas),
                          "tex_rect": pkg_tensor(rects)}


def _sampler_inputs(rng, n, n_tex):
    """uv over [-2.5, 3.5) (negative and seam-crossing), ids in
    [-1, n_tex)."""
    uv = rng.uniform(-2.5, 3.5, (n, 2)).astype(np.float32)
    # a share exactly on and just off the seams
    uv[: n // 8] = np.round(uv[: n // 8])
    uv[n // 8: n // 4] = np.nextafter(np.round(uv[n // 8: n // 4]),
                                      np.float32(-10.0))
    tid = rng.integers(-1, n_tex, n).astype(np.int32)
    return uv, tid


# slot sets of one kernel-14 launch: the textured paths' (base colour,
# emissive), all four, and a pair that skips slots
SLOT_SETS = [(0, 1), (0, 1, 2, 3), (1, 3)]


@pytest.mark.parametrize("slots", [None] + SLOT_SETS,
                         ids=lambda s: "one" if s is None
                         else "slots" + "".join(map(str, s)))
def test_sample_atlas_matches_reference_gather(slots):
    """sample_atlas bit for bit hikari_tpu's exact gather; with `slots`,
    sample_atlas_slots (the multi-slot launch's contract on the CPU) from
    a [..., 4] id row and the uv half of a [..., 4] velocity_uv plane: one
    output per requested slot, each equal to the reference of that slot's
    ids."""
    rng = np.random.default_rng(3)
    texs = _textures(material_ref, rng, 4)
    _, _, sj = _atlas_scene(texs, jnp.asarray)
    _, _, st = _atlas_scene(texs, torch.from_numpy)
    uv, tid = _sampler_inputs(rng, 50000, 4)
    if slots is None:
        ref = np.asarray(shading_ref.sample_atlas(sj, jnp.asarray(tid),
                                                  jnp.asarray(uv)))
        got = shading.sample_atlas(st, torch.from_numpy(tid),
                                   torch.from_numpy(uv)).numpy()
        assert _bits_equal(got, ref)
        assert (got[tid < 0] == 1.0).all()
        return
    row = rng.integers(-1, 4, (tid.size, 4)).astype(np.int32)
    row[:, slots[0]] = tid
    vel = np.concatenate([rng.random(uv.shape, np.float32), uv], -1)
    got = tx.sample_atlas_slots(st, torch.from_numpy(row),
                                torch.from_numpy(vel)[..., 2:4], slots)
    assert len(got) == len(slots)
    for s, g in zip(slots, got):
        ref = np.asarray(shading_ref.sample_atlas(
            sj, jnp.asarray(row[:, s]), jnp.asarray(uv)))
        assert _bits_equal(g.numpy(), ref), s


def test_sample_atlas_within_bf16_of_the_quad_atlas():
    rng = np.random.default_rng(4)
    texs = _textures(material_ref, rng, 3)
    atlas, rects, st = _atlas_scene(texs, torch.from_numpy)
    sj = {"atlas": jnp.asarray(atlas), "tex_rect": jnp.asarray(rects),
          "atlas_quad": jnp.asarray(np.asarray(_atlas_quad_bf16(atlas)))}
    uv, tid = _sampler_inputs(rng, 20000, 3)
    ref = np.asarray(shading_ref.sample_atlas(sj, jnp.asarray(tid),
                                              jnp.asarray(uv)))
    got = shading.sample_atlas(st, torch.from_numpy(tid),
                               torch.from_numpy(uv)).numpy()
    err = np.abs(got - ref).max()
    print(f"sample_atlas vs the quad atlas: max abs diff {err:.3g}")
    assert err <= 2.0 ** -8, err


def _material_scene():
    """A compiled one-quad scene whose material table textures every slot
    somewhere, as both packages' scene dicts (hikari_tpu's without its bf16
    atlas layouts)."""
    from hikari_tpu.models import scene as scene_ref
    from hikari_tpu_torch.models import mesh, scene

    dicts = []
    for pkg, sc_mod, mesh_mod, tensor in (
            (material, scene, mesh, torch.from_numpy),
            (material_ref, scene_ref, mesh_ref, jnp.asarray)):
        a, b, c = _textures(pkg, np.random.default_rng(5), 3)
        M = pkg.StandardMaterial
        sc = sc_mod.Scene()
        sc.spawn(sc.add_mesh(mesh_mod.quad(1.0, 1.0)), 0)
        for m in (M(base_color=(0.5, 0.6, 0.7, 1.0), metallic=0.4),
                  M(base_color_texture=a, emissive_texture=b,
                    metallic_roughness_texture=c, occlusion_texture=a,
                    emissive=(1.0, 0.5, 0.2, 0.8), metallic=0.7),
                  M(base_color_texture=c, occlusion_texture=b,
                    metallic=0.2)):
            sc.add_material(m)
        dicts.append({k: tensor(np.asarray(v)) for k, v in
                      reference_arrays(sc.compile()).items()})
    return dicts


def test_retrieve_surface_and_emissive_match_reference():
    """All four slots (base colour, emissive, metallic-roughness .r,
    occlusion .r) and the emissive alone, with misses (material -1),
    untextured and textured materials, bit for bit."""
    rng = np.random.default_rng(6)
    st, sj = _material_scene()
    n = 4096
    mat = rng.integers(-1, 3, n).astype(np.int32)
    uv = rng.uniform(-1.5, 2.5, (n, 2)).astype(np.float32)
    ref = shading_ref.retrieve_surface(sj, jnp.asarray(mat), jnp.asarray(uv),
                                       False)
    got = shading.retrieve_surface(st, torch.from_numpy(mat),
                                   torch.from_numpy(uv), False)
    for k in ref:
        assert _bits_equal(got[k].numpy(), ref[k]), k
    ref_e = shading_ref.retrieve_emissive(sj, jnp.asarray(mat),
                                          jnp.asarray(uv), False)
    got_e = shading.retrieve_emissive(st, torch.from_numpy(mat),
                                      torch.from_numpy(uv), False)
    assert _bits_equal(got_e.numpy(), ref_e)
    # a slot no material textures may be left out with the same result
    assert shading.used_slots(st) == (True, True, True, True)
    part = shading.retrieve_surface(st, torch.from_numpy(mat),
                                    torch.from_numpy(uv), False,
                                    coherent=True)
    for k in ref:
        assert _bits_equal(part[k].numpy(), ref[k]), k


# kernel 14's fields: (name, uv over the [h, w] pixels, tex ids)
KERNEL_SIZE = (32, 64)


def _kernel_fields():
    h, w = KERNEL_SIZE
    ys = (np.arange(h) / h)[:, None] + np.zeros((1, w))
    xs = (np.arange(w) / w)[None, :] + np.zeros((h, 1))
    left = xs < 0.5
    return {
        # texels larger than pixels, on the Earth (id 0) and a small one
        "magnified": (np.stack([0.4 + 0.02 * xs, 0.3 + 0.04 * ys], -1),
                      np.where(left, 0, 2)),
        # u and v cross 1.0 inside the field on the small textures
        "seam": (np.stack([0.9 + 0.2 * xs, 0.95 + 0.1 * ys], -1),
                 np.where(left, 1, 2)),
        # the spheres' minification: the whole Earth over 64x32 pixels,
        # and pixels with no texture
        "minified": (np.stack([xs - 0.3, ys], -1),
                     np.where(ys < 0.25, -1, 0)),
    }


def _window_mask(rects, hb, wb, tid, uv):
    """Pixels whose bilinear footprint lies inside their 16x16 group's
    window: the window origin recomputed as texture_pallas.py:157-191
    does (float32), then 0 <= lx <= 255 and 0 <= ly <= 63."""
    G, WR, BLK, WCB = tx_ref.GROUP, tx_ref.WR, tx_ref.BLK, tx_ref.WCB
    f = np.float32
    rect = rects[np.maximum(tid, 0)].astype(f)
    u = uv[..., 0] - np.floor(uv[..., 0])
    v = uv[..., 1] - np.floor(uv[..., 1])
    fx = rect[..., 0] + u * np.maximum(rect[..., 2], f(1)) - f(0.5)
    fy = rect[..., 1] + v * np.maximum(rect[..., 3], f(1)) - f(0.5)
    h, w = tid.shape
    valid = tid >= 0

    def groups(a):
        return a.reshape(h // G, G, w // G, G).transpose(0, 2, 1, 3)

    nv = np.maximum(groups(valid).sum(axis=(2, 3)), 1)
    y_mean = (groups(fy) * groups(valid)).sum(axis=(2, 3)) / nv
    x_mean = (groups(fx) * groups(valid)).sum(axis=(2, 3)) / nv
    by = np.clip(np.round((y_mean - WR / 2) / 8), 0, hb - tx_ref.WRB)
    bx = np.clip(np.round((x_mean - WCB * BLK / 2) / BLK), 0, wb - WCB)
    ly = groups(fy) - (by * 8)[:, :, None, None]
    lx = groups(fx) - (bx * BLK)[:, :, None, None]
    inside = ((lx >= 0) & (lx <= WCB * BLK - 1) & (ly >= 0)
              & (ly <= WR - 1))
    return inside.transpose(0, 2, 1, 3).reshape(h, w)


# the share of textured pixels in their window on these fields (measured
# on the CPU: 1.0, 1.0 and 0.1875: a 16-pixel group of the minified field
# spans 256 texel rows, the window 64)
IN_WINDOW_FLOOR = {"magnified": 1.0, "seam": 1.0, "minified": 0.18}


@pytest.fixture(scope="module")
def kernel_scene():
    """The procedural Earth and two small textures in one atlas, with
    hikari_tpu's bf16 panels of it."""
    rng = np.random.default_rng(9)
    texs = [material_ref.Texture(simple.procedural_earth(0).data),
            material_ref.Texture(rng.integers(0, 256, (48, 64, 4),
                                              np.uint8)),
            material_ref.Texture(rng.integers(0, 256, (32, 32, 4),
                                              np.uint8))]
    atlas, rects = material_ref.pack_atlas(texs)
    sj = {"atlas": jnp.asarray(atlas), "tex_rect": jnp.asarray(rects),
          "atlas_panels": jnp.asarray(np.asarray(_atlas_panels_bf16(atlas)))}
    st = {"atlas": torch.from_numpy(atlas),
          "tex_rect": torch.from_numpy(rects)}
    return atlas, rects, sj, st


@pytest.mark.parametrize("field", sorted(IN_WINDOW_FLOOR))
def test_kernel14_in_window_matches_port(kernel_scene, field):
    atlas, rects, sj, st = kernel_scene
    uv, tid = _kernel_fields()[field]
    uv, tid = uv.astype(np.float32), tid.astype(np.int32)
    ref = np.asarray(tx_ref.sample_atlas_coherent(
        sj, jnp.asarray(tid), jnp.asarray(uv), interpret=True))
    got = tx.sample_atlas_coherent(st, torch.from_numpy(tid),
                                   torch.from_numpy(uv)).numpy()
    assert _bits_equal(got, shading.sample_atlas(
        st, torch.from_numpy(tid), torch.from_numpy(uv)).numpy())
    panels = sj["atlas_panels"]
    inside = _window_mask(rects, panels.shape[1], panels.shape[2], tid, uv)
    textured = tid >= 0
    share = inside[textured].mean()
    err = np.abs(got - ref)[inside & textured].max()
    print(f"kernel 14 {field}: {share:.4f} of textured pixels in their "
          f"window, max abs diff there {err:.3g}")
    assert share >= IN_WINDOW_FLOOR[field], share
    assert err <= 2e-2, err
    assert (got[~textured] == 1.0).all() and (ref[~textured] == 1.0).all()


class _FakeTextureLibrary:
    """Stands in for the built texture library: checks the call against
    the declared ctypes signature and records it."""

    def __init__(self):
        self.args = []

    @property
    def hk_sample_atlas(self):
        def fn(*args):
            assert len(args) == len(fn.argtypes)
            for a, t in zip(args, fn.argtypes):
                want = {ctypes.c_int: int, ctypes.c_char_p: bytes}.get(
                    t, ctypes.c_void_p)
                assert isinstance(a, want), a
            self.args.append(args)
            return 0

        self.__dict__["hk_sample_atlas"] = fn
        return fn


TABLE_FIELDS = ("atlas", "rect", "ids", "uv", "out", "n", "ah", "aw",
                "n_rect", "n_slots", "slot0", "slot1", "slot2", "slot3", "pad")


def _table(args):
    """The fields of one launch's SampleCall (csrc/texture.cu)."""
    table, _ = args
    return dict(zip(TABLE_FIELDS, tx.SAMPLE_TABLE.unpack(table)))


def test_kernel14_wrapper_marshals_and_counts(monkeypatch):
    """The CUDA branch up to the C call, one packed table per launch: a
    slot's column of the id row with the uv half of velocity_uv passes with
    their pixel stride of 4, one launch per call; pixels at no uniform
    stride raise. Every requested slot of an id row goes in one launch,
    into views of one allocation; the scene's tables are checked once and
    give way to a new atlas."""
    from hikari_tpu_torch import build

    fake = _FakeTextureLibrary()
    monkeypatch.setattr(build, "load_cuda", lambda name: fake)
    monkeypatch.setattr(tx, "on_cpu", lambda t: False)
    monkeypatch.setattr(tx, "stream", lambda dev: ctypes.c_void_p(0))
    monkeypatch.setattr(tx.sample_atlas_slots, "launches", 0)
    _, _, st = _atlas_scene(_textures(material_ref,
                                      np.random.default_rng(7), 2),
                            torch.from_numpy)
    h, w = 6, 10
    tid4 = torch.zeros((h, w, 4), dtype=torch.int32)
    vel = torch.zeros((h, w, 4))
    out = tx.sample_atlas_coherent(st, tid4[..., 1], vel[..., 2:4])
    assert out.shape == (h, w, 4)
    (a,) = fake.args
    t = _table(a)
    assert t["ids"] == tid4[..., 1].data_ptr()
    assert t["uv"] == vel[..., 2:4].data_ptr()
    assert t["out"] == out.data_ptr()
    assert (t["n"], t["ah"], t["aw"], t["n_rect"], t["n_slots"],
            t["slot0"]) == (h * w, *st["atlas"].shape[:2], 2, 1, 0)
    assert t["atlas"] == st["atlas"].data_ptr()
    assert t["rect"] == st["tex_rect"].data_ptr()
    assert tx.sample_atlas_slots.launches == 1
    with pytest.raises(ValueError, match="uniform stride"):
        tx.sample_atlas_coherent(st, tid4[:, :5, 0], vel[:, :5, 2:4])
    with pytest.raises(ValueError, match="contiguous"):
        tx.sample_atlas_coherent(st, tid4[..., 0], vel[..., ::2])
    assert tx.sample_atlas_slots.launches == 1

    # the textured paths' launch: base colour and emissive of the id row
    outs = tx.sample_atlas_slots(st, tid4, vel[..., 2:4], (0, 1))
    t = _table(fake.args[-1])
    assert len(fake.args) == 2 and tx.sample_atlas_slots.launches == 2
    assert [o.shape for o in outs] == [(h, w, 4)] * 2
    assert t["ids"] == tid4.data_ptr()
    assert (t["n_slots"], t["slot0"], t["slot1"], t["n"]) == (2, 0, 1, h * w)
    assert t["out"] == outs[0].data_ptr()
    assert outs[1].data_ptr() == outs[0].data_ptr() + 4 * 4 * h * w
    assert outs[0].untyped_storage().data_ptr() == \
        outs[1].untyped_storage().data_ptr()
    # all four slots in one launch; slots go in ascending order
    tx.sample_atlas_slots(st, tid4, vel[..., 2:4], (0, 1, 2, 3))
    t = _table(fake.args[-1])
    assert (t["n_slots"], t["slot0"], t["slot1"], t["slot2"],
            t["slot3"]) == (4, 0, 1, 2, 3)
    for bad in ((), (0, 0), (4,), (1, 0), (0, 1, 2, 3, 0)):
        with pytest.raises(ValueError, match="slots"):
            tx.sample_atlas_slots(st, tid4, vel[..., 2:4], bad)
    with pytest.raises(ValueError, match="tid"):
        tx.sample_atlas_slots(st, tid4[:, ::2], vel[:, ::2, 2:4], (0,))
    with pytest.raises(ValueError, match="uniform stride"):
        tx.sample_atlas_slots(st, tid4, torch.zeros((h, w, 2)), (0,))
    assert len(fake.args) == 3 and tx.sample_atlas_slots.launches == 3

    # a recompiled scene brings a new atlas: its own pointers and shape,
    # and its tables are checked again
    _, _, st2 = _atlas_scene(_textures(material_ref,
                                       np.random.default_rng(8), 3),
                             torch.from_numpy)
    assert st2["atlas"].shape != st["atlas"].shape
    tx.sample_atlas_slots(st2, tid4, vel[..., 2:4], (0, 1))
    t = _table(fake.args[-1])
    assert (t["atlas"], t["rect"], t["ah"], t["aw"], t["n_rect"]) == (
        st2["atlas"].data_ptr(), st2["tex_rect"].data_ptr(),
        *st2["atlas"].shape[:2], 3)
    bad = {"atlas": st2["atlas"].double(), "tex_rect": st2["tex_rect"]}
    with pytest.raises(TypeError, match="atlas"):
        tx.sample_atlas_slots(bad, tid4, vel[..., 2:4], (0,))
    tx.sample_atlas_slots(st, tid4, vel[..., 2:4], (0,))
    assert _table(fake.args[-1])["atlas"] == st["atlas"].data_ptr()
    assert tx.sample_atlas_slots.launches == 5
