"""The port's boundaries: it imports neither JAX nor hikari_tpu, refuses
what it has not ported (more than 8 emissives, the host refit), renders
on CUDA unless asked for the CPU, and its kernel wrappers marshal their
launches correctly."""

from __future__ import annotations

import ctypes
import dataclasses
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import hikari_tpu_torch as ht
from tests.cornell_box import EYE, TARGET, build_cornell_box
from tests.torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "hikari_tpu_torch")


def _flagship(**changes):
    return dataclasses.replace(
        ht.HikariSettings(), **{**dict(
            temporal_reuse=False, indirect_bounces=1, taa=ht.Taa.NONE,
            upscale=ht.Upscale.none(), emissive_spatial_reuse=False,
            indirect_spatial_reuse=False), **changes})


def _camera():
    return ht.Camera.from_look_at(EYE, TARGET, width=16, height=12)


def test_import_leaves_jax_and_reference_out():
    code = ("import sys, hikari_tpu_torch, hikari_tpu_torch.frame;"
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m == 'hikari_tpu' "
            "or m.startswith('hikari_tpu.')];"
            "print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_sources_do_not_reference_jax_or_the_reference_package():
    """No source of the port (hikari_tpu_torch/parallel/ among them),
    chip_smoke.py or tests/torch_dist.py (the rank functions that spawned
    processes import) names jax or hikari_tpu."""
    files = [os.path.join(REPO, "chip_smoke.py"),
             os.path.join(REPO, "tests", "torch_dist.py")]
    assert os.path.isfile(os.path.join(PKG, "parallel", "shard.py"))
    for root, _, names in os.walk(PKG):
        files += [os.path.join(root, n) for n in names
                  if n.endswith((".py", ".cu", ".cuh", ".cpp"))]
    pattern = re.compile(r"import jax|from jax|\bhikari_tpu\.|"
                         r"from hikari_tpu |import hikari_tpu\b")
    for path in files:
        with open(path) as f:
            for i, line in enumerate(f, 1):
                assert not pattern.search(line), f"{path}:{i}: {line}"


_FORBIDDEN = ("bad = [m for m in sys.modules if m in ('jax', 'hikari_tpu', "
              "'examples') or m.startswith(('jax.', 'hikari_tpu.', "
              "'examples.'))];")


def _port_modules():
    """Every module of the port's package, its examples included, by
    name."""
    mods = []
    for root, _, names in os.walk(PKG):
        rel = os.path.relpath(root, REPO).replace(os.sep, ".")
        for n in sorted(names):
            if n.endswith(".py"):
                mods.append(rel if n == "__init__.py" else f"{rel}.{n[:-3]}")
    return sorted(mods)


def test_every_module_leaves_jax_and_the_reference_out():
    """Importing every module of hikari_tpu_torch (the examples, the glTF
    loader, utils/image, utils/profiling and the row sharding of parallel/
    among them) and tests/torch_dist.py loads neither jax, nor hikari_tpu,
    nor the reference's examples package."""
    mods = _port_modules()
    assert {"hikari_tpu_torch.examples.common",
            "hikari_tpu_torch.examples.minimal",
            "hikari_tpu_torch.examples.cornell",
            "hikari_tpu_torch.models.gltf", "hikari_tpu_torch.utils.image",
            "hikari_tpu_torch.utils.profiling", "hikari_tpu_torch.parallel",
            "hikari_tpu_torch.parallel.mesh",
            "hikari_tpu_torch.parallel.shard"} <= set(mods)
    mods = mods + ["tests.torch_dist"]
    code = ("import importlib, sys;"
            f"[importlib.import_module(m) for m in {mods!r}];"
            + _FORBIDDEN + "print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_sources_do_not_import_the_reference_examples():
    """No source of the port and not chip_smoke.py names the reference's
    `examples` package in an import (the port's examples are
    hikari_tpu_torch.examples)."""
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(PKG):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    pattern = re.compile(r"^\s*(from examples\b|import examples\b)")
    for path in files:
        with open(path) as f:
            for i, line in enumerate(f, 1):
                assert not pattern.search(line), f"{path}:{i}: {line}"


def _with_sphere(sc):
    """The box plus a default uv_sphere (1,224 triangles, above 768)."""
    from hikari_tpu_torch.models import mesh as shapes
    from hikari_tpu_torch.models.scene import make_transform

    sc.spawn(sc.add_mesh(shapes.uv_sphere()), 0,
             make_transform((0.0, 0.3, 0.0), scale=(0.2, 0.2, 0.2)))
    return sc


def _textured(sc, pkg=None):
    """The box with a seeded 24x40 texture on its red left wall (material
    1), as a Scene of `pkg` (the port's by default)."""
    import importlib

    material = importlib.import_module(
        f"{pkg or 'hikari_tpu_torch'}.models.material")
    data = np.random.default_rng(8).integers(0, 256, (24, 40, 4), np.uint8)
    sc.materials[1].base_color_texture = material.Texture(data)
    return sc


@pytest.mark.parametrize("changes,scene", [
    # a scene beyond the fused lighting kernel takes the modular path
    # without reuse (hikari_tpu's no-reuse specializations)
    pytest.param({}, _with_sphere, id="large_scene_without_reuse"),
    # so does a textured scene (the fused kernels fetch no textures)
    pytest.param({}, _textured, id="textured_scene_without_reuse"),
    # the per-pixel tap scramble keeps kernel 10 out: the modular path
    pytest.param({"temporal_reuse": True, "indirect_spatial_reuse": True,
                  "spatial_tap_scramble": True},
                 None, id="temporal_reuse_tap_scramble"),
    # spatial reuse without temporal reuse takes the modular path
    pytest.param({"emissive_spatial_reuse": True}, None,
                 id="emissive_spatial_reuse"),
    pytest.param({"indirect_spatial_reuse": True}, None,
                 id="indirect_spatial_reuse"),
])
def test_settings_outside_the_slice_raise(changes, scene):
    """Settings and scenes the earlier slices refused (they raised
    NotImplementedError) render on the CPU: a finite, non-black frame
    after two frames, carrying the spatial reservoirs wherever spatial
    reuse is on. Their whole frames are held against hikari_tpu's in
    tests/test_torch_frame_{noreuse,spatial_noreuse,scramble}.py."""
    settings = dataclasses.replace(_flagship(), **changes)
    sc = build_cornell_box("hikari_tpu_torch")
    r = ht.Renderer(sc if scene is None else scene(sc), _camera(), settings,
                    device="cpu")
    img = r.render(2)
    assert img.shape == (12, 16, 4) and np.isfinite(img).all()
    assert img[..., :3].max() > 0.0
    tracks = (settings.emissive_spatial_reuse
              or settings.indirect_spatial_reuse)
    assert set(ht.frame.SPATIAL_KEYS) <= set(r.carry) or not tracks


@pytest.mark.parametrize("changes,size", [
    # checkerboard lighting at upscale ratio 2, with SMAA
    pytest.param({"checkerboard_lighting": True,
                  "upscale": ht.Upscale.smaa_tu4x(2.0)}, None,
                 id="checkerboard_lighting"),
    # SMAA at ratios 1.5 and 1 (its supersampling) and at an odd output
    # size: hikari_tpu's generic resample and parity samplers
    pytest.param({"upscale": ht.Upscale.smaa_tu4x(1.5)}, None,
                 id="smaa_ratio_1.5"),
    pytest.param({"upscale": ht.Upscale.smaa_tu4x(1.0)}, None,
                 id="smaa_ratio_1"),
    pytest.param({"upscale": ht.Upscale.smaa_tu4x(2.0)}, (47, 64),
                 id="smaa_ratio_2_odd_size"),
    pytest.param({"upscale": ht.Upscale.fsr1(1.5)}, None, id="upscale"),
    # checkerboard lighting with FSR at ratio 1.5 (render width 12)
    pytest.param({"checkerboard_lighting": True,
                  "upscale": ht.Upscale.fsr1(1.5)}, (12, 18),
                 id="checkerboard_fsr_ratio_1.5"),
])
def test_upscale_settings_render(changes, size):
    """Settings the earlier slices refused render on the CPU: a finite
    image at the output size, after two frames, with the render size and
    the post chain's carries at the shapes of hikari_tpu's frame
    (scaled_size, init_carry). Their whole frames are held against
    hikari_tpu's in tests/test_torch_frame_{upscale,smaa1,odd,ckb_half,
    ckb_fsr}.py and tests/test_torch_frame_scene.py."""
    import hikari_tpu as hj
    from hikari_tpu import frame as frame_ref

    settings = dataclasses.replace(_flagship(taa=ht.Taa.JASMINE), **changes)
    h, w = (12, 16) if size is None else size
    cam = ht.Camera.from_look_at(EYE, TARGET, width=w, height=h)
    r = ht.Renderer(build_cornell_box("hikari_tpu_torch"), cam, settings,
                    device="cpu")
    img = r.render(2)
    assert img.shape == (h, w, 4) and np.isfinite(img).all()
    assert (ht.frame.checkerboard_active(settings, (h, w))
            == settings.checkerboard_lighting)
    up = changes["upscale"]
    ref_settings = dataclasses.replace(
        hj.HikariSettings(), taa=hj.Taa.JASMINE,
        checkerboard_lighting=settings.checkerboard_lighting,
        upscale=hj.Upscale(hj.UpscaleMode(up.mode.value), up.ratio))
    assert (ht.frame.scaled_size((h, w), settings.upscale_ratio)
            == frame_ref.scaled_size((h, w), ref_settings.upscale_ratio))
    ref = frame_ref.init_carry((h, w), ref_settings)
    for k, v in r.carry.items():
        if k.startswith("prev_") and k != "prev_gbuffer" and "view" not in k:
            assert tuple(v.shape) == ref[k].shape, k
    for k, v in r.carry["prev_gbuffer"].items():
        assert tuple(v.shape) == ref["prev_gbuffer"][k].shape, k


@pytest.mark.parametrize("reuse", [False, True], ids=["K", "KR"])
def test_checkerboard_at_an_odd_width_lights_every_pixel(reuse):
    """At an odd render width checkerboard lighting is off, as in
    hikari_tpu (frame.py:142): the frame renders on the CPU exactly as
    without it."""
    cam = ht.Camera.from_look_at(EYE, TARGET, width=15, height=12)
    images = []
    for ckb in (True, False):
        settings = dataclasses.replace(_flagship(), temporal_reuse=reuse,
                                       checkerboard_lighting=ckb)
        r = ht.Renderer(build_cornell_box("hikari_tpu_torch"), cam, settings,
                        device="cpu")
        images.append(r.render(2))
    assert images[0].shape == (12, 15, 4) and np.isfinite(images[0]).all()
    np.testing.assert_array_equal(images[0], images[1])


def test_reference_default_settings_render():
    """HikariSettings() itself (temporal + indirect spatial reuse, TAA
    Jasmine, SMAA TU4X at ratio 2) builds and renders on the CPU."""
    r = ht.Renderer(build_cornell_box("hikari_tpu_torch"), _camera(),
                    ht.HikariSettings(), device="cpu")
    img = r.render(2)
    assert img.shape == (12, 16, 4) and np.isfinite(img).all()
    assert r.carry["indirect_temporal"].shape == (6, 16, 8)


def test_scene_beyond_the_caps_renders():
    """A box of 25 instances (kernel A takes 16) renders at the flagship
    settings through the non-fused prepass (the brute-force tracer), its
    lighting still in kernel B."""
    from hikari_tpu_torch import frame
    from hikari_tpu_torch.models import mesh as shapes
    from hikari_tpu_torch.models.scene import make_transform

    sc = build_cornell_box("hikari_tpu_torch")
    cube = sc.add_mesh(shapes.cube(0.1))
    for i in range(17):                    # 25 instances > 16
        sc.spawn(cube, 0, make_transform((0.1 * i - 0.8, 0.05, 0.8)))
    r = ht.Renderer(sc, _camera(), _flagship(), device="cpu")
    scene, kind = r.scene_dev, r.tracer.kind
    assert not frame.prepass_fused_eligible(scene, no_texture=True,
                                            tracer_kind=kind)
    assert frame.fused_eligible(
        scene, no_texture=True, num_emissives=r.gpu_scene.num_emissives,
        temporal_reuse=False, track_de=False, track_ind=False,
        tracer_kind=kind, has_sun=r.gpu_scene.has_sun, bounces=1, ckb=False)
    img = r.render(2)
    assert img.shape == (12, 16, 4) and np.isfinite(img).all()


def test_scene_beyond_the_caps_raises():
    """The name is historical: a scene beyond the old cap of 8 emissives
    no longer raises. Such a scene (10 emissives) builds, renders and
    refits on the CPU: update_scene(fast=True) takes the host refit,
    which rebuilds the emissive BVH and its leaf order (hikari_tpu's
    rule)."""
    from hikari_tpu_torch.models import mesh as shapes
    from hikari_tpu_torch.models.material import StandardMaterial
    from hikari_tpu_torch.models.scene import make_transform

    sc = build_cornell_box("hikari_tpu_torch")
    light = sc.add_material(StandardMaterial(emissive=(1.0, 1.0, 1.0, 1.0)))
    quad = sc.add_mesh(shapes.quad(0.1, 0.1))
    for i in range(9):
        sc.spawn(quad, light, make_transform((0.15 * i - 0.6, 0.5, 0.0)))
    r = ht.Renderer(sc, _camera(), _flagship(temporal_reuse=True),
                    device="cpu")
    assert r.gpu_scene.num_emissives == 10
    r.render_frame()
    sc.instances[-1].transform = make_transform((0.6, 0.7, 0.1))
    order = r.gpu_scene.arrays["em_leaf_order"]
    r.update_scene(sc, fast=True)
    assert r._refitter is None                  # the host refit
    assert r.gpu_scene.arrays["em_leaf_order"] is not order
    img = r.render(1)
    assert img.shape == (12, 16, 4) and np.isfinite(img).all()
    assert img[..., :3].max() > 0.0


def test_host_refit_raises():
    """The name is historical: the host refit no longer raises.
    update_scene(fast=True, device=False), hikari_tpu's host refit,
    refits on the host; the device refit and the recompile still
    serve."""
    from hikari_tpu_torch.examples import city

    sc = city.build_scene(0)
    r = ht.Renderer(sc, _camera(), ht.HikariSettings(), device="cpu")
    gpu = r.gpu_scene
    r.update_scene(city.rotate_sphere(sc, 0.1), fast=True, device=False)
    assert r.gpu_scene is not gpu and r._refitter is None
    np.testing.assert_array_equal(r.scene_dev["tri_pos_flat"].numpy(),
                                  r.gpu_scene.arrays["tri_pos_flat"])
    r.update_scene(city.rotate_sphere(sc, 0.2), fast=True)
    assert r._refitter is not None
    r.update_scene(city.build_scene(1), fast=False)
    assert r.gpu_scene.num_instances == 42 and r.tracer.kind == "cull"
    assert np.isfinite(r.render(1)).all()


def test_default_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ht.Renderer(build_cornell_box("hikari_tpu_torch"), _camera(),
                    _flagship())


class _FakeLibrary:
    """Stands in for a built kernel library: checks each call against the
    ctypes signature the wrapper declared, and records it."""

    def __init__(self):
        self.calls = []
        self.args = []

    def __getattr__(self, name):
        def fn(*args):
            assert len(args) == len(fn.argtypes), name
            for a, t in zip(args, fn.argtypes):
                want = {ctypes.c_int: int, ctypes.c_float: float,
                        ctypes.c_char_p: bytes}.get(t, ctypes.c_void_p)
                assert isinstance(a, want), (name, a)
            self.calls.append(name)
            self.args.append(args)
            return 0

        setattr(self, name, fn)
        return fn


def _gather_sources(args):
    """n_src of a gather launch's packed table (csrc/reproj_gather.cu
    GatherCall)."""
    from hikari_tpu_torch.ops import reproj_gather

    return reproj_gather.GATHER_TABLE.unpack(args[0])[12]


def _light_variant(args):
    """(temporal, validation, track_de, track_ind) of a lighting launch's
    packed table (csrc/light_fused.cu LightCall)."""
    from hikari_tpu_torch.ops import light_fused

    return light_fused.LIGHT_TABLE.unpack(args[0])[-4:]


def test_cuda_wrappers_marshal_and_count(monkeypatch):
    """The wrappers' CUDA branch, up to the C call: argument checks,
    ctypes signatures and launch counts of one frame (1, 1, 4)."""
    from hikari_tpu_torch import build
    from hikari_tpu_torch.ops import denoise_fused, light_fused, prepass_fused

    fake = _FakeLibrary()
    monkeypatch.setattr(build, "load_cuda", lambda name: fake)
    wrappers = (prepass_fused.prepass_kernel, light_fused.lighting_kernel,
                denoise_fused.atrous_level)
    for mod in (prepass_fused, light_fused, denoise_fused):
        monkeypatch.setattr(mod, "on_cpu", lambda t: False)
        monkeypatch.setattr(mod, "stream", lambda dev: ctypes.c_void_p(0))
    for fn in wrappers:
        monkeypatch.setattr(fn, "launches", 0)
    r = ht.Renderer(build_cornell_box("hikari_tpu_torch"), _camera(),
                    _flagship(), device="cpu")
    r.render_frame()
    assert fake.calls == (["hk_prepass_fused", "hk_light_fused"]
                          + ["hk_atrous_level"] * 4)
    assert [fn.launches for fn in wrappers] == [1, 1, 4]


@pytest.mark.parametrize("path", ["R", "S"])
def test_cuda_wrappers_marshal_and_count_with_reuse(monkeypatch, path):
    """The reuse paths' launches per frame: R gather 1, lighting 1,
    a-trous 4; S adds the spatial pass of the emissive and the indirect
    channel. The lighting variant follows the frame number: frame 0
    validates the emissive channel, frame 1 validates nothing."""
    from hikari_tpu_torch import build
    from hikari_tpu_torch.ops import (denoise_fused, light_fused,
                                      prepass_fused, reproj_gather,
                                      spatial_fused)

    fake = _FakeLibrary()
    monkeypatch.setattr(build, "load_cuda", lambda name: fake)
    mods = (prepass_fused, reproj_gather, light_fused, spatial_fused,
            denoise_fused)
    wrappers = (prepass_fused.prepass_kernel, reproj_gather.reproj_gather,
                light_fused.lighting_kernel, spatial_fused.spatial_kernel,
                denoise_fused.atrous_level)
    for mod in mods:
        monkeypatch.setattr(mod, "on_cpu", lambda t: False)
        monkeypatch.setattr(mod, "stream", lambda dev: ctypes.c_void_p(0))
    for fn in wrappers:
        monkeypatch.setattr(fn, "launches", 0)
    spatial = path == "S"
    r = ht.Renderer(build_cornell_box("hikari_tpu_torch"), _camera(),
                    dataclasses.replace(_flagship(), temporal_reuse=True,
                                        emissive_spatial_reuse=spatial,
                                        indirect_spatial_reuse=spatial),
                    device="cpu")
    variants = []
    for _ in range(2):
        fake.calls.clear()
        fake.args.clear()
        r.render_frame()
        assert fake.calls == (["hk_prepass_fused", "hk_reproj_gather",
                               "hk_light_fused"]
                              + ["hk_spatial_fused"] * (2 * spatial)
                              + ["hk_atrous_level"] * 4)
        assert _gather_sources(fake.args[1]) == (4 if spatial else 2)
        variants.append(_light_variant(fake.args[2]))
    assert variants == [(1, 1, int(spatial), int(spatial)),
                        (1, 0, int(spatial), int(spatial))]
    assert [fn.launches for fn in wrappers] == [2, 2, 2, 4 * spatial, 8]


@pytest.mark.parametrize("path", ["P", "D"])
def test_cuda_wrappers_marshal_and_count_with_post(monkeypatch, path):
    """The post paths' launches per frame. P (flagship + TAA + SMAA 2.0):
    prepass 1, quads 1, lighting 1, a-trous 4, then SMAA's tone warp,
    its G-buffer warp and TAA's warp. D (HikariSettings()) adds the
    gather (3 sources) and the indirect spatial pass, and its lighting is
    kernel 4 tracking the indirect channel only."""
    from hikari_tpu_torch import build
    from hikari_tpu_torch.ops import (denoise_fused, light_fused,
                                      prepass_fused, reproj_gather,
                                      spatial_fused, warp2, warp_band)

    fake = _FakeLibrary()
    monkeypatch.setattr(build, "load_cuda", lambda name: fake)
    mods = (prepass_fused, reproj_gather, light_fused, spatial_fused,
            denoise_fused, warp_band, warp2)
    wrappers = (prepass_fused.prepass_kernel,
                prepass_fused.prepass_quads_kernel,
                reproj_gather.reproj_gather, light_fused.lighting_kernel,
                spatial_fused.spatial_kernel, denoise_fused.atrous_level,
                warp_band.warp_band, warp2.warp_multi)
    for mod in mods:
        monkeypatch.setattr(mod, "on_cpu", lambda t: False)
        monkeypatch.setattr(mod, "stream", lambda dev: ctypes.c_void_p(0))
    for fn in wrappers:
        monkeypatch.setattr(fn, "launches", 0)
    default = path == "D"
    settings = ht.HikariSettings() if default else dataclasses.replace(
        _flagship(), taa=ht.Taa.JASMINE, upscale=ht.Upscale.smaa_tu4x(2.0))
    r = ht.Renderer(build_cornell_box("hikari_tpu_torch"), _camera(),
                    settings, device="cpu")
    variants = []
    for _ in range(2):
        fake.calls.clear()
        fake.args.clear()
        r.render_frame()
        assert fake.calls == (
            ["hk_prepass_fused", "hk_prepass_quads"]
            + ["hk_reproj_gather"] * default + ["hk_light_fused"]
            + ["hk_spatial_fused"] * default + ["hk_atrous_level"] * 4
            + ["hk_warp_band", "hk_warp_multi", "hk_warp_band"])
        _assert_warp_tables(fake, (12, 16))
        # kernel 8 reads kernel A's position, velocity_uv and ids planes of
        # this frame at the full size
        pre, quads = fake.args[0], fake.args[1]
        assert [a.value for a in quads[:3]] == [
            pre[i].value for i in (10, 13, 12)]
        assert quads[3:5] == (12, 16)
        if default:
            assert _gather_sources(fake.args[2]) == 3
            variants.append(_light_variant(fake.args[3]))
    if default:
        assert variants == [(1, 1, 0, 1), (1, 0, 0, 1)]
    assert [fn.launches for fn in wrappers] == [
        2, 2, 2 * default, 2, 2 * default, 8, 4, 2]


def _assert_warp_tables(fake, size):
    """The tables of one frame's post warps (csrc/warp.cu BandCall /
    MultiCall) at output `size` (SMAA 2.0: render size half of it): SMAA's
    tone fetch (nearest on the RGB of the 4-channel previous tone, render
    size), its G-buffer fetch (kernel 12: one bf16 nearest reduce over the
    4 channels of the full-size G-buffer, render size) and TAA's (Catmull-
    Rom on the RGB of the 4-channel history; nearest on 6 aux
    channels; full size)."""
    from hikari_tpu_torch.ops import warp2, warp_band
    from tests.test_torch_warp_launch import BAND_FIELDS, MULTI_FIELDS, decode

    h, w = size
    rh, rw = h // 2, w // 2
    tables = [a[0] for n, a in zip(fake.calls, fake.args)
              if n.startswith("hk_warp")]
    assert len(tables) == 3
    tone = decode(tables[0], warp_band.BAND_TABLE, BAND_FIELDS)
    multi = decode(tables[1], warp2.MULTI_TABLE, MULTI_FIELDS)
    taa = decode(tables[2], warp_band.BAND_TABLE, BAND_FIELDS)
    assert (tone["n_src"], tone["kind"][0], tone["f"][0],
            tone["stride"][0]) == (1, 0, 3, 4)
    assert (tone["h"], tone["w"], tone["hs"]) == (rh, rw, rh)
    assert (multi["n_red"], multi["kind"][0], multi["lo"][0],
            multi["hi"][0], multi["p"], multi["bf16"]) == (1, 0, 0, 4, 4, 1)
    assert (multi["h"], multi["w"], multi["hs"], multi["ws"]) == (rh, rw, h,
                                                                   w)
    assert (taa["n_src"], taa["kind"][:2], taa["f"][:2],
            taa["stride"][:2]) == (2, (2, 0), (3, 6), (4, 6))
    assert (taa["h"], taa["w"], taa["hs"]) == (h, w, h)
    assert all(t["blocks"] == 0 for t in (tone, taa))


# the tracer kernels' outputs, zeroed by the fake so that the frame indexes
# the attribute table in range: (index of the ray count n, floats per ray
# of each output that follows it)
_TRACE_OUTPUTS = {"hk_bvh_closest": (11, (1, 1, 1, 1, 1)),
                  "hk_bvh_full": (12, (1, 1, 3, 2, 1, 1)),
                  "hk_bvh_shadow": (11, (1, 1))}
# kernels 5, 6 and 7 take one packed table (csrc/trace.cu TraceCall) and
# write one allocation: floats per ray
_TRACE_TABLE_WORDS = {"hk_trace_closest": 5, "hk_trace_full": 9,
                      "hk_trace_shadow": 2}


def _trace_rays(name, args):
    """The ray count of a tracer kernel's launch."""
    if name in _TRACE_TABLE_WORDS:
        from hikari_tpu_torch.ops import trace_pallas

        return trace_pallas.TRACE_TABLE.unpack(args[0])[-1]
    return args[_TRACE_OUTPUTS[name][0]]


class _ZeroingLibrary(_FakeLibrary):
    """A fake library whose tracer kernels write zeros to their outputs."""

    def __getattr__(self, name):
        fn = super().__getattr__(name)
        if name in _TRACE_TABLE_WORDS:
            from hikari_tpu_torch.ops import trace_pallas

            def zeroing(*args):
                fn.argtypes = zeroing.argtypes
                rc = fn(*args)
                out, n = trace_pallas.TRACE_TABLE.unpack(args[0])[-3::2]
                ctypes.memset(out, 0, 4 * _TRACE_TABLE_WORDS[name] * n)
                return rc
        elif name in _TRACE_OUTPUTS:
            at, widths = _TRACE_OUTPUTS[name]

            def zeroing(*args):
                fn.argtypes = zeroing.argtypes
                rc = fn(*args)
                for k, width in enumerate(widths):
                    ctypes.memset(args[at + 1 + k], 0, 4 * width * args[at])
                return rc
        else:
            return fn

        setattr(self, name, zeroing)
        return zeroing


@pytest.mark.parametrize("path", ["K", "KR"])
def test_cuda_wrappers_marshal_and_count_with_checkerboard(monkeypatch,
                                                           path):
    """The checkerboard paths' launches per frame. K: prepass 1, kernel B
    1 over the compressed domain, a-trous 4. KR (the modular path, no sun
    on the box): the gather of 2 sources, then the emissive channel's
    probe (kernel 6) and shadow ray (kernel 7), once more each on its
    validation frames (frame 0 here), then the indirect bounce (kernel 5),
    its probe and its shadow ray, and a-trous 4."""
    from hikari_tpu_torch import build
    from hikari_tpu_torch.ops import (denoise_fused, light_fused,
                                      prepass_fused, reproj_gather,
                                      trace_pallas)

    fake = _ZeroingLibrary()
    monkeypatch.setattr(build, "load_cuda", lambda name: fake)
    mods = (prepass_fused, reproj_gather, light_fused, trace_pallas,
            denoise_fused)
    wrappers = (prepass_fused.prepass_kernel, reproj_gather.reproj_gather,
                light_fused.lighting_kernel, trace_pallas.trace_closest,
                trace_pallas.trace_full, trace_pallas.trace_shadow,
                denoise_fused.atrous_level)
    for mod in mods:
        monkeypatch.setattr(mod, "on_cpu", lambda t: False)
        monkeypatch.setattr(mod, "stream", lambda dev: ctypes.c_void_p(0))
    for fn in wrappers:
        monkeypatch.setattr(fn, "launches", 0)
    reuse = path == "KR"
    r = ht.Renderer(build_cornell_box("hikari_tpu_torch"), _camera(),
                    dataclasses.replace(_flagship(), temporal_reuse=reuse,
                                        checkerboard_lighting=True),
                    device="cpu")
    for validation in (True, False):
        fake.calls.clear()
        fake.args.clear()
        r.render_frame()
        if reuse:
            emissive = ["hk_trace_full", "hk_trace_shadow"] * (1 + validation)
            middle = (["hk_reproj_gather"] + emissive
                      + ["hk_trace_closest", "hk_trace_full",
                         "hk_trace_shadow"])
        else:
            middle = ["hk_light_fused"]
        assert fake.calls == (["hk_prepass_fused"] + middle
                              + ["hk_atrous_level"] * 4)
        if reuse:
            assert _gather_sources(fake.args[1]) == 2
        for name, a in zip(fake.calls, fake.args):
            if name in _TRACE_OUTPUTS or name in _TRACE_TABLE_WORDS:
                assert _trace_rays(name, a) == 12 * 16 // 2  # the lit half
    assert [fn.launches for fn in wrappers] == (
        [2, 2, 0, 2, 5, 5, 8] if reuse else [2, 0, 2, 0, 0, 0, 8])


def test_cuda_wrappers_marshal_and_count_on_the_city(monkeypatch):
    """The city's launches per frame at HikariSettings() (SMAA 2.0): the
    primary rays (kernel 13 full, the non-fused prepass), the gather of 3
    sources, the sun's shadow ray, the emissive channel's probe (kernel 13
    full: the 1,224-row emissive table is above kernel 6's 768) and shadow
    ray, the indirect bounce, its probe and shadow ray; the direct channel
    traces again on its validation frames (every 3rd), the emissive one on
    its own (every 5th; frame 0 validates both); a-trous 4 and the post
    warps. No kernel A, 8, B, 4, 10, 5, 6 or 7."""
    from hikari_tpu_torch import build
    from hikari_tpu_torch.examples import city
    from hikari_tpu_torch.ops import (denoise_fused, light_fused,
                                      prepass_fused, reproj_gather,
                                      spatial_fused, trace_cull,
                                      trace_pallas, warp2, warp_band)

    fake = _ZeroingLibrary()
    monkeypatch.setattr(build, "load_cuda", lambda name: fake)
    mods = (prepass_fused, reproj_gather, light_fused, spatial_fused,
            trace_pallas, trace_cull, denoise_fused, warp_band, warp2)
    wrappers = (prepass_fused.prepass_kernel,
                prepass_fused.prepass_quads_kernel,
                reproj_gather.reproj_gather, light_fused.lighting_kernel,
                spatial_fused.spatial_kernel, trace_pallas.trace_closest,
                trace_pallas.trace_full, trace_pallas.trace_shadow,
                trace_cull.bvh_closest, trace_cull.bvh_full,
                trace_cull.bvh_shadow, denoise_fused.atrous_level,
                warp_band.warp_band, warp2.warp_multi)
    for mod in mods:
        monkeypatch.setattr(mod, "on_cpu", lambda t: False)
        monkeypatch.setattr(mod, "stream", lambda dev: ctypes.c_void_p(0))
    for fn in wrappers:
        monkeypatch.setattr(fn, "launches", 0)
    cam = ht.Camera.from_look_at((0.0, 2.5, 20.0), (0.0, 0.0, 0.0),
                                 width=16, height=12, hdr=True)
    sc = city.build_scene(3)
    r = ht.Renderer(sc, cam, ht.HikariSettings(), device="cpu")
    for validation in (True, False):
        fake.calls.clear()
        fake.args.clear()
        if not validation:
            r.update_scene(city.rotate_sphere(sc, 0.2 / 60.0), fast=True)
        r.render_frame()
        v = int(validation)
        assert fake.calls == (
            ["hk_bvh_full", "hk_reproj_gather"]
            + ["hk_bvh_shadow"] * (1 + v)
            + ["hk_bvh_full", "hk_bvh_shadow"] * (1 + v)
            + ["hk_bvh_full", "hk_bvh_full", "hk_bvh_shadow"]
            + ["hk_atrous_level"] * 4
            + ["hk_warp_band", "hk_warp_multi", "hk_warp_band"])
        assert fake.args[0][12] == 12 * 16                # primary rays
        assert _gather_sources(fake.args[1]) == 3
        _assert_warp_tables(fake, (12, 16))
        for name, a in zip(fake.calls[2:], fake.args[2:]):
            if name.startswith("hk_bvh"):                 # at 6x8
                assert a[_TRACE_OUTPUTS[name][0]] == 6 * 8
    assert [fn.launches for fn in wrappers] == [
        0, 0, 2, 0, 0, 0, 0, 0, 0, 9, 8, 8, 4, 2]


def test_cuda_wrappers_marshal_and_count_on_path_cl(monkeypatch):
    """Path CL's launches per frame (the city with 16 street lamps, 17
    emissives, HikariSettings() with BloomSettings(); chip_smoke.py
    cl_launches): the city's sequence. Every update_scene(fast=True) is
    the host refit and launches nothing, the emissive BVH walk and bloom
    are tensor ops; the probes (kernel 13 full: the 1,416-row emissive
    table is above kernel 6's 768) each go to their emitter's subtree."""
    from hikari_tpu_torch import build
    from hikari_tpu_torch.ops import (denoise_fused, light_fused,
                                      prepass_fused, reproj_gather,
                                      spatial_fused, trace_cull,
                                      trace_pallas, warp2, warp_band)
    from hikari_tpu_torch.ops.bloom import BloomSettings
    from tests.city_lamps import build_city_lamps, city_module

    fake = _ZeroingLibrary()
    monkeypatch.setattr(build, "load_cuda", lambda name: fake)
    mods = (prepass_fused, reproj_gather, light_fused, spatial_fused,
            trace_pallas, trace_cull, denoise_fused, warp_band, warp2)
    wrappers = (reproj_gather.reproj_gather, trace_cull.bvh_full,
                trace_cull.bvh_shadow, denoise_fused.atrous_level,
                warp_band.warp_band, warp2.warp_multi)
    for mod in mods:
        monkeypatch.setattr(mod, "on_cpu", lambda t: False)
        monkeypatch.setattr(mod, "stream", lambda dev: ctypes.c_void_p(0))
    for fn in wrappers:
        monkeypatch.setattr(fn, "launches", 0)
    cam = ht.Camera.from_look_at((0.0, 2.5, 20.0), (0.0, 0.0, 0.0),
                                 width=16, height=12, hdr=True)
    sc = build_city_lamps("hikari_tpu_torch")
    r = ht.Renderer(sc, cam, ht.HikariSettings(), device="cpu",
                    bloom_settings=BloomSettings())
    assert r.gpu_scene.num_emissives == 17
    assert r.scene_dev["em_tri_pos_flat"].shape[0] == 1416
    city = city_module("hikari_tpu_torch")
    for validation in (True, False):
        fake.calls.clear()
        fake.args.clear()
        if not validation:
            r.update_scene(city.rotate_sphere(sc, 0.2 / 60.0), fast=True)
            assert r._refitter is None and fake.calls == []
        r.render_frame()
        v = int(validation)
        assert fake.calls == (
            ["hk_bvh_full", "hk_reproj_gather"]
            + ["hk_bvh_shadow"] * (1 + v)
            + ["hk_bvh_full", "hk_bvh_shadow"] * (1 + v)
            + ["hk_bvh_full", "hk_bvh_full", "hk_bvh_shadow"]
            + ["hk_atrous_level"] * 4
            + ["hk_warp_band", "hk_warp_multi", "hk_warp_band"])
        assert _gather_sources(fake.args[1]) == 3
        _assert_warp_tables(fake, (12, 16))
    assert [fn.launches for fn in wrappers] == [2, 9, 8, 8, 4, 2]


def test_cuda_wrappers_marshal_and_count_on_path_f(monkeypatch):
    """Path F's launches per frame (the scene of examples/scene.py at its
    settings: 4 bounces, FSR 1.0 at ratio 2): the city's sequence with the
    bounce, its probe and its shadow ray 4 times, then a-trous 4 and TAA's
    warp at the render size; FSR itself launches no kernel of the port's.
    No kernel A, 8, B, 4, 10, 5, 6, 7 or 12."""
    from hikari_tpu_torch import build
    from hikari_tpu_torch.examples import scene
    from hikari_tpu_torch.ops import (denoise_fused, light_fused,
                                      prepass_fused, reproj_gather,
                                      spatial_fused, trace_cull,
                                      trace_pallas, warp2, warp_band)
    from tests.test_torch_warp_launch import BAND_FIELDS, decode

    fake = _ZeroingLibrary()
    monkeypatch.setattr(build, "load_cuda", lambda name: fake)
    mods = (prepass_fused, reproj_gather, light_fused, spatial_fused,
            trace_pallas, trace_cull, denoise_fused, warp_band, warp2)
    for mod in mods:
        monkeypatch.setattr(mod, "on_cpu", lambda t: False)
        monkeypatch.setattr(mod, "stream", lambda dev: ctypes.c_void_p(0))
    cam = ht.Camera.from_look_at(scene.EYE, scene.TARGET, width=16,
                                 height=12)
    r = ht.Renderer(scene.build_scene(), cam, scene.settings(),
                    device="cpu")
    for number in range(2):       # frame 0 validates both direct channels
        fake.calls.clear()
        fake.args.clear()
        r.render_frame()
        v = int(number == 0)
        assert fake.calls == (
            ["hk_bvh_full", "hk_reproj_gather"]
            + ["hk_bvh_shadow"] * (1 + v)
            + ["hk_bvh_full", "hk_bvh_shadow"] * (1 + v)
            + ["hk_bvh_full", "hk_bvh_full", "hk_bvh_shadow"] * 4
            + ["hk_atrous_level"] * 4 + ["hk_warp_band"])
        assert fake.args[0][12] == 12 * 16                # primary rays
        assert _gather_sources(fake.args[1]) == 3
        for name, a in zip(fake.calls[2:], fake.args[2:]):
            if name.startswith("hk_bvh"):                 # at 6x8
                assert a[_TRACE_OUTPUTS[name][0]] == 6 * 8
        # TAA's fetch at the 6x8 render size (the history's size)
        taa = decode(fake.args[-1][0], warp_band.BAND_TABLE, BAND_FIELDS)
        assert (taa["h"], taa["w"], taa["hs"]) == (6, 8, 6)
        assert r.carry["prev_taa"].shape == (6, 8, 4)


def _gbuf_planes(h, w):
    return (torch.zeros((h, w, 4)), torch.zeros((h, w, 4)),
            torch.zeros((h, w, 2)))


def _quads_bad_input(case):
    pos, vel, ids = _gbuf_planes(12, 16)
    if case == "non-contiguous":
        pos = torch.zeros((12, 4, 16)).permute(0, 2, 1)
    elif case == "mis-shaped":
        vel = torch.zeros((12, 16, 2))
    elif case == "odd size":
        pos, vel, ids = _gbuf_planes(11, 16)
    elif case == "misaligned":
        ids = torch.zeros(12 * 16 * 2 + 1)[1:].view(12, 16, 2)
    return pos, vel, ids


@pytest.mark.parametrize("case", ["non-contiguous", "mis-shaped",
                                  "odd size", "misaligned"])
def test_quads_wrapper_rejects_bad_planes(monkeypatch, case):
    """Kernel 8's CUDA branch raises on a plane the kernel does not take,
    before any launch; the same call with good planes launches once."""
    from hikari_tpu_torch import build
    from hikari_tpu_torch.ops import prepass_fused

    fake = _FakeLibrary()
    monkeypatch.setattr(build, "load_cuda", lambda name: fake)
    monkeypatch.setattr(prepass_fused, "on_cpu", lambda t: False)
    monkeypatch.setattr(prepass_fused, "stream",
                        lambda dev: ctypes.c_void_p(0))
    monkeypatch.setattr(prepass_fused.prepass_quads_kernel, "launches", 0)
    with pytest.raises(ValueError):
        prepass_fused.prepass_quads_kernel(*_quads_bad_input(case))
    assert fake.calls == []
    depth, vel, inst = prepass_fused.prepass_quads_kernel(
        *_gbuf_planes(12, 16))
    assert fake.calls == ["hk_prepass_quads"]
    assert fake.args[0][3:5] == (12, 16)
    assert (depth.shape, vel.shape, inst.shape) == ((4, 6, 8), (4, 6, 8, 2),
                                                    (4, 6, 8))
    assert prepass_fused.prepass_quads_kernel.launches == 1


def test_cuda_wrappers_marshal_row_blocks(monkeypatch):
    """A row block's arguments reach the C calls: kernel A's first image
    row in its parameters (params[_P_ROW0], beside the image's size) with
    the block's rows as the launch size, and kernel C's first image row
    and image rows after the block's size; the whole image's calls pass
    row 0 and the planes' own rows."""
    from hikari_tpu_torch import build
    from hikari_tpu_torch.camera import view_to_device
    from hikari_tpu_torch.ops import denoise_fused, prepass_fused

    fake = _FakeLibrary()
    monkeypatch.setattr(build, "load_cuda", lambda name: fake)
    for mod in (prepass_fused, denoise_fused):
        monkeypatch.setattr(mod, "on_cpu", lambda t: False)
        monkeypatch.setattr(mod, "stream", lambda dev: ctypes.c_void_p(0))
    scene = build_cornell_box("hikari_tpu_torch").compile().as_pytree("cpu")
    tables = (scene["tri_pos_flat"], scene["tri_attr"], scene["inst_motion"],
              scene["mat_packed"])
    view = view_to_device(_camera().view_uniform(), "cpu")
    for row0, rows in ((0, 12), (6, 4)):
        params = prepass_fused.pack_params(view, view, (0.0, 0.0), (12, 16),
                                           row0=row0)
        assert params.shape == (prepass_fused._P_COUNT,)
        assert params[prepass_fused._P_ROW0] == row0
        assert params[prepass_fused._P_WH:prepass_fused._P_WH + 2] \
            .tolist() == [16.0, 12.0]
        prepass_fused.prepass_kernel(params, *tables, (rows, 16))
        assert fake.calls[-1] == "hk_prepass_fused"
        args = fake.args[-1]
        assert args[0].value == params.data_ptr()
        assert args[8:10] == (rows, 16)
    irr = torch.zeros((3, 40, 8), dtype=torch.bfloat16)
    geo = torch.zeros((3, 40, 8), dtype=torch.bfloat16)
    f32s = torch.zeros((5, 40, 8))
    for kw, want in (({}, (0, 40)), (dict(row0=-16, rows=42), (-16, 42))):
        denoise_fused.atrous_level(irr, geo, f32s, step=8, nch=1,
                                   ffs=(True,), **kw)
        assert fake.calls[-1] == "hk_atrous_level"
        # nch, firefly mask, step, h, w, row0, rows
        assert fake.args[-1][3:10] == (1, 1, 8, 40, 8) + want


def test_cuda_wrapper_rejects_bad_arguments(monkeypatch):
    from hikari_tpu_torch.ops import denoise_fused

    monkeypatch.setattr(denoise_fused, "on_cpu", lambda t: False)
    irr = torch.zeros((6, 4, 4), dtype=torch.float32)    # not bf16
    geo = torch.zeros((4, 4, 4), dtype=torch.bfloat16)
    f32s = torch.zeros((5, 4, 4))
    with pytest.raises(TypeError):
        denoise_fused.atrous_level(irr, geo, f32s, step=1, nch=2,
                                   ffs=(True, True))


@pytest.mark.parametrize("step", [0, 3, 16])
def test_atrous_wrapper_rejects_a_step_it_cannot_stage(monkeypatch, step):
    """Kernel C has an instance for each step of the cascade: its CUDA
    branch takes the steps of KERNEL_STEPS and raises on others before any
    launch."""
    from hikari_tpu_torch import build
    from hikari_tpu_torch.ops import denoise_fused

    fake = _FakeLibrary()
    monkeypatch.setattr(build, "load_cuda", lambda name: fake)
    monkeypatch.setattr(denoise_fused, "on_cpu", lambda t: False)
    irr = torch.zeros((6, 4, 4), dtype=torch.bfloat16)
    geo = torch.zeros((4, 4, 4), dtype=torch.bfloat16)
    f32s = torch.zeros((5, 4, 4))
    with pytest.raises(ValueError, match="step"):
        denoise_fused.atrous_level(irr, geo, f32s, step=step, nch=2,
                                   ffs=(True, False))
    assert fake.calls == []


def _sample_call(args):
    """The fields of a kernel 14 launch's packed table (csrc/texture.cu
    SampleCall): {out, n, n_slots, n_rect, slots}."""
    from hikari_tpu_torch.ops import texture_pallas

    v = texture_pallas.SAMPLE_TABLE.unpack(args[0])
    return dict(out=v[4], n=v[5], n_rect=v[8], n_slots=v[9],
                slots=v[10:10 + v[9]])


class _TextureZeroingLibrary(_ZeroingLibrary):
    """The zeroing fake whose texture sampler writes zeros too."""

    def __getattr__(self, name):
        fn = super().__getattr__(name)
        if name != "hk_sample_atlas":
            return fn

        def zeroing(*args):
            fn.argtypes = zeroing.argtypes
            rc = fn(*args)
            call = _sample_call(args)
            ctypes.memset(call["out"], 0, 16 * call["n"] * call["n_slots"])
            return rc

        setattr(self, name, zeroing)
        return zeroing


def test_textured_box_takes_the_modular_path(monkeypatch):
    """A small textured scene (the 36-triangle box, a texture on one wall)
    with temporal reuse: hikari_tpu's gates and the port's keep it off
    kernels A and B / 4; it takes the non-fused prepass over kernel 5 and
    the modular path over kernels 5, 6 and 7, and kernel 14 samples the one
    textured slot (base colour) once a frame: at ratio 1 the full-size
    G-buffer is the lighting domain, so one surface serves the albedo, the
    channels and the direct term."""
    import jax.numpy as jnp

    from hikari_tpu.ops import light_fused as lf_ref
    from hikari_tpu.ops import prepass_fused as pf_ref
    from hikari_tpu_torch import build, frame
    from hikari_tpu_torch.ops import (denoise_fused, light_fused,
                                      prepass_fused, reproj_gather,
                                      texture_pallas, trace_pallas)

    settings = _flagship(temporal_reuse=True)
    ref = _textured(build_cornell_box("hikari_tpu"), "hikari_tpu").compile()
    sj = {k: jnp.asarray(v) for k, v in ref.arrays.items()}
    ref_gates = (
        pf_ref.prepass_fused_eligible(sj, no_texture=False,
                                      tracer_kind="brute_force_pallas"),
        lf_ref.fused_eligible(sj, no_texture=False, num_emissives=1,
                              temporal_reuse=True, track_de=False,
                              track_ind=False,
                              tracer_kind="brute_force_pallas",
                              has_sun=False))
    gpu = _textured(build_cornell_box("hikari_tpu_torch")).compile()
    scene = gpu.as_pytree("cpu")
    assert gpu.num_textures == 1 and gpu.num_triangles < 768
    port_gates = (
        frame.prepass_fused_eligible(scene, no_texture=False,
                                     tracer_kind="brute_force_pallas"),
        frame.fused_eligible(scene, no_texture=False, num_emissives=1,
                             temporal_reuse=True, track_de=False,
                             track_ind=False,
                             tracer_kind="brute_force_pallas",
                             has_sun=False, bounces=1, ckb=False))
    assert port_gates == ref_gates == (False, False)
    # the same box untextured takes both kernels
    assert frame.prepass_fused_eligible(scene, no_texture=True,
                                        tracer_kind="brute_force_pallas")

    fake = _TextureZeroingLibrary()
    monkeypatch.setattr(build, "load_cuda", lambda name: fake)
    mods = (prepass_fused, reproj_gather, light_fused, trace_pallas,
            texture_pallas, denoise_fused)
    wrappers = (prepass_fused.prepass_kernel, reproj_gather.reproj_gather,
                light_fused.lighting_kernel, trace_pallas.trace_closest,
                trace_pallas.trace_full, trace_pallas.trace_shadow,
                texture_pallas.sample_atlas_slots,
                denoise_fused.atrous_level)
    for mod in mods:
        monkeypatch.setattr(mod, "on_cpu", lambda t: False)
        monkeypatch.setattr(mod, "stream", lambda dev: ctypes.c_void_p(0))
    for fn in wrappers:
        monkeypatch.setattr(fn, "launches", 0)
    r = ht.Renderer(gpu, _camera(), settings, device="cpu")
    for validation in (True, False):
        fake.calls.clear()
        fake.args.clear()
        r.render_frame()
        emissive = ["hk_trace_full", "hk_trace_shadow"] * (1 + validation)
        assert fake.calls == (
            ["hk_trace_closest", "hk_sample_atlas", "hk_reproj_gather"]
            + emissive
            + ["hk_trace_closest", "hk_trace_full", "hk_trace_shadow"]
            + ["hk_atrous_level"] * 4)
        for name, a in zip(fake.calls, fake.args):
            if name == "hk_sample_atlas":
                call = _sample_call(a)
                assert (call["n"], call["n_rect"], call["slots"]) == (
                    12 * 16, 1, (0,))
    assert [fn.launches for fn in wrappers] == [0, 2, 0, 4, 5, 5, 2, 8]


def test_cuda_wrappers_marshal_and_count_on_path_t(monkeypatch):
    """Path T's launches per frame (the textured simple scene at the
    example's settings: HikariSettings() with emissive spatial reuse):
    the city's kernel 13 calls (the two spheres' 2,436-row emissive table
    is above kernel 6's 768), the gather of 3 sources, and kernel 14 once
    for the full-size G-buffer's surface (the albedo) and once for the
    lighting domain's (the channels and the spatial passes), each launch
    sampling both textured slots (base colour, emissive). No kernel A, 8,
    B, 4, 10, 5, 6 or 7."""
    from hikari_tpu_torch import build
    from hikari_tpu_torch.examples import simple
    from hikari_tpu_torch.ops import (denoise_fused, light_fused,
                                      prepass_fused, reproj_gather,
                                      spatial_fused, texture_pallas,
                                      trace_cull, trace_pallas, warp2,
                                      warp_band)

    fake = _TextureZeroingLibrary()
    monkeypatch.setattr(build, "load_cuda", lambda name: fake)
    mods = (prepass_fused, reproj_gather, light_fused, spatial_fused,
            trace_pallas, trace_cull, texture_pallas, denoise_fused,
            warp_band, warp2)
    wrappers = (prepass_fused.prepass_kernel,
                prepass_fused.prepass_quads_kernel,
                reproj_gather.reproj_gather, light_fused.lighting_kernel,
                spatial_fused.spatial_kernel, trace_pallas.trace_closest,
                trace_pallas.trace_full, trace_pallas.trace_shadow,
                trace_cull.bvh_closest, trace_cull.bvh_full,
                trace_cull.bvh_shadow, denoise_fused.atrous_level,
                warp_band.warp_band, warp2.warp_multi,
                texture_pallas.sample_atlas_slots)
    for mod in mods:
        monkeypatch.setattr(mod, "on_cpu", lambda t: False)
        monkeypatch.setattr(mod, "stream", lambda dev: ctypes.c_void_p(0))
    for fn in wrappers:
        monkeypatch.setattr(fn, "launches", 0)
    cam = ht.Camera.from_look_at(simple.EYE, simple.TARGET, width=16,
                                 height=12)
    r = ht.Renderer(simple.build_scene(simple.procedural_earth(0)), cam,
                    simple.settings(), device="cpu")
    for validation in (True, False):
        fake.calls.clear()
        fake.args.clear()
        r.render_frame()
        v = int(validation)
        assert fake.calls == (
            ["hk_bvh_full", "hk_sample_atlas", "hk_reproj_gather",
             "hk_sample_atlas"]
            + ["hk_bvh_shadow"] * (1 + v)
            + ["hk_bvh_full", "hk_bvh_shadow"] * (1 + v)
            + ["hk_bvh_full", "hk_bvh_full", "hk_bvh_shadow"]
            + ["hk_atrous_level"] * 4
            + ["hk_warp_band", "hk_warp_multi", "hk_warp_band"])
        assert _gather_sources(fake.args[2]) == 3
        _assert_warp_tables(fake, (12, 16))
        atlas = [a for n, a in zip(fake.calls, fake.args)
                 if n == "hk_sample_atlas"]
        assert [(_sample_call(a)["n"], _sample_call(a)["slots"])
                for a in atlas] == [(12 * 16, (0, 1)), (6 * 8, (0, 1))]
    assert [fn.launches for fn in wrappers] == [
        0, 0, 2, 0, 0, 0, 0, 0, 0, 9, 8, 8, 4, 2, 4]


def test_cuda_wrappers_marshal_and_count_on_path_tn(monkeypatch):
    """Path TN's launches per frame (path T's scene at the flagship
    settings: the modular path without reuse, chip_smoke.py
    simple_noreuse_launches): kernel 13 full for the primary rays, the
    emissive probe, the bounce and its probe, 13 shadow for the sun, the
    emissive channel and the bounce's NEE, kernel 14 once (at ratio 1 one
    surface serves the albedo and the channels, both textured slots), and
    the four a-trous levels; no gather and no validation frames."""
    from hikari_tpu_torch import build
    from hikari_tpu_torch.examples import simple
    from hikari_tpu_torch.ops import (denoise_fused, texture_pallas,
                                      trace_cull)

    fake = _TextureZeroingLibrary()
    monkeypatch.setattr(build, "load_cuda", lambda name: fake)
    wrappers = (trace_cull.bvh_full, trace_cull.bvh_shadow,
                texture_pallas.sample_atlas_slots,
                denoise_fused.atrous_level)
    for mod in (trace_cull, texture_pallas, denoise_fused):
        monkeypatch.setattr(mod, "on_cpu", lambda t: False)
        monkeypatch.setattr(mod, "stream", lambda dev: ctypes.c_void_p(0))
    for fn in wrappers:
        monkeypatch.setattr(fn, "launches", 0)
    cam = ht.Camera.from_look_at(simple.EYE, simple.TARGET, width=16,
                                 height=12)
    r = ht.Renderer(simple.build_scene(simple.procedural_earth(0)), cam,
                    _flagship(), device="cpu")
    for _ in range(2):
        fake.calls.clear()
        fake.args.clear()
        r.render_frame()
        assert fake.calls == (
            ["hk_bvh_full", "hk_sample_atlas", "hk_bvh_shadow",
             "hk_bvh_full", "hk_bvh_shadow", "hk_bvh_full", "hk_bvh_full",
             "hk_bvh_shadow"] + ["hk_atrous_level"] * 4)
        atlas = [a for n, a in zip(fake.calls, fake.args)
                 if n == "hk_sample_atlas"]
        assert [(_sample_call(a)["n"], _sample_call(a)["slots"])
                for a in atlas] == [(12 * 16, (0, 1))]
    assert [fn.launches for fn in wrappers] == [8, 6, 2, 8]
