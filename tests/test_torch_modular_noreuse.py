"""The modular lighting path without temporal reuse and the spatial tap
scramble: hikari_tpu_torch's direct_lit (the sun and the emissive
channel) and indirect_lit_ambient (one bounce) with temporal_reuse=False
against hikari_tpu's, on two scenes that take the modular path at the
flagship settings:

* the box with a sun plus a uv_sphere (1,260 triangles, above the fused
  lighting kernel's 768): the port's tracer is kernel 13's plain walk,
  hikari_tpu's its CPU walk without the any-hit early exit
  (tests/test_torch_modular_spatial.py NearestWalk);
* the box with a sun and a seeded texture on its red wall (the fused
  kernels fetch no textures): the port's tracer is kernels 5, 6 and 7's
  plain versions, hikari_tpu's its Pallas engine in interpret mode
  (tests/test_torch_modular.py PallasTracer), its compiled arrays without
  the bf16 atlas layouts (tests/test_torch_texture.py reference_arrays).

On the port's G-buffer (its non-fused prepass), both in hikari_tpu's static
no-reuse specialization and, with spatial tracking, in its general branch
on the empty previous reservoir (no validation re-trace); then
spatial_reuse with per-pixel scramble bits on carried reservoirs.

Bars: render and variance within rtol 1e-2 / atol 1e-3 on >= 99% of
pixels (tests/test_torch_modular.py assert_fields); the no-reuse
specialization's zero variance and empty reservoir equal bit for bit; the
tracked branch's reservoir and scattered buffer at the same field bar (the
buffer on the pixels no two scatter sources target); the scramble's picks
of the rolled temporal reservoirs (where hikari_tpu only selects) equal
bit for bit, tap by tap, and its outputs within rtol 1e-5 / atol 1e-6 on
>= 99% of values (f32 round-off)."""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hikari_tpu.ops import reservoir as rsv_ref
from hikari_tpu.ops import restir as restir_ref
from hikari_tpu_torch.camera import view_to_device
from hikari_tpu_torch.ops import prepass, restir
from hikari_tpu_torch.ops import reservoir as rsv
from hikari_tpu_torch.ops.trace import make_tracer
from tests.cornell_box import EYE, TARGET, build_cornell_box
from tests.test_torch_modular import PallasTracer, assert_fields, carried, t
from tests.test_torch_modular_spatial import (SIZE, NearestWalk,
                                              _assert_spatial_close, _frames,
                                              _jg, _packed, _reproj,
                                              _single_targets)
from tests.test_torch_texture import reference_arrays
from tests.torch_threads import one_torch_thread  # noqa: F401


def sunny_box(pkg):
    import importlib

    sc = build_cornell_box(pkg)
    mod = importlib.import_module(f"{pkg}.models.scene")
    sc.directional_light = mod.DirectionalLight(
        illuminance=10000.0, direction=(0.25, -0.5, -1.0))
    return sc


def with_sphere(pkg):
    """The sunny box plus a default uv_sphere (1,224 triangles)."""
    import importlib

    shapes = importlib.import_module(f"{pkg}.models.mesh")
    scene = importlib.import_module(f"{pkg}.models.scene")
    sc = sunny_box(pkg)
    sc.spawn(sc.add_mesh(shapes.uv_sphere()), 0,
             scene.make_transform((0.0, 0.3, 0.0), scale=(0.2, 0.2, 0.2)))
    return sc


def textured(pkg, sun=True):
    """The box (with a sun unless `sun` is False) with a seeded 24x40
    texture on its red left wall (tests/test_torch_boundary.py
    _textured)."""
    import importlib

    material = importlib.import_module(f"{pkg}.models.material")
    sc = sunny_box(pkg) if sun else build_cornell_box(pkg)
    data = np.random.default_rng(8).integers(0, 256, (24, 40, 4), np.uint8)
    sc.materials[1].base_color_texture = material.Texture(data)
    return sc


SCENES = {"sphere": (with_sphere, NearestWalk),
          "textured": (textured, PallasTracer)}


@functools.lru_cache(maxsize=None)
def inputs(name):
    """(port scene, its tracer, reference scene, reference tracer, the
    port's G-buffer as numpy, view, reference view, no_texture) at SIZE;
    the previous view offset, so pixels reproject."""
    build, ref_tracer = SCENES[name]
    got = build("hikari_tpu_torch").compile()
    ref = build("hikari_tpu").compile()
    h, w = SIZE
    views = []
    for pkg in ("hikari_tpu_torch", "hikari_tpu"):
        cam_t = __import__(pkg).Camera
        views.append((cam_t.from_look_at(EYE, TARGET, width=w, height=h)
                      .view_uniform(),
                      cam_t.from_look_at(np.add(EYE, (0.1, 0.05, 0.0)),
                                         TARGET, width=w, height=h)
                      .view_uniform()))
    (view, prev), (view_r, _) = views
    scene = got.as_pytree("cpu")
    tracer = make_tracer(got.num_triangles)
    gbuf = prepass.prepass(scene, tracer, view_to_device(view, "cpu"),
                           view_to_device(prev, "cpu"), (0.0, 0.0), SIZE)
    g = {k: v.numpy() for k, v in gbuf.items()}
    scene_j = {k: jnp.asarray(v) for k, v in reference_arrays(ref).items()
               if not k.startswith("cl_")}
    assert (g["position"][..., 3] > 0).mean() > 0.5
    return (scene, tracer, scene_j, ref_tracer(), g,
            view_to_device(view, "cpu"),
            {k: jnp.asarray(v) for k, v in view_r.items()},
            got.num_textures == 0)


def _assert_empty(r, what):
    """Every field of the empty reservoir, bit for bit."""
    empty = rsv.empty_reservoir(SIZE)
    for k, v in empty.items():
        a = r[k].numpy() if torch.is_tensor(r[k]) else np.asarray(r[k])
        np.testing.assert_array_equal(a, v.numpy(), err_msg=f"{what} {k}")


def _assert_no_reuse(got, ref, what):
    assert_fields({"render": got["render"]}, {"render": ref["render"]}, what)
    assert float(got["render"][..., :3].abs().sum()) > 0.0, what
    for v in (got["variance"].numpy(), np.asarray(ref["variance"])):
        np.testing.assert_array_equal(v, np.zeros(SIZE, np.float32))
    _assert_empty(got["temporal"], f"{what} port")
    _assert_empty(ref["temporal"], f"{what} reference")


@pytest.mark.parametrize("scene", sorted(SCENES))
@pytest.mark.parametrize("channel", ["sun", "emissive"])
def test_direct_lit_without_reuse(scene, channel):
    """hikari_tpu's static no-reuse specialization (restir.py:332-382):
    plain NEE through the shadow ray, zero variance, the empty
    reservoir."""
    s, tracer, s_j, tracer_r, g, view, view_r, no_tex = inputs(scene)
    rand = np.random.default_rng(5).random(SIZE + (4,), dtype=np.float32)
    f, f_r = _frames(5)
    kw = dict(emissive_lit=channel == "emissive", temporal_reuse=False,
              no_texture=no_tex, render_size=SIZE, track_spatial=False)
    ref = restir_ref.direct_lit(
        s_j, tracer_r, _jg(g), view_r, f_r, jnp.asarray(rand), None,
        rsv_ref.empty_reservoir(SIZE), None, **kw)
    got = restir.direct_lit(s, tracer, {k: t(v) for k, v in g.items()}, view,
                            f, t(rand), rsv.empty_reservoir(SIZE), **kw)
    _assert_no_reuse(got, ref, f"direct_lit {scene} {channel}")


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_indirect_lit_ambient_without_reuse(scene):
    """hikari_tpu's no-reuse specialization of the bounce
    (restir.py:631-643): the shaded sample over its pdf."""
    s, tracer, s_j, tracer_r, g, view, view_r, no_tex = inputs(scene)
    rand = np.random.default_rng(7).random(SIZE + (4,), dtype=np.float32)
    f, f_r = _frames(7)
    kw = dict(bounces=1, temporal_reuse=False, no_texture=no_tex,
              render_size=SIZE, track_spatial=False)
    ref = restir_ref.indirect_lit_ambient(
        s_j, tracer_r, _jg(g), view_r, f_r, jnp.asarray(rand), None,
        rsv_ref.empty_reservoir(SIZE), None, **kw)
    got = restir.indirect_lit_ambient(
        s, tracer, {k: t(v) for k, v in g.items()}, view, f, t(rand),
        rsv.empty_reservoir(SIZE), **kw)
    _assert_no_reuse(got, ref, f"indirect_lit_ambient {scene}")


@pytest.mark.parametrize("channel", ["emissive", "indirect"])
def test_spatial_tracking_without_temporal_reuse(channel):
    """Spatial reuse without temporal reuse: the general branch on the
    empty previous reservoir, scattering into a carried spatial buffer, on
    frame 0 (a validation frame of both direct channels, whose re-trace
    hikari_tpu skips statically without temporal reuse,
    restir.py:437-445)."""
    s, tracer, s_j, tracer_r, g, view, view_r, no_tex = inputs("sphere")
    rng = np.random.default_rng(13)
    spatial = carried(g, rng, keep=0.6)
    rand = rng.random(SIZE + (4,), dtype=np.float32)
    reproj, reproj_r = _reproj(g)
    f, f_r = _frames(0)
    args_r = (s_j, tracer_r, _jg(g), view_r, f_r, jnp.asarray(rand),
              reproj_r, rsv_ref.empty_reservoir(SIZE),
              jnp.asarray(_packed(spatial)))
    args = (s, tracer, {k: t(v) for k, v in g.items()}, view, f, t(rand),
            rsv.empty_reservoir(SIZE))
    kw = dict(temporal_reuse=False, no_texture=no_tex, render_size=SIZE,
              track_spatial=True)
    prev_spatial = rsv.pack_reservoir_planes(
        {k: t(v) for k, v in spatial.items()})
    if channel == "emissive":
        ref = restir_ref.direct_lit(*args_r, emissive_lit=True, **kw)
        got = restir.direct_lit(*args, emissive_lit=True, reproj=reproj,
                                prev_spatial=prev_spatial, **kw)
    else:
        ref = restir_ref.indirect_lit_ambient(*args_r, bounces=1, **kw)
        got = restir.indirect_lit_ambient(*args, bounces=1, reproj=reproj,
                                          prev_spatial=prev_spatial, **kw)
    assert_fields({"render": got["render"], "variance": got["variance"]},
                  {"render": ref["render"], "variance": ref["variance"]},
                  f"{channel} tracked")
    assert_fields(got["temporal"], ref["temporal"], f"{channel} rsv")
    assert got["temporal"]["count"].max() == 1.0
    _assert_spatial_close(got["prev_spatial"], ref["prev_spatial_packed"],
                          _single_targets(reproj), f"{channel} spatial")


def _capture(monkeypatch, module, name, into, traced=False):
    """Record every argument `module.name` is called with (through an
    ordered host callback where the call is traced)."""
    fn = getattr(module, name)

    def spy(x):
        if traced:
            jax.debug.callback(lambda a: into.append(np.array(a)), x,
                               ordered=True)
        else:
            into.append(np.array(x))
        return fn(x)
    monkeypatch.setattr(module, name, spy)


@pytest.mark.parametrize("emissive_lit", [True, False],
                         ids=["emissive", "indirect"])
def test_spatial_reuse_tap_scramble(monkeypatch, emissive_lit):
    """spatial_reuse with scramble bits (hikari_tpu's restir.py:744-800):
    each tap's pick among the four rotated rolls of the packed temporal
    reservoirs, bit for bit (hikari_tpu's packed rows are the port's
    planes transposed), and the pass's outputs at f32 round-off."""
    s, _, s_j, _, g, view, view_r, no_tex = inputs("sphere")
    rng = np.random.default_rng(3 if emissive_lit else 4)
    temporal, spatial = carried(g, rng), carried(g, rng, keep=0.6)
    bits = rng.integers(0, 4, SIZE).astype(np.int32)
    reproj, reproj_r = _reproj(g)
    f, f_r = _frames(9)
    picks_r, picks = [], []
    _capture(monkeypatch, rsv_ref, "unpack_reservoir", picks_r, traced=True)
    _capture(monkeypatch, rsv, "unpack_reservoir_planes", picks)
    ref = restir_ref.spatial_reuse(
        s_j, _jg(g), view_r, f_r, _jg(temporal),
        jnp.asarray(_packed(spatial)), reproj_r, emissive_lit=emissive_lit,
        no_texture=no_tex, render_size=SIZE, scramble_bits=jnp.asarray(bits))
    jax.effects_barrier()
    got = restir.spatial_reuse(
        s, {k: t(v) for k, v in g.items()}, view, f,
        {k: t(v) for k, v in temporal.items()},
        rsv.pack_reservoir_planes({k: t(v) for k, v in spatial.items()}),
        reproj, emissive_lit=emissive_lit, no_texture=no_tex,
        render_size=SIZE, scramble_bits=t(bits))
    taps = 8 if emissive_lit else 16
    assert len(picks_r) >= taps and len(picks) >= taps
    for i, (a, b) in enumerate(zip(picks[-taps:], picks_r[-taps:])):
        np.testing.assert_array_equal(a.transpose(0, 2, 1).view(np.uint32),
                                      b.view(np.uint32), err_msg=f"tap {i}")
    rv, gv = np.asarray(ref["variance"]), got["variance"].numpy()
    np.testing.assert_array_equal(np.isnan(gv), np.isnan(rv))
    pairs = [(got["render"].numpy(), np.asarray(ref["render"])),
             (np.nan_to_num(gv, nan=-1.0), np.nan_to_num(rv, nan=-1.0))]
    pairs += [(v.numpy(), np.asarray(ref["spatial"][k]))
              for k, v in got["spatial"].items()]
    for a, b in pairs:
        assert np.isclose(a, b, rtol=1e-5, atol=1e-6).mean() >= 0.99
    assert got["spatial"]["count"].max() > 1.0
    # the rotations differ: the bits change what the taps merge
    plain = restir.spatial_reuse(
        s, {k: t(v) for k, v in g.items()}, view, f,
        {k: t(v) for k, v in temporal.items()},
        rsv.pack_reservoir_planes({k: t(v) for k, v in spatial.items()}),
        reproj, emissive_lit=emissive_lit, no_texture=no_tex,
        render_size=SIZE)
    assert not torch.equal(plain["render"], got["render"])
