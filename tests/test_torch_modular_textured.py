"""The modular lighting channels on a textured scene: the simple scene
(BASELINE config 3) with a procedural Earth on both emissive spheres, at
32x64 from a camera near the spheres. On the port's G-buffer (its non-fused
prepass over kernel 13's plain walk) with seeded carried reservoirs,
hikari_tpu_torch's primary surface (kernel 14's plain version),
direct_lit (the sun on a direct validation frame; the emissive channel,
whose light samples on the spheres read the emissive texture), and
indirect_lit_ambient (bounce hits on the spheres sample the base colour
and emissive textures) with the spatial tracking scatters, and
spatial_reuse for both channels, against hikari_tpu's on the same inputs.

hikari_tpu gets its compiled arrays without the bf16 atlas layouts, so its
samplers take the exact gather (kernel 14's window is held by
tests/test_torch_texture.py), and the nearest-hit walk on the CPU
(tests/test_torch_modular_spatial.py NearestWalk).

Bars (tests/test_torch_modular_spatial.py's): ids and counts equal on
>= 99% of pixels; render, variance and reservoir fields within rtol 1e-2 /
atol 1e-3 on >= 99% of pixels, the scattered buffers on the pixels that no
two scatter sources target."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest

import hikari_tpu as hj
import hikari_tpu_torch as ht
from hikari_tpu.ops import restir as restir_ref
from hikari_tpu_torch.camera import view_to_device
from hikari_tpu_torch.ops import prepass, restir
from hikari_tpu_torch.ops import reservoir as rsv
from hikari_tpu_torch.ops.trace import make_tracer
from tests.test_torch_modular import assert_fields, carried, t
from tests.test_torch_modular_spatial import (SIZE, NearestWalk, _frames,
                                              _jg, _packed, _reproj,
                                              _single_targets,
                                              _assert_spatial_close)
from tests.test_torch_texture import reference_arrays, textured_simple_scenes
from tests.torch_threads import one_torch_thread  # noqa: F401

EYE, TARGET = (0.0, 1.4, 3.6), (0.0, 1.0, 0.0)
SPHERES = (6, 7)           # the spheres' instance ids (spawned last)


def on_spheres(g):
    """[h, w] bool: the G-buffer's pixels on the spheres (the instance
    plane holds id + 0.5)."""
    return np.isin(np.floor(g["instance_material"][..., 0]), SPHERES)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """Both scenes, views (the previous one offset, so pixels reproject)
    and the port's G-buffer at SIZE, as numpy."""
    got, ref = textured_simple_scenes(str(tmp_path_factory.mktemp("assets")))
    h, w = SIZE
    views = []
    for pkg in (ht, hj):
        cam = pkg.Camera.from_look_at(EYE, TARGET, width=w, height=h)
        prev = pkg.Camera.from_look_at(np.add(EYE, (0.2, 0.05, 0.0)), TARGET,
                                       width=w, height=h)
        views.append((cam.view_uniform(), prev.view_uniform()))
    (view, prev), (view_r, _) = views
    scene = got.as_pytree("cpu")
    scene_j = {k: jnp.asarray(v) for k, v in reference_arrays(ref).items()
               if not k.startswith("cl_")}
    jit = prepass.frame_jitter(1, ht.Taa.JASMINE, ht.UpscaleMode.SMAA_TU4X)
    gbuf = prepass.prepass(scene, make_tracer(got.num_triangles),
                           view_to_device(view, "cpu"),
                           view_to_device(prev, "cpu"), jit, SIZE)
    g = {k: v.numpy() for k, v in gbuf.items()}
    assert on_spheres(g).mean() > 0.05, on_spheres(g).mean()
    return scene, scene_j, view, view_r, g, got.num_triangles


def _views(view, view_r):
    return (view_to_device(view, "cpu"),
            {k: jnp.asarray(v) for k, v in view_r.items()})


def test_primary_surface_matches_reference(inputs):
    scene, scene_j, _, _, g, _ = inputs
    got = restir.primary_surface(scene, {k: t(v) for k, v in g.items()},
                                 False)
    ref = restir_ref.primary_surface(scene_j, _jg(g), False)
    for k in ref:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]),
                                      err_msg=k)
    # the texture modulates the spheres' base colour
    assert np.ptp(got["base_color"].numpy()[on_spheres(g)][:, 0]) > 0.05


@pytest.mark.parametrize("case", [("sun", 3), ("emissive", 5)],
                         ids=["sun-validation", "emissive-validation"])
def test_direct_lit_matches_reference(inputs, case):
    kind, number = case
    scene, scene_j, view, view_r, g, n_tri = inputs
    rng = np.random.default_rng(number)
    prev, spatial = carried(g, rng), carried(g, rng, keep=0.6)
    reproj, reproj_r = _reproj(g)
    f, f_r = _frames(number)
    rand = rng.random(SIZE + (4,), dtype=np.float32)
    kw = dict(emissive_lit=kind == "emissive", temporal_reuse=True,
              no_texture=False, render_size=SIZE, track_spatial=True)
    v, v_r = _views(view, view_r)
    ref = restir_ref.direct_lit(
        scene_j, NearestWalk(), _jg(g), v_r, f_r, jnp.asarray(rand),
        reproj_r, _jg(prev), jnp.asarray(_packed(spatial)), **kw)
    got = restir.direct_lit(
        scene, make_tracer(n_tri), {k: t(v_) for k, v_ in g.items()}, v, f,
        t(rand), {k: t(v_) for k, v_ in prev.items()}, reproj=reproj,
        prev_spatial=rsv.pack_reservoir_planes(
            {k: t(v_) for k, v_ in spatial.items()}), **kw)
    assert_fields({"render": got["render"], "variance": got["variance"]},
                  {"render": ref["render"], "variance": ref["variance"]},
                  f"direct_lit {kind}")
    assert_fields(got["temporal"], ref["temporal"], f"direct_lit {kind} rsv")
    _assert_spatial_close(got["prev_spatial"], ref["prev_spatial_packed"],
                          _single_targets(reproj),
                          f"direct_lit {kind} spatial")


def test_indirect_lit_ambient_matches_reference(inputs):
    scene, scene_j, view, view_r, g, n_tri = inputs
    rng = np.random.default_rng(11)
    prev, spatial = carried(g, rng), carried(g, rng, keep=0.6)
    reproj, reproj_r = _reproj(g)
    f, f_r = _frames(7)
    rand = rng.random(SIZE + (4,), dtype=np.float32)
    kw = dict(bounces=1, temporal_reuse=True, no_texture=False,
              render_size=SIZE, track_spatial=True)
    v, v_r = _views(view, view_r)
    ref = restir_ref.indirect_lit_ambient(
        scene_j, NearestWalk(), _jg(g), v_r, f_r, jnp.asarray(rand),
        reproj_r, _jg(prev), jnp.asarray(_packed(spatial)), **kw)
    got = restir.indirect_lit_ambient(
        scene, make_tracer(n_tri), {k: t(v_) for k, v_ in g.items()}, v, f,
        t(rand), {k: t(v_) for k, v_ in prev.items()}, reproj=reproj,
        prev_spatial=rsv.pack_reservoir_planes(
            {k: t(v_) for k, v_ in spatial.items()}), **kw)
    assert_fields({"render": got["render"], "variance": got["variance"]},
                  {"render": ref["render"], "variance": ref["variance"]},
                  "indirect_lit_ambient")
    assert_fields(got["temporal"], ref["temporal"], "indirect rsv")
    _assert_spatial_close(got["prev_spatial"], ref["prev_spatial_packed"],
                          _single_targets(reproj), "indirect spatial")
    # bounces from the floor and walls reach the textured spheres
    sample_pos = got["temporal"]["sample_position"].numpy()
    near = np.linalg.norm(sample_pos[..., :3] - np.array([2.0, 1.0, 0.0]),
                          axis=-1) < 0.51
    near |= np.linalg.norm(sample_pos[..., :3] - np.array([-2.0, 1.0, 0.0]),
                           axis=-1) < 0.51
    assert near.sum() > 0


@pytest.mark.parametrize("emissive_lit", [True, False],
                         ids=["emissive", "indirect"])
def test_spatial_reuse_matches_reference(inputs, emissive_lit):
    scene, scene_j, view, view_r, g, _ = inputs
    rng = np.random.default_rng(3 if emissive_lit else 4)
    temporal, spatial = carried(g, rng), carried(g, rng, keep=0.6)
    reproj, reproj_r = _reproj(g)
    f, f_r = _frames(9)
    v, v_r = _views(view, view_r)
    ref = restir_ref.spatial_reuse(
        scene_j, _jg(g), v_r, f_r, _jg(temporal),
        jnp.asarray(_packed(spatial)), reproj_r, emissive_lit=emissive_lit,
        no_texture=False, render_size=SIZE)
    got = restir.spatial_reuse(
        scene, {k: t(v_) for k, v_ in g.items()}, v, f,
        {k: t(v_) for k, v_ in temporal.items()},
        rsv.pack_reservoir_planes({k: t(v_) for k, v_ in spatial.items()}),
        reproj, emissive_lit=emissive_lit, no_texture=False,
        render_size=SIZE)
    rv, gv = np.asarray(ref["variance"]), got["variance"].numpy()
    np.testing.assert_array_equal(np.isnan(gv), np.isnan(rv))
    assert_fields({"render": got["render"],
                   "variance": np.nan_to_num(gv, nan=-1.0)},
                  {"render": ref["render"],
                   "variance": np.nan_to_num(rv, nan=-1.0)},
                  "spatial_reuse")
    assert_fields(got["spatial"], ref["spatial"], "spatial_reuse rsv")
