"""The large-scene pieces of the modular path on the city at 32x64:
hikari_tpu_torch's non-fused prepass and full-screen albedo against
hikari_tpu's (its tracer on the CPU is the lockstep BVH walk), then on the
port's G-buffer with seeded carried reservoirs direct_lit (the sun on a
direct validation frame, the emissive channel on an emissive validation
frame) and indirect_lit_ambient with the spatial tracking scatters,
spatial_reuse for both channels, and the gather / scatter pair of packed
reservoirs.

The reference's walk honours the shadow rays' early_distance (an any-hit
query) on the CPU, which its engine on the chip (cull_trace) and the port
ignore: NearestWalk is that walk without it.

Bars: the G-buffer at the prepass bar (tests/test_torch_prepass.py); ids
and counts equal on >= 99% of pixels; render, variance and reservoir
fields within rtol 1e-2 / atol 1e-3 on >= 99% of pixels, the scattered
buffers on the pixels that no two scatter sources target (the reference
resolves such collisions arbitrarily)."""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hikari_tpu as hj
import hikari_tpu_torch as ht
from examples import city as city_ref
from hikari_tpu.config import Taa, UpscaleMode
from hikari_tpu.ops import prepass as prepass_ref
from hikari_tpu.ops import reservoir as rsv_ref
from hikari_tpu.ops import restir as restir_ref
from hikari_tpu.ops.trace import hit_info, traverse_bvh
from hikari_tpu_torch.camera import view_to_device
from hikari_tpu_torch.examples import city
from hikari_tpu_torch.ops import prepass, restir
from hikari_tpu_torch.ops import reservoir as rsv
from hikari_tpu_torch.ops.trace import make_tracer
from tests.test_torch_modular import assert_fields, carried, t
from tests.test_torch_prepass import assert_gbuffer_close
from tests.torch_threads import one_torch_thread  # noqa: F401

SIZE = (32, 64)
EYE, TARGET = (0.0, 2.5, 20.0), (0.0, 0.0, 0.0)


class NearestWalk:
    """hikari_tpu's CPU engine (kind "bvh": traverse_bvh, its with_info and
    the whole-scene probe of a table above 256 rows) without the any-hit
    early_distance."""

    kind = "bvh"

    def __call__(self, scene, ro, rd, max_t, exclude_instance=None,
                 include_instance=None, early_distance=None, shape2d=None,
                 incoherent=False):
        return traverse_bvh(scene, ro, rd, max_t, exclude_instance,
                            include_instance)

    def with_info(self, scene, ro, rd, max_t, exclude_instance=None,
                  include_instance=None, shape2d=None, incoherent=False):
        hit = self(scene, ro, rd, max_t, exclude_instance, include_instance)
        info = hit_info(scene, ro, rd, hit)
        info["t"] = hit["t"]
        info["prim"] = hit["prim"]
        return info

    probe_info = with_info


def _frames(number):
    """The port's and hikari_tpu's frame uniforms of HikariSettings()."""
    return (ht.config.make_frame_uniform(ht.HikariSettings(), number),
            hj.config.make_frame_uniform(hj.HikariSettings(), number))


@functools.lru_cache(maxsize=None)
def inputs():
    """The city's scenes, views (the previous one offset, so pixels
    reproject) and both G-buffers at SIZE, as numpy."""
    h, w = SIZE
    views = []
    for pkg in (ht, hj):
        cam = pkg.Camera.from_look_at(EYE, TARGET, width=w, height=h,
                                      hdr=True)
        prev = pkg.Camera.from_look_at(np.add(EYE, (0.3, 0.1, 0.0)), TARGET,
                                       width=w, height=h, hdr=True)
        views.append((cam.view_uniform(), prev.view_uniform()))
    (view, prev), (view_r, prev_r) = views
    port_gpu = city.build_scene(3).compile()
    scene = port_gpu.as_pytree("cpu")
    scene_j = {k: jnp.asarray(v)
               for k, v in city_ref.build_scene(3).compile().arrays.items()
               if not k.startswith(("atlas", "cl_"))}
    jit = prepass.frame_jitter(1, ht.Taa.JASMINE, ht.UpscaleMode.SMAA_TU4X)
    gbuf = prepass.prepass(scene, make_tracer(port_gpu.num_triangles),
                           view_to_device(view, "cpu"),
                           view_to_device(prev, "cpu"), jit, SIZE)
    ref = prepass_ref.prepass(
        scene_j, NearestWalk(), {k: jnp.asarray(v) for k, v in view_r.items()},
        {k: jnp.asarray(v) for k, v in prev_r.items()}, jnp.uint32(1), SIZE,
        Taa.JASMINE, UpscaleMode.SMAA_TU4X)
    g = {k: v.numpy() for k, v in gbuf.items()}
    return scene, scene_j, view, view_r, g, gbuf, ref


def _jg(g):
    return {k: jnp.asarray(v) for k, v in g.items()}


def test_prepass_matches_reference():
    _, _, _, _, _, gbuf, ref = inputs()
    assert (gbuf["instance_material"][..., 0] >= 0).float().mean() > 0.5
    assert_gbuffer_close(gbuf, ref)


def test_full_screen_albedo_matches_reference():
    scene, scene_j, view, view_r, g, gbuf, _ = inputs()
    got = restir.full_screen_albedo(scene, gbuf, view_to_device(view, "cpu"),
                                    True)
    ref = restir_ref.full_screen_albedo(
        scene_j, _jg(g), {k: jnp.asarray(v) for k, v in view_r.items()}, True)
    d = np.abs(got.numpy() - np.asarray(ref))
    assert (d <= 1e-4).mean() >= 0.99, d.max()


def _packed(r):
    """A reservoir dict (numpy) as hikari_tpu's packed [h,w,16] rows."""
    return np.asarray(rsv_ref.pack_reservoir(
        {k: jnp.asarray(v) for k, v in r.items()}))


def _reproj(g):
    """Both packages' reprojections of the port's G-buffer."""
    got = restir.reprojection({k: t(v) for k, v in g.items()}, SIZE)
    ref = restir_ref.reprojection(_jg(g), None, SIZE)
    for k in ("piy", "pix", "in_strict", "in_loose"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]))
    return got, ref


def _single_targets(reproj):
    """[h,w] bool: the pixels at most one pixel reprojects onto (the
    scatters' collisions are excluded there)."""
    h, w = SIZE
    target = (reproj["piy"] * w + reproj["pix"]).reshape(-1).numpy()
    hits = np.bincount(target[reproj["in_loose"].reshape(-1).numpy()],
                       minlength=h * w)
    return (hits <= 1).reshape(h, w)


def _assert_spatial_close(got_planes, ref_packed, single, what):
    g = rsv.unpack_reservoir_planes(got_planes)
    r = {k: np.asarray(v) for k, v in
         rsv_ref.unpack_reservoir(jnp.asarray(ref_packed)).items()}
    assert_fields({k: v[torch.from_numpy(single)] for k, v in g.items()},
                  {k: v[single] for k, v in r.items()}, what)


@pytest.mark.parametrize("case", [("sun", 3), ("emissive", 5)],
                         ids=["sun-validation", "emissive-validation"])
def test_direct_lit_tracks_spatial(case):
    kind, number = case
    scene, scene_j, view, view_r, g, _, _ = inputs()
    rng = np.random.default_rng(number)
    prev, spatial = carried(g, rng), carried(g, rng, keep=0.6)
    reproj, reproj_r = _reproj(g)
    f, f_r = _frames(number)
    rand = rng.random(SIZE + (4,), dtype=np.float32)
    kw = dict(emissive_lit=kind == "emissive", temporal_reuse=True,
              no_texture=True, render_size=SIZE, track_spatial=True)
    ref = restir_ref.direct_lit(
        scene_j, NearestWalk(), _jg(g),
        {k: jnp.asarray(v) for k, v in view_r.items()}, f_r,
        jnp.asarray(rand), reproj_r, _jg(prev),
        jnp.asarray(_packed(spatial)), **kw)
    got = restir.direct_lit(
        scene, make_tracer(2618), {k: t(v) for k, v in g.items()},
        view_to_device(view, "cpu"), f, t(rand),
        {k: t(v) for k, v in prev.items()}, reproj=reproj,
        prev_spatial=rsv.pack_reservoir_planes(
            {k: t(v) for k, v in spatial.items()}), **kw)
    assert_fields({"render": got["render"], "variance": got["variance"]},
                  {"render": ref["render"], "variance": ref["variance"]},
                  f"direct_lit {kind}")
    assert_fields(got["temporal"], ref["temporal"], f"direct_lit {kind} rsv")
    _assert_spatial_close(got["prev_spatial"], ref["prev_spatial_packed"],
                          _single_targets(reproj), f"direct_lit {kind} spatial")


def test_indirect_lit_ambient_tracks_spatial():
    scene, scene_j, view, view_r, g, _, _ = inputs()
    rng = np.random.default_rng(11)
    prev, spatial = carried(g, rng), carried(g, rng, keep=0.6)
    reproj, reproj_r = _reproj(g)
    f, f_r = _frames(7)
    rand = rng.random(SIZE + (4,), dtype=np.float32)
    kw = dict(bounces=1, temporal_reuse=True, no_texture=True,
              render_size=SIZE, track_spatial=True)
    ref = restir_ref.indirect_lit_ambient(
        scene_j, NearestWalk(), _jg(g),
        {k: jnp.asarray(v) for k, v in view_r.items()}, f_r,
        jnp.asarray(rand), reproj_r, _jg(prev),
        jnp.asarray(_packed(spatial)), **kw)
    got = restir.indirect_lit_ambient(
        scene, make_tracer(2618), {k: t(v) for k, v in g.items()},
        view_to_device(view, "cpu"), f, t(rand),
        {k: t(v) for k, v in prev.items()}, reproj=reproj,
        prev_spatial=rsv.pack_reservoir_planes(
            {k: t(v) for k, v in spatial.items()}), **kw)
    assert_fields({"render": got["render"], "variance": got["variance"]},
                  {"render": ref["render"], "variance": ref["variance"]},
                  "indirect_lit_ambient")
    assert_fields(got["temporal"], ref["temporal"], "indirect rsv")
    _assert_spatial_close(got["prev_spatial"], ref["prev_spatial_packed"],
                          _single_targets(reproj), "indirect spatial")


@pytest.mark.parametrize("emissive_lit", [True, False],
                         ids=["emissive", "indirect"])
def test_spatial_reuse_matches_reference(emissive_lit):
    """The modular spatial pass (8 / 16 spiral taps, the occlusion march,
    the GRIS Jacobian) on carried temporal and previous spatial
    reservoirs: render, variance (NaN where the temporal one stays) and
    the new spatial reservoir."""
    scene, scene_j, view, view_r, g, _, _ = inputs()
    rng = np.random.default_rng(3 if emissive_lit else 4)
    temporal, spatial = carried(g, rng), carried(g, rng, keep=0.6)
    reproj, reproj_r = _reproj(g)
    f, f_r = _frames(9)
    ref = restir_ref.spatial_reuse(
        scene_j, _jg(g), {k: jnp.asarray(v) for k, v in view_r.items()}, f_r,
        _jg(temporal), jnp.asarray(_packed(spatial)), reproj_r,
        emissive_lit=emissive_lit, no_texture=True, render_size=SIZE)
    got = restir.spatial_reuse(
        scene, {k: t(v) for k, v in g.items()}, view_to_device(view, "cpu"),
        f, {k: t(v) for k, v in temporal.items()},
        rsv.pack_reservoir_planes({k: t(v) for k, v in spatial.items()}),
        reproj, emissive_lit=emissive_lit, no_texture=True, render_size=SIZE)
    rv, gv = np.asarray(ref["variance"]), got["variance"].numpy()
    np.testing.assert_array_equal(np.isnan(gv), np.isnan(rv))
    assert_fields({"render": got["render"],
                   "variance": np.nan_to_num(gv, nan=-1.0)},
                  {"render": ref["render"],
                   "variance": np.nan_to_num(rv, nan=-1.0)},
                  "spatial_reuse")
    assert_fields(got["spatial"], ref["spatial"], "spatial_reuse rsv")
    assert got["spatial"]["count"].max() > 1.0


def test_gather_and_scatter_of_packed_reservoirs():
    """gather_reservoir_planes equals hikari_tpu's row gather (the planes
    are its packed rows transposed) bit for bit, and
    scatter_reservoir_planes its row scatter on the targets no two sources
    hit; where sources collide the highest source index wins."""
    _, _, _, _, g, _, _ = inputs()
    rng = np.random.default_rng(21)
    dst, src = carried(g, rng), carried(g, rng)
    reproj, _ = _reproj(g)
    valid = reproj["in_strict"]
    dst_rows = _packed(dst)
    planes = torch.from_numpy(dst_rows.transpose(0, 2, 1).copy())
    got = rsv.gather_reservoir_planes(planes, reproj["piy"], reproj["pix"],
                                      valid)
    ref = rsv_ref.gather_reservoir_packed(
        jnp.asarray(dst_rows), jnp.asarray(reproj["piy"].numpy()),
        jnp.asarray(reproj["pix"].numpy()), jnp.asarray(valid.numpy()))
    for k, v in ref.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v), err_msg=k)
    mask = torch.from_numpy(rng.random(SIZE) < 0.7) & reproj["in_loose"]
    got = rsv.scatter_reservoir_planes(
        planes, reproj["piy"], reproj["pix"],
        {k: t(v) for k, v in src.items()}, mask)
    ref = np.asarray(rsv_ref.scatter_reservoir_packed(
        jnp.asarray(dst_rows), jnp.asarray(reproj["piy"].numpy()),
        jnp.asarray(reproj["pix"].numpy()),
        {k: jnp.asarray(v) for k, v in src.items()},
        jnp.asarray(mask.numpy())))
    single = _single_targets(reproj)
    got_rows = got.numpy().transpose(0, 2, 1)
    np.testing.assert_array_equal(got_rows[single].view(np.uint32),
                                  ref[single].view(np.uint32))
    # the collision rule: the highest source index wins
    h, w = SIZE
    src_rows = _packed(src).reshape(h * w, 16)
    target = (reproj["piy"] * w + reproj["pix"]).reshape(-1).numpy()
    m = mask.reshape(-1).numpy()
    for p in np.nonzero(~single.reshape(-1))[0][:20]:
        sources = np.nonzero(m & (target == p))[0]
        if len(sources):
            np.testing.assert_array_equal(
                got_rows.reshape(h * w, 16)[p].view(np.uint32),
                src_rows[sources.max()].view(np.uint32))
