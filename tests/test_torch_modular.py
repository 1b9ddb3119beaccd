"""The modular lighting path of checkerboard lighting with temporal reuse:
hikari_tpu_torch's select_light_candidate, direct_lit (the emissive
channel on the box, the solar channel on the box with a sun, on a
validation frame and off one) and indirect_lit_ambient against
hikari_tpu's, on the G-buffer of a small box render with seeded carried
reservoirs. The reference's tracer is PallasTracer, hikari_tpu's Pallas
engine (kernels 5, 6, 7 in interpret mode, the path it takes on the chip);
the port's tracer runs the plain versions.

Bars: ids and reservoir counts equal on >= 99% of pixels; render,
variance and reservoir fields within rtol 1e-2 / atol 1e-3 on >= 99% of
pixels.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hikari_tpu as hj
from hikari_tpu.ops import restir as restir_ref
from hikari_tpu.ops import sampling as sampling_ref
from hikari_tpu.ops import trace_pallas as tp_ref
from hikari_tpu.ops.trace import hit_info_onehot
import hikari_tpu_torch as ht
from hikari_tpu_torch.camera import view_to_device
from hikari_tpu_torch.ops import restir, sampling
from hikari_tpu_torch.ops.trace import make_tracer
from tests.cornell_box import EYE, TARGET, build_cornell_box
from tests.torch_threads import one_torch_thread  # noqa: F401

SIZE = (16, 24)


class PallasTracer:
    """hikari_tpu's small-scene Pallas engine (ops/trace.py make_tracer on
    the chip) with its kernels in interpret mode: `trace`, `with_info`
    (kernel 5 + hit_info_onehot), `shadow` (kernel 7), `probe_info`
    (kernel 6 on the emissive table)."""

    kind = "brute_force_pallas"

    @staticmethod
    def _ids(ro, exclude_instance, include_instance):
        n = ro.shape[0]
        full = jnp.full((n,), -1, jnp.int32)
        return (full if exclude_instance is None else exclude_instance,
                full if include_instance is None else include_instance)

    def __call__(self, scene, ro, rd, max_t, exclude_instance=None,
                 include_instance=None, early_distance=None, shape2d=None,
                 incoherent=False):
        ex, inc = self._ids(ro, exclude_instance, include_instance)
        return tp_ref.pallas_brute_force(scene["tri_pos_flat"], ro, rd, max_t,
                                         ex, inc, interpret=True)

    def with_info(self, scene, ro, rd, max_t, exclude_instance=None,
                  include_instance=None, shape2d=None, incoherent=False):
        h = self(scene, ro, rd, max_t, exclude_instance, include_instance)
        info = hit_info_onehot(scene, ro, rd, h)
        info["t"] = h["t"]
        info["prim"] = h["prim"]
        return info

    def shadow(self, scene, ro, rd, max_t, exclude_instance=None,
               include_instance=None, early_distance=None, shape2d=None,
               incoherent=False):
        ex, inc = self._ids(ro, exclude_instance, include_instance)
        return tp_ref.pallas_shadow(scene["tri_pos_flat"], ro, rd, max_t, ex,
                                    inc, interpret=True)

    def probe_info(self, scene, ro, rd, max_t, exclude_instance=None,
                   include_instance=None, shape2d=None, incoherent=False):
        ex, inc = self._ids(ro, exclude_instance, include_instance)
        return tp_ref.pallas_brute_force_full(
            scene["em_tri_pos_flat"], scene["em_tri_attr"], ro, rd, max_t,
            ex, inc, interpret=True)


def box(pkg, sun: bool):
    sc = build_cornell_box(pkg)
    if sun:
        mod = __import__(f"{pkg}.models.scene", fromlist=["DirectionalLight"])
        sc.directional_light = mod.DirectionalLight(
            illuminance=10000.0, direction=(0.25, -0.5, -1.0))
    return sc


@functools.lru_cache(maxsize=None)
def inputs(sun: bool):
    """(port scene, reference scene, G-buffer, randoms, view) of the box at
    SIZE from the port's CPU prepass, as numpy, and seeded carried
    reservoir fields."""
    cam = ht.Camera.from_look_at(EYE, TARGET, width=SIZE[1], height=SIZE[0])
    settings = dataclasses.replace(
        ht.HikariSettings(), temporal_reuse=True, taa=ht.Taa.NONE,
        upscale=ht.Upscale.none(), emissive_spatial_reuse=False,
        indirect_spatial_reuse=False, checkerboard_lighting=False)
    r = ht.Renderer(box("hikari_tpu_torch", sun), cam, settings, device="cpu")
    from hikari_tpu_torch.ops import prepass_fused as pf

    view = view_to_device(cam.view_uniform(), "cpu")
    gbuf, _ = pf.prepass_fused(r.scene_dev, view, view, (0.0, 0.0),
                               r.full_size)
    g = {k: v.numpy() for k, v in gbuf.items()}
    rng = np.random.default_rng(7)
    h, w = SIZE
    rand = rng.random((h, w, 4), dtype=np.float32)
    return r, g, rand, {k: v.numpy() for k, v in view.items()}


def carried(g, rng, keep=0.8):
    """A previous reservoir dict (numpy) that passes the temporal gates on
    `keep` of the pixels: this frame's visible point, a radiance, a sample
    point and counts up to 20."""
    h, w = g["position"].shape[:2]
    depth = g["position"][..., 3]
    ok = rng.random((h, w)) < keep
    vp = np.concatenate([g["position"][..., :3], depth[..., None]], -1)
    nrm = g["normal"] / np.maximum(
        np.linalg.norm(g["normal"], axis=-1, keepdims=True), 1e-6)
    sp = vp.copy()
    sp[..., :3] += rng.normal(0.0, 0.5, (h, w, 3)).astype(np.float32)
    sp[..., 3] = 1.0
    count = np.where(ok, rng.integers(1, 21, (h, w)), 0).astype(np.float32)
    w_ = rng.random((h, w), dtype=np.float32)
    r = {
        "radiance": np.concatenate(
            [rng.random((h, w, 3), dtype=np.float32) * 5.0,
             np.ones((h, w, 1), np.float32)], -1),
        "random": rng.random((h, w, 4), dtype=np.float32),
        "visible_position": vp.astype(np.float32),
        "visible_normal": nrm.astype(np.float32),
        "visible_instance": np.where(
            ok, g["instance_material"][..., 0].astype(np.int32), -1),
        "sample_position": sp.astype(np.float32),
        "sample_normal": -nrm.astype(np.float32),
        "count": count,
        "lifetime": rng.integers(0, 10, (h, w)).astype(np.float32),
        "w": w_ * count,
        "w_sum": w_ * count,
        "w2_sum": w_ * w_ * count,
    }
    return {k: np.where(ok.reshape(ok.shape + (1,) * (v.ndim - 2)), v,
                        np.zeros_like(v) if k != "visible_instance" else -1)
            for k, v in r.items()}


def jax_scene(r):
    return {k: jnp.asarray(v.numpy()) for k, v in r.scene_dev.items()}


def frame(number, sun=False):
    f = dict(number=number, direct_validate_interval=3,
             emissive_validate_interval=5, max_temporal_reuse_count=20.0,
             solar_angle=0.0 if not sun else 0.05,
             max_indirect_luminance=10.0)
    return f


def jframe(f):
    return {"number": jnp.uint32(f["number"]),
            "direct_validate_interval": jnp.uint32(
                f["direct_validate_interval"]),
            "emissive_validate_interval": jnp.uint32(
                f["emissive_validate_interval"]),
            "max_temporal_reuse_count": jnp.float32(
                f["max_temporal_reuse_count"]),
            "solar_angle": jnp.float32(f["solar_angle"]),
            "max_indirect_luminance": jnp.float32(
                f["max_indirect_luminance"])}


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def assert_fields(got, ref, what, ids=("visible_instance", "count")):
    """Ids and counts equal on >= 99% of pixels, floats within rtol 1e-2 /
    atol 1e-3 on >= 99% of pixels."""
    for k, rv in ref.items():
        gv = got[k].numpy() if torch.is_tensor(got[k]) else got[k]
        rv = np.asarray(rv)
        assert gv.shape == rv.shape, (what, k, gv.shape, rv.shape)
        if k in ids or rv.dtype.kind in "iu":
            close = gv == rv
        else:
            close = np.isclose(gv, rv, rtol=1e-2, atol=1e-3)
        if close.ndim > 2:
            close = close.all(-1)
        assert close.mean() >= 0.99, (what, k, close.mean())


@pytest.mark.parametrize("sample_emissive", [True, False],
                         ids=["emissive", "solar"])
def test_select_light_candidate_matches_reference(sample_emissive):
    r, g, rand, _ = inputs(sun=not sample_emissive)
    h, w = SIZE
    pos = g["position"][..., :3].reshape(-1, 3)
    nrm = g["normal"].reshape(-1, 3)
    inst = g["instance_material"][..., 0].astype(np.int32).reshape(-1)
    rnd = rand.reshape(-1, 4)
    angle = np.float32(0.05)
    cand_r, info_r = sampling_ref.select_light_candidate(
        jax_scene(r), PallasTracer(), jnp.asarray(rnd), jnp.asarray(pos),
        jnp.asarray(nrm), jnp.asarray(inst), jnp.float32(angle),
        sample_emissive=sample_emissive)
    cand, info = sampling.select_light_candidate(
        r.scene_dev, make_tracer(40), t(rnd), t(pos), t(nrm), t(inst),
        float(np.cos(angle)), sample_emissive)
    got = {**cand, **{f"info_{k}": v for k, v in info.items()}}
    ref = {k: np.asarray(v) for k, v in cand_r.items()
           if k != "min_distance"}
    ref.update({f"info_{k}": np.asarray(v) for k, v in info_r.items()})
    assert_fields({k: v.reshape((h, w) + v.shape[1:]) for k, v in got.items()},
                  {k: v.reshape((h, w) + v.shape[1:]) for k, v in ref.items()},
                  "select_light_candidate",
                  ids=("emissive_instance", "info_instance", "info_material"))


def _prev(g, seed):
    return carried(g, np.random.default_rng(seed))


@pytest.mark.parametrize("case", [
    ("emissive", 5), ("emissive", 6), ("solar", 3), ("solar", 4)],
    ids=["emissive-validation", "emissive", "solar-validation", "solar"])
def test_direct_lit_matches_reference(case):
    """The emissive channel on the box and the solar channel on the box
    with a sun, on a validation frame (number % interval == 0) and off
    one."""
    kind, number = case
    sun = kind == "solar"
    r, g, rand, view = inputs(sun=sun)
    prev = _prev(g, number)
    f = frame(number, sun)
    kw = dict(emissive_lit=not sun, temporal_reuse=True, no_texture=True,
              render_size=SIZE)
    ref = restir_ref.direct_lit(
        jax_scene(r), PallasTracer(), {k: jnp.asarray(v) for k, v in g.items()},
        {k: jnp.asarray(v) for k, v in view.items()}, jframe(f),
        jnp.asarray(rand), None, {k: jnp.asarray(v) for k, v in prev.items()},
        None, track_spatial=False, **kw)
    got = restir.direct_lit(
        r.scene_dev, make_tracer(40), {k: t(v) for k, v in g.items()},
        {k: t(v) for k, v in view.items()}, f, t(rand),
        {k: t(v) for k, v in prev.items()}, **kw)
    assert_fields({"render": got["render"], "variance": got["variance"]},
                  {"render": ref["render"], "variance": ref["variance"]},
                  f"direct_lit {kind} frame {number}")
    assert_fields(got["temporal"], ref["temporal"],
                  f"direct_lit {kind} frame {number} reservoir")


@pytest.mark.parametrize("bounces", [1, 2])
def test_indirect_lit_ambient_matches_reference(bounces):
    """One bounce, as the frame runs, and two, where the second bounce's
    randoms are the first's advanced by frame_number * GOLDEN_RATIO."""
    r, g, rand, view = inputs(sun=False)
    prev = _prev(g, 11)
    f = frame(7)
    kw = dict(bounces=bounces, temporal_reuse=True, no_texture=True,
              render_size=SIZE)
    ref = restir_ref.indirect_lit_ambient(
        jax_scene(r), PallasTracer(), {k: jnp.asarray(v) for k, v in g.items()},
        {k: jnp.asarray(v) for k, v in view.items()}, jframe(f),
        jnp.asarray(rand), None, {k: jnp.asarray(v) for k, v in prev.items()},
        None, track_spatial=False, **kw)
    got = restir.indirect_lit_ambient(
        r.scene_dev, make_tracer(40), {k: t(v) for k, v in g.items()},
        {k: t(v) for k, v in view.items()}, f, t(rand),
        {k: t(v) for k, v in prev.items()}, **kw)
    assert_fields({"render": got["render"], "variance": got["variance"]},
                  {"render": ref["render"], "variance": ref["variance"]},
                  f"indirect_lit_ambient bounces={bounces}")
    assert_fields(got["temporal"], ref["temporal"],
                  f"indirect_lit_ambient bounces={bounces} reservoir")
