"""The port's on-device refit (hikari_tpu_torch/models/refit_device.py)
against hikari_tpu's DeviceRefitter (jit, on the CPU) on the city after
rotate_sphere at three angles: triangles, normals, inst_motion, the
emissive tables and the instance boxes within float32 round-off (1e-6),
the BVH node boxes bit for bit against a host refit of the port's own
triangles; then kernel 13's plain hits on the refit scene against
hikari_tpu's cull_trace (interpret mode) on its refit scene."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from examples import city as city_ref
from hikari_tpu.models.bvh import refit_bvh
from hikari_tpu.models.refit_device import DeviceRefitter as RefitRef
from hikari_tpu.ops.trace_cull import cull_trace
from hikari_tpu_torch.examples import city
from hikari_tpu_torch.models.refit_device import DeviceRefitter
from hikari_tpu_torch.ops import trace_cull as tc
from tests.test_torch_trace_cull import (assert_bary_close, assert_close,
                                         assert_ids_agree, city_rays,
                                         near_edge)
from tests.torch_threads import one_torch_thread  # noqa: F401

ANGLES = (0.3, 1.7, -2.2)


def _transforms(sc):
    vis = [i for i in sc.instances if i.visible]
    cur = np.stack([np.asarray(i.transform, np.float32) for i in vis])
    prev = np.stack([np.asarray(i.transform if i.prev_transform is None
                                else i.prev_transform, np.float32)
                     for i in vis])
    return cur, prev


@pytest.fixture(scope="module")
def refits():
    """{angle: (port's update, hikari_tpu's update)} as numpy arrays, and
    the compiled scenes."""
    port_gpu = city.build_scene(3).compile()
    ref_gpu = city_ref.build_scene(3).compile()
    port = DeviceRefitter(port_gpu, "cpu")
    ref = RefitRef(ref_gpu)
    ref_fn = jax.jit(ref.update)
    out = {}
    sc_p, sc_r = city.build_scene(3), city_ref.build_scene(3)
    for angle in ANGLES:
        cur, prev = _transforms(city.rotate_sphere(sc_p, angle))
        cur_r, prev_r = _transforms(city_ref.rotate_sphere(sc_r, angle))
        np.testing.assert_array_equal(cur, cur_r)
        got = port.update(torch.from_numpy(cur), torch.from_numpy(prev))
        want = ref_fn(jnp.asarray(cur_r), jnp.asarray(prev_r))
        out[angle] = ({k: v.numpy() for k, v in got.items()},
                      jax.tree.map(np.asarray, want))
    return out, port_gpu, ref_gpu


def _close(got, want, scale=1.0):
    """Within float32 round-off: 1e-6 relative to the values, or to
    `scale`, the magnitude of the terms that cancel in them."""
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=1e-6,
                               atol=1e-6 * scale)


@pytest.mark.parametrize("angle", ANGLES)
def test_refit_matches_reference(refits, angle):
    got, want = refits[0][angle]
    for k in ("tri_pos_flat", "tri_attr", "inst_aabb_min", "inst_aabb_max",
              "em_position", "em_radius", "em_packed", "em_tri_pos_flat",
              "em_tri_attr", "bvh_packed"):
        _close(got[k], np.reshape(want[k], got[k].shape))
    _close(got["inst_model"].reshape(-1, 16), want["inst_model"])
    # prev @ inverse(model): the translations (up to |t| of the houses)
    # cancel in it; the two packages invert differently (LU in XLA, the
    # closed form here)
    t_max = np.abs(got["inst_model"][:, :3, 3]).max()
    _close(got["inst_motion"], want["inst_motion"], scale=t_max)
    # only the sphere moved: every other instance's rows are unchanged
    port_gpu = refits[1]
    o = port_gpu.arrays["inst_prim_offset"][city.SPHERE_INSTANCE]
    c = port_gpu.arrays["inst_prim_count"][city.SPHERE_INSTANCE]
    rows = np.ones(len(got["tri_pos_flat"]), bool)
    rows[o:o + c] = False
    still = got["tri_pos_flat"][rows]
    _close(still, port_gpu.arrays["tri_pos_flat"][rows])


@pytest.mark.parametrize("angle", ANGLES)
def test_refit_boxes_bound_the_triangles_exactly(refits, angle):
    """The node boxes equal a host refit (hikari_tpu's numpy refit_bvh) of
    the port's refit triangles bit for bit (min and max only), and every
    instance box holds its triangles."""
    got, _ = refits[0][angle]
    port_gpu = refits[1]
    n = port_gpu.num_triangles
    tri = got["tri_pos_flat"][:n, :9].reshape(-1, 3, 3)
    host = refit_bvh(port_gpu.bvh, tri.min(axis=1), tri.max(axis=1))
    np.testing.assert_array_equal(got["bvh_packed"][:, 0:3], host.node_min)
    np.testing.assert_array_equal(got["bvh_packed"][:, 3:6], host.node_max)
    np.testing.assert_array_equal(got["bvh_packed"][:, 6:],
                                  port_gpu.arrays["bvh_packed"][:, 6:])
    a = port_gpu.arrays
    for i, (o, c) in enumerate(zip(a["inst_prim_offset"],
                                   a["inst_prim_count"])):
        v = tri[o:o + c].reshape(-1, 3)
        assert (got["inst_aabb_min"][i] <= v.min(0) + 1e-5).all()
        assert (got["inst_aabb_max"][i] >= v.max(0) - 1e-5).all()


def test_hits_on_the_refit_scene_match_reference(refits):
    """Kernel 13's plain hits on the port's refit city against cull_trace
    on hikari_tpu's refit city (its cluster tables refit too): ids at the
    bar, t within 1e-5. The two refits differ by float32 round-off, which
    can move an id at an edge, so the bars are also held against cull_trace
    on the port's refit triangles (hikari_tpu's cluster tables built from
    them), with u and v there (tests/test_torch_trace_cull.py's bars)."""
    from hikari_tpu.models.clusters import build_cluster_tables

    angle = ANGLES[1]
    got_u, want_u = refits[0][angle]
    scene = {**refits[1].as_pytree("cpu"),
             **{k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in got_u.items()}}
    rays = city_rays(np.random.default_rng(7), camera_side=48)
    got = {k: v.numpy() for k, v in tc.walk_plain(
        "hit", scene["bvh_packed"], scene["tri_pos_flat"], None,
        *[torch.from_numpy(x) for x in rays]).items()}
    n = refits[1].num_triangles
    tri = got_u["tri_pos_flat"][:n, :9].reshape(-1, 3, 3)
    own = build_cluster_tables(
        refit_bvh(refits[1].bvh, tri.min(axis=1), tri.max(axis=1)),
        got_u["tri_pos_flat"], got_u["tri_attr"])
    for cl, bary in (({k: v for k, v in want_u.items()
                       if k.startswith("cl_")}, False), (own, True)):
        ref = jax.tree.map(np.asarray, cull_trace(
            {k: jnp.asarray(v) for k, v in cl.items()},
            *[jnp.asarray(x) for x in rays], mode="hit", interpret=True))
        hit_g, hit_r = got["inst"] >= 0, ref["instance"] >= 0
        allowed = ((hit_g & near_edge(got["u"], got["v"]))
                   | (hit_r & near_edge(ref["u"], ref["v"]))
                   | (hit_g & hit_r & np.isclose(got["t"], ref["t"],
                                                 rtol=1e-5, atol=0.0)))
        assert_ids_agree([got["prim"], got["inst"]],
                         [ref["prim"], ref["instance"]], allowed)
        same = (got["prim"] == ref["prim"]) & hit_g
        assert (got["inst"][same] == city.SPHERE_INSTANCE).any()
        assert_close(got["t"], ref["t"], same)
        if bary:
            for k in ("u", "v"):
                assert_bary_close(got[k], ref[k], same)
