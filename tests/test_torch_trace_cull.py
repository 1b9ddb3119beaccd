"""Kernel 13's plain version (hikari_tpu_torch/ops/trace_cull.py: the walk
of the world BVH) in its three modes against hikari_tpu's tile-cull engine
(cull_trace in interpret mode, as tests/test_trace_cull.py runs it) and
its lockstep BVH walk (traverse_bvh) on the city, and against the port's
kernel 5 and 7 plain versions on the box.

The rays: 64x64 camera rays from the city's camera, random incoherent rays
through the city, and probe rays at the Earth sphere include-masked to it
(or -2, any instance), with excludes and finite max_t on a share of them.
The bars: prim, instance and material equal on >= 99.9% of rays and on
every ray not within 1e-5 (barycentric) of a triangle's edge or at a tie;
where the ids agree t within 1e-5 relative, and u, v, normal and uv within
1e-5 relative on >= 95% of the hits and within 1e-3 on all.

Who is right where the barycentrics differ: the Moller-Trumbore
expressions of trace_pallas.py:72-80 / trace_cull.py:208-233 evaluated in
numpy float32 one operation at a time, in their written order, on every
hit of these rays. The port's walk equals that evaluation bit for bit (t,
u and v of all 4,056 hits, on the triangles cull_trace hits too);
cull_trace equals it on 78% (t), 20% (u) and 56% (v) of them, by up to
4.7e-5 in t and 2.6e-4 in u and v; traverse_bvh equals, on every hit, the
same evaluation with each product-plus-term contracted into a fused
multiply-add. XLA on the CPU contracts a*b + c into FMAs; the port and its
kernels (nvcc --fmad=false) do not. So the port is right, and the
reference's contraction, amplified in the barycentrics of small far
triangles, is what the looser bar on u, v, normal and uv allows for."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hikari_tpu_torch as ht
from examples import city as city_ref
from hikari_tpu.ops.trace import traverse_bvh
from hikari_tpu.ops.trace_cull import cull_trace
from hikari_tpu_torch.camera import view_to_device
from hikari_tpu_torch.examples import city
from hikari_tpu_torch.ops import trace_cull as tc
from hikari_tpu_torch.ops import trace_pallas as tp
from hikari_tpu_torch.ops.prepass import camera_rays
from tests.cornell_box import build_cornell_box
from tests.torch_threads import one_torch_thread  # noqa: F401

F32_MAX = 3.4028234663852886e38
EYE, TARGET = (0.0, 2.5, 20.0), (0.0, 0.0, 0.0)


def city_rays(rng, camera_side=64, n_random=1024, n_probe=1024):
    """(ro, rd, max_t, excl, incl) numpy arrays: camera rays, incoherent
    rays and include-masked probe rays at the sphere."""
    cam = ht.Camera.from_look_at(EYE, TARGET, width=camera_side,
                                 height=camera_side)
    o, d = camera_rays(view_to_device(cam.view_uniform(), "cpu"),
                       (camera_side, camera_side), (0.25, -0.25))
    ro = [o.reshape(-1, 3).numpy()]
    rd = [d.reshape(-1, 3).numpy()]
    r_o = rng.uniform(-14.0, 14.0, (n_random, 3))
    r_o[:, 1] = rng.uniform(0.05, 5.0, n_random)
    r_d = rng.normal(size=(n_random, 3))
    ro.append(r_o)
    rd.append(r_d / np.linalg.norm(r_d, axis=1, keepdims=True))
    # probes: from points around the city towards the sphere's surface
    p_o = rng.uniform(-10.0, 10.0, (n_probe, 3))
    p_o[:, 1] = rng.uniform(0.1, 4.0, n_probe)
    on = rng.normal(size=(n_probe, 3))
    target = np.array([0.0, 1.0, 0.0]) + 0.5 * on / np.linalg.norm(
        on, axis=1, keepdims=True)
    p_d = target - p_o
    ro.append(p_o)
    rd.append(p_d / np.linalg.norm(p_d, axis=1, keepdims=True))
    ro = np.concatenate(ro).astype(np.float32)
    rd = np.concatenate(rd).astype(np.float32)
    n = len(ro)
    n_cam = camera_side * camera_side
    max_t = np.full(n, F32_MAX, np.float32)
    finite = rng.random(n) < 0.25
    max_t[finite] = rng.uniform(0.5, 30.0, finite.sum()).astype(np.float32)
    excl = np.where(rng.random(n) < 0.25, rng.integers(0, 122, n), -1)
    incl = np.full(n, -1)
    probe = np.arange(n) >= n_cam + n_random
    incl[probe] = np.where(rng.random(probe.sum()) < 0.8,
                           city.SPHERE_INSTANCE, -2)
    excl[probe] = np.where(rng.random(probe.sum()) < 0.5, 0, -1)
    return ro, rd, max_t, excl.astype(np.int32), incl.astype(np.int32)


def near_edge(u, v, eps=1e-5):
    return np.minimum(np.minimum(u, v), 1.0 - u - v) < eps


def assert_ids_agree(got_ids, ref_ids, allowed):
    """Every id array equal on >= 99.9% of rays and wherever not
    `allowed` (near an edge, or a tie)."""
    differ = np.zeros(len(allowed), bool)
    for g, r in zip(got_ids, ref_ids):
        differ |= np.asarray(g) != np.asarray(r)
    assert differ.mean() <= 1e-3, differ.mean()
    assert not (differ & ~allowed).any(), np.nonzero(differ & ~allowed)


def assert_close(got, ref, mask, rtol=1e-5):
    got, ref = np.asarray(got)[mask], np.asarray(ref)[mask]
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol)


def assert_bary_close(got, ref, mask):
    """Barycentric-derived values: within 1e-5 relative on >= 95% of the
    masked values and within 1e-3 on all of them."""
    got, ref = np.asarray(got)[mask], np.asarray(ref)[mask]
    close = np.isclose(got, ref, rtol=1e-5, atol=1e-5)
    assert close.mean() >= 0.95, close.mean()
    np.testing.assert_allclose(got, ref, rtol=0.0, atol=1e-3)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.fixture(scope="module")
def city_case():
    """The port's plain walk and hikari_tpu's engines on the same rays."""
    rays = city_rays(np.random.default_rng(13))
    ref_scene = city_ref.build_scene(3).compile().arrays
    jscene = {k: jnp.asarray(v) for k, v in ref_scene.items()
              if k.startswith("cl_") or k in ("bvh_packed", "bvh_entry",
                                              "tri_pos_flat", "tri_attr")}
    jr = [jnp.asarray(x) for x in rays]
    ref = {m: jax.tree.map(np.asarray, cull_trace(
        jscene, *jr, mode=m, interpret=True)) for m in tc.MODES}
    ref["walk"] = jax.tree.map(np.asarray, traverse_bvh(jscene, *jr))
    scene = city.build_scene(3).compile().as_pytree("cpu")
    tr = [_t(x) for x in rays]
    stats = {}
    got = {m: {k: v.numpy() for k, v in tc.walk_plain(
        m, scene["bvh_packed"], scene["tri_pos_flat"], scene["tri_attr"],
        *tr, stats=stats).items()} for m in tc.MODES}
    got["info"] = {k: v.numpy() for k, v in tp.full_info(
        {k: torch.from_numpy(v) for k, v in got["full"].items()},
        tr[0], tr[1]).items()}
    # where a hit lies within 1e-5 of its triangle's edge, or two
    # triangles tie, the engines may take different ones
    h, rh = got["hit"], ref["hit"]
    hit_g, hit_r = h["inst"] >= 0, rh["instance"] >= 0
    allowed = ((hit_g & near_edge(h["u"], h["v"]))
               | (hit_r & near_edge(rh["u"], rh["v"]))
               | (hit_g & hit_r & np.isclose(h["t"], rh["t"], rtol=1e-5,
                                             atol=0.0)))
    return {"rays": rays, "ref": ref, "got": got, "allowed": allowed,
            "stats": stats, "tris": ref_scene["tri_pos_flat"]}


def test_hit_matches_cull_trace(city_case):
    got, ref = city_case["got"]["hit"], city_case["ref"]["hit"]
    assert_ids_agree([got["prim"], got["inst"]],
                     [ref["prim"], ref["instance"]], city_case["allowed"])
    same = (got["prim"] == ref["prim"]) & (got["inst"] >= 0)
    assert same.mean() > 0.3            # the rays do hit the city
    assert_close(got["t"], ref["t"], same)
    for k in ("u", "v"):
        assert_bary_close(got[k], ref[k], same)


def test_full_matches_cull_trace(city_case):
    got, ref = city_case["got"]["info"], city_case["ref"]["full"]
    assert_ids_agree([got["prim"], got["instance"], got["material"]],
                     [ref["prim"], ref["instance"], ref["material"]],
                     city_case["allowed"])
    same = (got["prim"] == ref["prim"]) & (got["instance"] >= 0)
    assert_close(got["t"], ref["t"], same)
    for k in ("normal", "uv"):
        assert_bary_close(got[k], ref[k], same)
    miss = got["instance"] < 0
    assert (got["material"][miss] == -1).all()
    assert (got["normal"][miss] == 0).all()


def test_shadow_matches_cull_trace(city_case):
    got, ref = city_case["got"]["shadow"], city_case["ref"]["shadow"]
    assert_ids_agree([got["inst"]], [ref["instance"]], city_case["allowed"])
    same = (got["inst"] == ref["instance"]) & (got["inst"] >= 0)
    assert_close(got["t"], ref["t"], same)
    # the nearest occluder is the nearest hit below max_t
    hit = city_case["got"]["hit"]
    np.testing.assert_array_equal(got["inst"], hit["inst"])


def test_probe_rays_hit_only_the_included_instance(city_case):
    _, _, _, _, incl = city_case["rays"]
    got = city_case["got"]["info"]
    probe = incl >= 0
    hits = got["instance"][probe]
    assert (hits >= 0).mean() > 0.5
    assert set(np.unique(hits)) <= {-1, city.SPHERE_INSTANCE}


def test_hit_matches_traverse_bvh(city_case):
    got, ref = city_case["got"]["hit"], city_case["ref"]["walk"]
    # the same walk: the same triangle everywhere
    np.testing.assert_array_equal(got["prim"], ref["prim"])
    np.testing.assert_array_equal(got["inst"], ref["instance"])
    same = got["inst"] >= 0
    assert_close(got["t"], ref["t"], same)
    for k in ("u", "v"):
        assert_bary_close(got[k], ref[k], same)


def mt_float32(tris, prim, ro, rd, fused=False):
    """(t, u, v) of each ray against its triangle, the Moller-Trumbore
    expressions of trace_cull.py:208-233 in numpy float32 one operation at
    a time (fused: each a*b + c as one fused multiply-add, exact in float64
    and rounded once, as XLA contracts them on the CPU)."""
    f = np.float32
    r = tris[prim]
    v0 = r[:, 0:3]
    abx, aby, abz = (r[:, 3:6] - v0).T
    acx, acy, acz = (r[:, 6:9] - v0).T
    dx, dy, dz = rd.T
    aox, aoy, aoz = (ro - v0).T

    def fma(a, b, c):
        return (a.astype(np.float64) * b + c).astype(f)

    def diff(a, b, c, d):              # a*b - c*d
        return fma(a, b, -(c * d)) if fused else a * b - c * d

    def dot(ax, ay, az, bx, by, bz):   # (ax*bx + ay*by) + az*bz
        if fused:
            return fma(az, bz, fma(ay, by, ax * bx))
        return ax * bx + ay * by + az * bz

    ux, uy, uz = diff(dy, acz, dz, acy), diff(dz, acx, dx, acz), \
        diff(dx, acy, dy, acx)
    det = dot(abx, aby, abz, ux, uy, uz)
    with np.errstate(divide="ignore"):
        inv = np.where(np.abs(det) < f(1.1920929e-07), f(0.0),
                       f(1.0) / det).astype(f)
    vx, vy, vz = diff(aoy, abz, aoz, aby), diff(aoz, abx, aox, abz), \
        diff(aox, aby, aoy, abx)
    return (dot(acx, acy, acz, vx, vy, vz) * inv,
            dot(aox, aoy, aoz, ux, uy, uz) * inv,
            dot(dx, dy, dz, vx, vy, vz) * inv)


def test_barycentrics_are_the_float32_evaluation(city_case):
    """The port's walk equals the step-by-step float32 evaluation bit for
    bit on every hit; traverse_bvh equals its FMA-contracted form (the
    cause of the reference's differences, see the module docstring)."""
    ro, rd = city_case["rays"][:2]
    got, walk = city_case["got"]["hit"], city_case["ref"]["walk"]
    hit = got["inst"] >= 0
    assert hit.mean() > 0.3
    plain = mt_float32(city_case["tris"], got["prim"][hit], ro[hit], rd[hit])
    fused = mt_float32(city_case["tris"], walk["prim"][hit], ro[hit],
                       rd[hit], fused=True)
    for k, p, fz in zip("tuv", plain, fused):
        assert np.array_equal(got[k][hit].view(np.int32), p.view(np.int32)), k
        same = (walk[k][hit].view(np.int32) == fz.view(np.int32)).mean()
        print(f"{k}: traverse_bvh equals the FMA evaluation on {same:.6f}, "
              f"the port the plain one on all {int(hit.sum())} hits")
        assert same >= 0.999, (k, same)


def test_walk_counts_its_work(city_case):
    """The node visits and triangle tests a call reports (the bound's
    operations): every ray visits the root, a test needs a visited leaf."""
    s = city_case["stats"]
    n = len(city_case["rays"][0])
    assert s["nodes"] >= 3 * n and 0 < s["tests"] < s["nodes"]


@pytest.mark.parametrize("mode", tc.MODES)
def test_walk_matches_brute_force_on_the_box(mode):
    """On the box the walk and kernels 5 / 7's plain versions test the same
    triangles with the same routine: ids equal but at exact ties, and the
    floats equal bit for bit where the ids agree."""
    scene = build_cornell_box("hikari_tpu_torch").compile().as_pytree("cpu")
    rng = np.random.default_rng(5)
    n = 2048
    ro = _t(rng.uniform(-0.9, 0.9, (n, 3)).astype(np.float32))
    d = rng.normal(size=(n, 3))
    rd = _t((d / np.linalg.norm(d, axis=1, keepdims=True)).astype(
        np.float32))
    max_t = _t(np.where(rng.random(n) < 0.3, 0.7, F32_MAX).astype(
        np.float32))
    excl = _t(rng.integers(-1, 3, n).astype(np.int32))
    incl = _t(np.where(rng.random(n) < 0.2, 1, -1).astype(np.int32))
    args = (ro, rd, max_t, excl, incl)
    walk = tc.walk_plain(mode, scene["bvh_packed"], scene["tri_pos_flat"],
                         scene["tri_attr"], *args)
    if mode == "shadow":
        brute = tp.shadow_plain(scene["tri_pos_flat"], *args)
        ids = ("inst",)
    elif mode == "hit":
        brute = tp.closest_plain(scene["tri_pos_flat"], *args)
        ids = ("prim", "inst")
    else:
        brute = tp.full_plain(scene["tri_pos_flat"], scene["tri_attr"],
                              *args)
        ids = ("prim", "inst")
    differ = np.zeros(n, bool)
    for k in ids:
        differ |= (walk[k] != brute[k]).numpy()
    # a tie: both hits at the same t up to rounding (the box has coplanar
    # triangles), or on the edge two triangles share
    hit = tp.closest_plain(scene["tri_pos_flat"], *args)
    walk_hit = tc.walk_plain("hit", scene["bvh_packed"],
                             scene["tri_pos_flat"], None, *args)
    tie = (np.isclose(walk["t"].numpy(), brute["t"].numpy(), rtol=1e-6,
                      atol=0.0)
           | near_edge(hit["u"].numpy(), hit["v"].numpy())
           | near_edge(walk_hit["u"].numpy(), walk_hit["v"].numpy()))
    assert not (differ & ~tie).any()
    assert differ.mean() < 0.01
    same = torch.from_numpy(~differ)
    assert float((walk["inst"] >= 0).float().mean()) > 0.3
    for k in walk:
        assert torch.equal(walk[k][same].view(torch.int32)
                           if walk[k].dtype == torch.float32
                           else walk[k][same],
                           brute[k][same].view(torch.int32)
                           if brute[k].dtype == torch.float32
                           else brute[k][same]), k
