"""Kernels 5, 6 and 7 (hikari_tpu_torch/ops/trace_pallas.py): the plain
versions against hikari_tpu's pallas_brute_force, pallas_brute_force_full
and pallas_shadow in interpret mode, on the box's triangle table and on
tests/test_trace.py's simple_scene, with random rays, rays aimed at
triangle edges, exclude and include masks (the probe's -2 include among
them) and finite max_t; the tracer's hit_info against hit_info_onehot;
and its with_info on a table above 256 rows (simple_scene with a sphere)
against kernel 6, which hikari_tpu's with_info takes there.

Bars: prim, instance and material equal on >= 99.9% of the random rays,
and every ray whose ids differ is aimed at an edge or lies within 1e-5 of
one (a knife-edge test XLA on the CPU may round the other way; a grazing
ray's f32 barycentrics err by more than 1e-5); t, u, v, position, normal
and uv within 1e-5 * max(|ref|, 1) on the random rays whose ids agree (on
an edge-aimed ray the id of a shadow hit is the instance, and a knife-edge
may hand the hit to another of its triangles). Ray origins lie in the free space in front of the
geometry, as camera and bounce rays do: from inside a box, its bottom face
and the floor under it are coplanar and tie at the last bit of t.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hikari_tpu.models import mesh as shapes
from hikari_tpu.models.material import StandardMaterial
from hikari_tpu.models.scene import make_transform
from hikari_tpu.ops import trace_pallas as tp_ref
from hikari_tpu.ops.trace import hit_info_onehot
from hikari_tpu_torch.ops import trace_pallas as tp
from hikari_tpu_torch.ops.trace import hit_info, make_tracer
from tests.cornell_box import build_cornell_box
from tests.test_trace import simple_scene
from tests.torch_threads import one_torch_thread  # noqa: F401

N_RAYS = 4096
EDGE_EPS = 1e-5
F32_MAX = np.float32(3.402823466e38)


def tables(name):
    """The compiled triangle tables of the box, simple_scene, or
    simple_scene with a 288-triangle sphere beside the cube (built with
    hikari_tpu; the port compiles them bit for bit, test_torch_compile)."""
    if name == "box":
        return build_cornell_box("hikari_tpu").compile().arrays
    sc = simple_scene()
    if name == "sphere":
        sc.spawn(sc.add_mesh(shapes.uv_sphere(0.5, sectors=16, stacks=10)),
                 sc.add_material(StandardMaterial.from_color(0.2, 0.4, 0.9)),
                 make_transform((2.0, 0.5, -2.0)))
    return sc.compile().arrays


# (low, high) corners of the free space the ray origins come from
ORIGINS = {"box": ((-0.9, 0.1, 1.0), (0.9, 1.9, 3.0)),
           "simple": ((-3.0, 1.2, -3.0), (3.0, 3.0, 3.0)),
           "sphere": ((-3.0, 1.2, -3.0), (3.0, 3.0, 3.0))}


def rays(arrays, name, seed):
    """N_RAYS rays from the free space of scene `name`: half random, half
    aimed at a random point of a random triangle's edge; per ray an exclude
    id (-1 or an instance), an include id (-1, -2 or an instance) and
    max_t (F32_MAX or finite)."""
    rng = np.random.default_rng(seed)
    tri = arrays["tri_pos_flat"]
    real = np.flatnonzero(tri[:, 9] >= 0)
    v = tri[:, :9].reshape(-1, 3, 3).astype(np.float64)
    lo = v[real].reshape(-1, 3).min(0) - 0.5
    hi = v[real].reshape(-1, 3).max(0) + 0.5
    n = N_RAYS
    ro = rng.uniform(*ORIGINS[name], (n, 3))
    target = rng.uniform(lo, hi, (n, 3))
    half = n // 2
    pick = rng.choice(real, half)
    a = rng.random(half)[:, None]
    k = rng.integers(0, 3, half)
    p0 = v[pick, k]
    p1 = v[pick, (k + 1) % 3]
    target[half:] = p0 + a * (p1 - p0)
    rd = target - ro
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    inst = np.unique(tri[real, 9]).astype(np.int32)
    excl = np.where(rng.random(n) < 0.3, rng.choice(inst, n), -1)
    incl = rng.choice(np.concatenate([inst, [-1, -1, -2]]), n)
    incl = np.where(rng.random(n) < 0.5, incl, -1)
    max_t = np.where(rng.random(n) < 0.3,
                     rng.uniform(0.2, 4.0, n), F32_MAX)
    return (ro.astype(np.float32), rd.astype(np.float32),
            max_t.astype(np.float32), excl.astype(np.int32),
            incl.astype(np.int32))


def near_edge(arrays, ro, rd):
    """The rays aimed at an edge (the second half), and those passing
    within EDGE_EPS (barycentric, in float64) of an edge of any real
    triangle they cross."""
    tri = arrays["tri_pos_flat"]
    real = tri[:, 9] >= 0
    v = tri[real, :9].reshape(-1, 3, 3).astype(np.float64)
    o = ro.astype(np.float64)[:, None]
    d = rd.astype(np.float64)[:, None]
    e1 = v[None, :, 1] - v[None, :, 0]
    e2 = v[None, :, 2] - v[None, :, 0]
    p = np.cross(d, e2)
    det = (e1 * p).sum(-1)
    inv = 1.0 / np.where(np.abs(det) < 1e-30, 1e-30, det)
    s = o - v[None, :, 0]
    u = (s * p).sum(-1) * inv
    q = np.cross(s, e1)
    w = (d * q).sum(-1) * inv
    m = np.minimum(np.minimum(np.abs(u), np.abs(w)), np.abs(1.0 - u - w))
    inside = (u > -EDGE_EPS) & (w > -EDGE_EPS) & (u + w < 1.0 + EDGE_EPS)
    edge = (inside & (m < EDGE_EPS)).any(1)
    edge[N_RAYS // 2:] = True
    return edge


def check(got, ref, ids, floats, edge):
    agree = np.ones(len(edge), bool)
    for k in ids:
        agree &= np.asarray(got[k]) == np.asarray(ref[k])
    assert agree[:N_RAYS // 2].mean() >= 0.999, agree[:N_RAYS // 2].mean()
    assert edge[~agree].all(), np.flatnonzero(~agree & ~edge)
    agree[N_RAYS // 2:] = False
    for k in floats:
        g = np.asarray(got[k], np.float64)[agree]
        r = np.asarray(ref[k], np.float64)[agree]
        assert (np.abs(g - r) <= 1e-5 * np.maximum(np.abs(r), 1.0)).all(), k


def run(kind, name, seed=0):
    arrays = tables(name)
    ro, rd, max_t, excl, incl = rays(arrays, name, seed)
    tri = arrays["tri_pos_flat"]
    attrs = arrays["tri_attr"]
    j = [jnp.asarray(x) for x in (ro, rd, max_t, excl, incl)]
    t = [torch.from_numpy(x) for x in (ro, rd, max_t, excl, incl)]
    tri_t = torch.from_numpy(tri)
    if kind == "closest":
        ref = tp_ref.pallas_brute_force(jnp.asarray(tri), *j, interpret=True)
        got = tp.brute_force(tri_t, *t)
    elif kind == "full":
        ref = tp_ref.pallas_brute_force_full(jnp.asarray(tri),
                                             jnp.asarray(attrs), *j,
                                             interpret=True)
        got = tp.brute_force_full(tri_t, torch.from_numpy(attrs), *t)
    else:
        ref = tp_ref.pallas_shadow(jnp.asarray(tri), *j, interpret=True)
        got = tp.shadow(tri_t, *t)
    got = {k: v.numpy() for k, v in got.items()}
    ref = {k: np.asarray(v) for k, v in ref.items()}
    return arrays, ro, rd, got, ref


@pytest.mark.parametrize("name", ["box", "simple"])
def test_kernel5_plain_matches_pallas(name):
    arrays, ro, rd, got, ref = run("closest", name)
    assert (got["prim"] >= 0).mean() > 0.2      # the rays do hit
    check(got, ref, ("prim", "instance"), ("t", "u", "v"),
          near_edge(arrays, ro, rd))


@pytest.mark.parametrize("name", ["box", "simple"])
def test_kernel6_plain_matches_pallas(name):
    arrays, ro, rd, got, ref = run("full", name)
    check(got, ref, ("prim", "instance", "material"),
          ("t", "position", "normal", "uv"), near_edge(arrays, ro, rd))


@pytest.mark.parametrize("name", ["box", "simple"])
def test_kernel7_plain_matches_pallas(name):
    arrays, ro, rd, got, ref = run("shadow", name)
    assert (got["instance"] >= 0).mean() > 0.2
    check(got, ref, ("instance",), ("t",), near_edge(arrays, ro, rd))


def test_probe_include_minus_two_accepts_every_triangle():
    """The probe's "no pick" include id -2 passes every triangle, as
    include -1 does (trace_pallas.py:109-111, sampling.py:215)."""
    arrays = tables("box")
    ro, rd, max_t, excl, _ = (torch.from_numpy(x)
                              for x in rays(arrays, "box", 3))
    tri = torch.from_numpy(arrays["tri_pos_flat"])
    attrs = torch.from_numpy(arrays["tri_attr"])
    a = tp.brute_force_full(tri, attrs, ro, rd, max_t, excl,
                            torch.full_like(excl, -1))
    b = tp.brute_force_full(tri, attrs, ro, rd, max_t, excl,
                            torch.full_like(excl, -2))
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_kernel7_returns_the_closest_occluder():
    """Two parallel quads on a ray: the shadow kernel reports the nearer
    one (t and instance), whatever the table order."""
    quad = lambda z, inst: [[-1, -1, z, 1, -1, z, 1, 1, z, inst],
                            [-1, -1, z, 1, 1, z, -1, 1, z, inst]]
    rows = np.array(quad(3.0, 1) + quad(2.0, 0), np.float32)
    ro = torch.tensor([[0.1, 0.2, 0.0]])
    rd = torch.tensor([[0.0, 0.0, 1.0]])
    one = torch.tensor([-1], dtype=torch.int32)
    for table in (rows, rows[::-1].copy()):
        out = tp.shadow(torch.from_numpy(table), ro, rd,
                        torch.tensor([F32_MAX]), one, one)
        assert out["instance"].tolist() == [0]
        assert abs(out["t"].item() - 2.0) <= 1e-6


@pytest.mark.parametrize("name", ["box", "simple"])
def test_hit_info_matches_onehot(name):
    """The tracer's with_info (kernel 5 + tri_attr[prim]) against
    hikari_tpu's hit_info_onehot on the same kernel-5 hit."""
    arrays, ro, rd, got_hit, ref_hit = run("closest", name, seed=5)
    hit = {k: torch.from_numpy(v) for k, v in got_hit.items()}
    scene = {"tri_attr": torch.from_numpy(arrays["tri_attr"])}
    got = hit_info(scene, torch.from_numpy(ro), torch.from_numpy(rd), hit)
    ref = hit_info_onehot({"tri_attr": jnp.asarray(arrays["tri_attr"])},
                          jnp.asarray(ro), jnp.asarray(rd),
                          {k: jnp.asarray(v) for k, v in got_hit.items()})
    for k in ("instance", "material"):
        assert np.array_equal(got[k].numpy(), np.asarray(ref[k])), k
    for k in ("position", "normal", "uv"):
        g, r = got[k].numpy(), np.asarray(ref[k])
        assert (np.abs(g - r) <= 1e-5 * np.maximum(np.abs(r), 1.0)).all(), k
    assert make_tracer(len(arrays["tri_pos_flat"])).kind == \
        "brute_force_pallas"


def test_with_info_above_256_rows_matches_kernel6():
    """Above 256 attribute rows hikari_tpu's with_info is kernel 6
    (pallas_brute_force_full); the port's stays kernel 5 + tri_attr[prim],
    at kernel 6's bars."""
    arrays = tables("sphere")
    assert arrays["tri_attr"].shape[0] > 256
    ro, rd, max_t, excl, incl = rays(arrays, "sphere", 2)
    ref = tp_ref.pallas_brute_force_full(
        *(jnp.asarray(x) for x in (arrays["tri_pos_flat"], arrays["tri_attr"],
                                   ro, rd, max_t, excl, incl)),
        interpret=True)
    scene = {k: torch.from_numpy(arrays[k])
             for k in ("tri_pos_flat", "tri_attr")}
    got = make_tracer(len(arrays["tri_pos_flat"])).with_info(
        scene, *(torch.from_numpy(x) for x in (ro, rd, max_t, excl, incl)))
    assert got.keys() == ref.keys()
    sphere = arrays["tri_pos_flat"][:, 9].max()     # the last instance
    assert (got["instance"].numpy() == sphere).mean() > 0.05
    check({k: v.numpy() for k, v in got.items()},
          {k: np.asarray(v) for k, v in ref.items()},
          ("prim", "instance", "material"), ("t", "position", "normal", "uv"),
          near_edge(arrays, ro, rd))


def test_tracer_without_ids_masks_nothing():
    """The tracer's exclude / include ids default to -1 for every ray:
    trace, shadow and probe_info then equal the kernels' wrappers called
    with -1 (probe_info on the emissive-only table)."""
    arrays = tables("box")
    ro, rd, max_t, _, _ = (torch.from_numpy(x)
                           for x in rays(arrays, "box", 9))
    none = torch.full((ro.shape[0],), -1, dtype=torch.int32)
    scene = {k: torch.from_numpy(arrays[k])
             for k in ("tri_pos_flat", "tri_attr", "em_tri_pos_flat",
                       "em_tri_attr")}
    tracer = make_tracer(len(arrays["tri_pos_flat"]))
    for got, want in (
            (tracer.trace(scene, ro, rd, max_t),
             tp.brute_force(scene["tri_pos_flat"], ro, rd, max_t, none,
                            none)),
            (tracer.shadow(scene, ro, rd, max_t),
             tp.shadow(scene["tri_pos_flat"], ro, rd, max_t, none, none)),
            (tracer.probe_info(scene, ro, rd, max_t),
             tp.brute_force_full(scene["em_tri_pos_flat"],
                                 scene["em_tri_attr"], ro, rd, max_t, none,
                                 none))):
        assert got.keys() == want.keys()
        for k in want:
            assert torch.equal(got[k], want[k]), k


def test_make_tracer_refuses_large_scenes():
    """Above 768 triangles the brute-force engine is refused: the scene
    takes kernel 13's BVH walk (the reference's tile-cull engine, kind
    "cull")."""
    assert make_tracer(768).kind == "brute_force_pallas"
    assert make_tracer(769).kind == "cull"
