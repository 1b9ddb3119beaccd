"""The emissive light-BVH walk (hikari_tpu_torch/ops/sampling.py
walk_emissive_bvh) against hikari_tpu's on the same seeded positions,
rand_x and exclude_instance: `picked` and `count` bit for bit.

The port visits every leaf in DFS order at any emissive count; hikari_tpu
takes its unrolled walk up to SMALL_EMISSIVE_MAX (8) emissives and its
stackless walk of the emissive BVH above. Scenes of 9, 17 and 40 emissive
cubes over a plane (seeded places, the same in both packages) hold the
port against the stackless walk, each as compiled (the emissive BVH from
build_bvh's default builder) and after two host refits that move every
emitter (GpuScene.update_transforms rebuilds it with the LBVH builder, so
its leaf order changes); 4 emissives hold it against the unrolled walk;
and the lamp city of path CL. The scene arrays the two walks read are
first held equal word for word."""

from __future__ import annotations

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hikari_tpu.ops import sampling as ref_sampling
from hikari_tpu_torch.ops import sampling
from hikari_tpu_torch.renderer import SMALL_EMISSIVE_MAX
from tests.city_lamps import build_city_lamps
from tests.torch_threads import one_torch_thread  # noqa: F401

WALK_KEYS = ("em_packed", "em_bvh_packed", "em_leaf_order")
RAYS = 4096


def emitter_scene(package, n_em, t=0.0):
    """A 20 m plane and n_em emissive cubes (0.3 m, emissive (1, 0.9, 0.7,
    0.05): a light radius of ~4.7 m) at seeded places, each moved by t
    times its own seeded step."""
    scene_mod = importlib.import_module(f"{package}.models.scene")
    shapes = importlib.import_module(f"{package}.models.mesh")
    Mat = importlib.import_module(f"{package}.models.material") \
        .StandardMaterial
    T = scene_mod.make_transform
    rng = np.random.default_rng(n_em)
    places = rng.uniform((-10.0, 0.5, -10.0), (10.0, 3.0, 10.0), (n_em, 3))
    steps = rng.uniform(-4.0, 4.0, (n_em, 3)) * (1.0, 0.2, 1.0)
    sc = scene_mod.Scene()
    plane = sc.add_mesh(shapes.plane(20.0))
    cube = sc.add_mesh(shapes.cube(1.0))
    ground = sc.add_material(Mat.from_color(0.5, 0.5, 0.5))
    light = sc.add_material(Mat(emissive=(1.0, 0.9, 0.7, 0.05)))
    sc.spawn(plane, ground)
    for p, s in zip(places, steps):
        sc.spawn(cube, light, T(tuple(p + t * s), scale=(0.3, 0.3, 0.3)))
    return sc


def compiled_pair(n_em, refits):
    """(port arrays, hikari_tpu arrays) of the n_em-emitter scene after
    `refits` host refits."""
    out = []
    for package in ("hikari_tpu_torch", "hikari_tpu"):
        gpu = emitter_scene(package, n_em).compile()
        for k in range(refits):
            gpu = gpu.update_transforms(emitter_scene(package, n_em,
                                                      0.5 * (k + 1)))
        out.append(gpu.arrays)
    return out


def walk_inputs(arrays, seed, lo=(-12.0, -0.5, -12.0), hi=(12.0, 4.0, 12.0)):
    """Seeded positions in the box [lo, hi], rand_x in [0, 1) and
    exclude_instance: -1 or an emitter's instance, half each."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(lo, hi, (RAYS, 3)).astype(np.float32)
    rand_x = rng.random(RAYS).astype(np.float32)
    em_inst = arrays["em_instance"]
    excl = np.where(rng.random(RAYS) < 0.5, -1,
                    rng.choice(em_inst, RAYS)).astype(np.int32)
    return pos, rand_x, excl


def assert_walks_equal(port_arrays, ref_arrays, seed, **box):
    for k in WALK_KEYS:
        np.testing.assert_array_equal(port_arrays[k].view(np.int32),
                                      ref_arrays[k].view(np.int32),
                                      err_msg=k)
    pos, rand_x, excl = walk_inputs(port_arrays, seed, **box)
    want = ref_sampling.walk_emissive_bvh(
        {k: jnp.asarray(ref_arrays[k]) for k in WALK_KEYS},
        jnp.asarray(pos), jnp.asarray(rand_x), jnp.asarray(excl))
    got = sampling.walk_emissive_bvh(
        {k: torch.from_numpy(port_arrays[k]) for k in WALK_KEYS},
        torch.from_numpy(pos), torch.from_numpy(rand_x),
        torch.from_numpy(excl))
    picked, count = (g.numpy() for g in got)
    np.testing.assert_array_equal(picked, np.asarray(want[0]))
    np.testing.assert_array_equal(count.view(np.int32),
                                  np.asarray(want[1]).view(np.int32))
    # the scene is one where the pick is a real choice
    assert count.max() >= 2 and (picked >= 0).mean() > 0.3
    return picked, count


@pytest.mark.parametrize("refits", [0, 2], ids=["compiled", "refit"])
@pytest.mark.parametrize("n_em", [9, 17, 40])
def test_bvh_walk_matches_reference(n_em, refits):
    port, ref = compiled_pair(n_em, refits)
    assert len(port["em_packed"]) == n_em > SMALL_EMISSIVE_MAX
    assert_walks_equal(port, ref, seed=n_em + refits)


def test_refit_rebuilds_the_emissive_bvh_in_another_leaf_order():
    """The compile builds the emissive BVH with build_bvh's default (the
    native SAH builder where it builds) and the refit rebuilds it with the
    LBVH builder: the leaf order changes at the first refit, on both
    sides alike."""
    compiled, _ = compiled_pair(17, 0)
    port, ref = compiled_pair(17, 1)
    np.testing.assert_array_equal(port["em_leaf_order"],
                                  ref["em_leaf_order"])
    assert not np.array_equal(port["em_leaf_order"],
                              compiled["em_leaf_order"])


def test_unrolled_walk_below_the_bvh_walk_is_unchanged():
    """At most SMALL_EMISSIVE_MAX emissives hikari_tpu takes its own
    unrolled walk over every leaf in DFS order, and the port's walk
    equals it bit for bit."""
    port, ref = compiled_pair(4, 0)
    assert len(port["em_packed"]) <= SMALL_EMISSIVE_MAX
    assert_walks_equal(port, ref, seed=4)


def test_lamp_city_walk_matches_reference():
    """Path CL's 17 emissives (the Earth sphere and 16 lamp heads) on
    points over its streets."""
    port = build_city_lamps("hikari_tpu_torch").compile().arrays
    ref = build_city_lamps("hikari_tpu").compile().arrays
    picked, count = assert_walks_equal(port, ref, seed=17,
                                       lo=(-16.0, 0.0, -6.0),
                                       hi=(16.0, 3.5, 6.0))
    assert count.max() >= 4
