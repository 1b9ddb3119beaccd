"""Kernel 13's tables (hikari_tpu_torch/models/walk_tables.py) on the city:
their boxes contain what they should, the walk of them in the kernel's
order (trace_cull.walk_tables_plain) gives walk_plain's words over
bvh_packed in every mode, and the device refit rebuilds them as the scene
compiler derives them.

The rays are tests/test_torch_trace_cull.py's city_rays at a smaller size:
camera, incoherent and probe rays (include-masked to the sphere or -2),
with excludes and finite max_t on a share of them."""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from hikari_tpu_torch.examples import city
from hikari_tpu_torch.models import walk_tables as wt
from hikari_tpu_torch.models.refit_device import DeviceRefitter
from hikari_tpu_torch.ops import trace_cull as tc
from tests.test_torch_trace_cull import city_rays
from tests.torch_threads import one_torch_thread  # noqa: F401

CSRC = Path(__file__).resolve().parents[1] / "hikari_tpu_torch" / "csrc"


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.fixture(scope="module")
def city_case():
    """The compiled city, its scene dict, and the scene dict after one CPU
    refit with the sphere turned."""
    gpu = city.build_scene(3).compile()
    scene = gpu.as_pytree("cpu")
    sc = city.rotate_sphere(city.build_scene(3), 0.5)
    vis = [i for i in sc.instances if i.visible]
    cur = np.stack([np.asarray(i.transform, np.float32) for i in vis])
    prev = np.stack([np.asarray(i.transform if i.prev_transform is None
                                else i.prev_transform, np.float32)
                     for i in vis])
    refitter = DeviceRefitter(gpu, "cpu")
    refit = {**scene, **refitter.update(_t(cur), _t(prev))}
    rays = tuple(_t(x) for x in city_rays(np.random.default_rng(7),
                                          camera_side=32, n_random=1024,
                                          n_probe=1024))
    return {"gpu": gpu, "compiled": scene, "refit": refit,
            "refitter": refitter, "rays": rays}


def _leaf_boxes(bvh_packed):
    """{triangle: its bvh_packed leaf box [6]}."""
    rows = bvh_packed[bvh_packed[:, 6] > 0.5]
    return dict(zip(np.rint(rows[:, 7]).astype(int), rows[:, :6]))


def _walk_leaves(wide, root):
    """The triangles under wide node `root`, in slot (DFS) order."""
    out = []
    for k in range(wt.WIDTH):
        ref = int(wide[root * wt.WIDTH + k, 3])
        if ref < 0:
            out.append(-ref - 1)
        elif ref > 0:
            out.extend(_walk_leaves(wide, ref))
    return out


@pytest.mark.parametrize("which", ["compiled", "refit"])
def test_inner_boxes_contain_their_leaves(city_case, which):
    """(a) Every inner slot's box contains the boxes of the slots of the
    node it points to, as floats, and every leaf slot's box is its
    triangle's bvh_packed leaf box; the world tree holds every leaf once
    in bvh_packed's DFS order, and the sphere's subtree the sphere's
    leaves in the same order; bvh_nodes are bvh_packed's rows."""
    scene = city_case[which]
    wide = scene["bvh_wide"].numpy()
    packed = scene["bvh_packed"].numpy()
    assert np.array_equal(scene["bvh_nodes"].numpy(), wt.node_rows(packed))
    leaf_box = _leaf_boxes(packed)
    ref = np.rint(wide[:, 3]).astype(np.int64)
    for s in np.nonzero(ref > 0)[0]:
        kids = wide[ref[s] * wt.WIDTH:(ref[s] + 1) * wt.WIDTH]
        kids = kids[kids[:, 3] != 0]
        assert (kids[:, 0:3] >= wide[s, 0:3]).all(), s
        assert (kids[:, 4:7] <= wide[s, 4:7]).all(), s
    for s in np.nonzero(ref < 0)[0]:
        box = leaf_box[-ref[s] - 1]
        assert np.array_equal(wide[s, 0:3], box[0:3]), s
        assert np.array_equal(wide[s, 4:7], box[3:6]), s
    assert (wide[ref == 0] == 0.0).all() and (wide[:, 7] == 0.0).all()
    dfs = np.rint(packed[packed[:, 6] > 0.5, 7]).astype(np.int64)
    assert np.array_equal(_walk_leaves(wide, 0), dfs)
    sub = scene["bvh_sub_root"].numpy()
    assert np.nonzero(sub)[0].tolist() == [city.SPHERE_INSTANCE]
    inst = np.rint(scene["tri_pos_flat"][:, 9].numpy()).astype(np.int64)
    assert np.array_equal(_walk_leaves(wide, sub[city.SPHERE_INSTANCE]),
                          dfs[inst[dfs] == city.SPHERE_INSTANCE])


@pytest.mark.parametrize("which", ["compiled", "refit"])
@pytest.mark.parametrize("mode", tc.MODES)
def test_table_walk_equals_the_world_walk(city_case, which, mode):
    """(b) The kernel's walk of the tables (warps of 32 rays on the
    3-slot nodes or the binary rows; pushes, pops and re-tests; the
    included sphere's rays from its subtree) equals walk_plain over
    bvh_packed on every output word, and tests the same triangles."""
    scene, rays = city_case[which], city_case["rays"]
    want_stats, got_stats = {}, {}
    want = tc.walk_plain(mode, scene["bvh_packed"], scene["tri_pos_flat"],
                         scene["tri_attr"], *rays, stats=want_stats)
    got = tc.walk_tables_plain(mode, scene, *rays, stats=got_stats)
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k].view(torch.int32),
                           want[k].view(torch.int32)), k
    assert float((got["inst"] >= 0).float().mean()) > 0.3
    assert got_stats["tests"] == want_stats["tests"]
    assert 0 < got_stats["nodes"] < want_stats["nodes"]


def test_refit_tables_equal_the_derived_ones(city_case):
    """(c) The refit's bvh_nodes, bvh_wide, tri_edges and tri_attr_pad equal the
    tables walk_tables derives from the refit's own bvh_packed,
    tri_pos_flat and tri_attr, and its plan is the one the refit's
    bvh_packed gives."""
    refit, refitter = city_case["refit"], city_case["refitter"]
    arrays = {k: v.numpy() for k, v in refit.items()}
    plan = wt.plan_of(arrays)
    for field in ("leaf_tri", "slot_ref", "slot_first", "slot_last",
                  "node_first", "node_last", "sub_root"):
        assert np.array_equal(getattr(plan, field),
                              getattr(refitter.walk_plan, field)), field
    derived = wt.tables(plan, arrays["bvh_packed"], arrays["tri_pos_flat"],
                        arrays["tri_attr"])
    for k in ("bvh_nodes", "bvh_wide", "tri_edges", "tri_attr_pad"):
        assert np.array_equal(arrays[k].view(np.int32),
                              derived[k].view(np.int32)), k
    # the sphere moved: its subtree's boxes did too
    assert not np.array_equal(arrays["bvh_wide"],
                              city_case["compiled"]["bvh_wide"].numpy())


def test_plan_raises_when_the_stack_is_short(city_case, monkeypatch):
    """A BVH deeper than the kernel's stack raises at table time; the
    Python bounds are the kernel's HK_STACK and HK_WIDTH."""
    src = (CSRC / "trace_bvh.cu").read_text()
    for name, value in (("HK_STACK", wt.WALK_STACK), ("HK_WIDTH", wt.WIDTH)):
        assert int(re.search(rf"#define {name} (\d+)", src).group(1)) == \
            value, name
    arrays = city_case["gpu"].arrays
    assert wt.plan_of(arrays).stack <= wt.WALK_STACK
    monkeypatch.setattr(wt, "WALK_STACK", 4)
    with pytest.raises(ValueError, match="stack"):
        wt.plan_of(arrays)


def test_wrappers_need_the_tables(city_case, monkeypatch):
    """On the kernel's branch a scene without kernel 13's tables raises;
    nothing falls back to the world walk."""
    monkeypatch.setattr(tc, "on_cpu", lambda t: False)
    scene = {k: v for k, v in city_case["compiled"].items()
             if k != "bvh_wide"}
    for fn in (tc.bvh_closest, tc.bvh_full, tc.bvh_shadow):
        with pytest.raises(ValueError, match="bvh_wide"):
            fn(scene, *city_case["rays"])
