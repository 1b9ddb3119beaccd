"""Kernel 13 (csrc/trace_bvh.cu): the tracer of scenes above 768
triangles, and its plain version.

The port of hikari_tpu/ops/trace_cull.py (the tile-cull engine,
`cull_trace`) in its three modes. The TPU engine's cluster lists, packed
rows and octant sort exist because the TPU has no per-lane gather; the
card's form of the same function is the reference's per-ray walk of the
world BVH (hikari_tpu/ops/trace.py:traverse_bvh):

* `bvh_closest` (mode hit): the nearest accepted hit (t, u, v, triangle
  index, instance);
* `bvh_full` (mode full): the same hit with the winner's interpolated
  normal and uv and its material;
* `bvh_shadow` (mode shadow): the nearest occluder (t, instance) below
  max_t, division-free (every test times |det|, as kernel 7).

The contract, `walk_plain`: each ray walks the stackless world BVH
`bvh_packed` from node 0; a node is visited when its slab entry t
(make_ray's safe inverse) is below the bound: max_t and the nearest hit so
far (in shadow mode aabb_t < max_t and aabb_t * |det|_best < t_d,best, so
the walk has no division); a leaf tests its triangle with the masks of
kernels 5-7; the next node is the first child after a visited inner node,
else the exit link. A triangle wins only when strictly nearer, so on an
exact tie the first in walk order wins (kernels 5-7 take the lowest index,
the TPU the first cluster). cull_trace's clamp of max_t at the scene box's
exit changes no hit (the root's slab test bounds the walk the same way)
and is not ported; its early_distance is ignored there too.

The kernel walks tables of its own with the same words (the argument is
in the port's csrc/trace_bvh.cu); the reference walks the world BVH.

walk_plain is traverse_bvh's lockstep loop: every ray still walking steps
one node per iteration (the finished ones drop out), through trace_pallas's
Moller-Trumbore terms, so it repeats the kernel's arithmetic operation by
operation. It can count the slab tests and the triangle tests of a
call (the work the kernel's bound is made of). A wrapper takes the scene
dict and runs walk_plain.
"""

from __future__ import annotations

import torch

from portbench.reference.hk.ops import trace_pallas as _tp
from portbench.reference.hk.ops._kernel import div
from portbench.reference.hk.utils.math import F32_MAX

MODES = ("hit", "full", "shadow")


def _slab_entry(o, inv, node):
    """intersects_aabb of rays o [M,3] (inverse directions inv) against
    node rows [M,9]: the entry t, F32_MAX on a miss (the kernel's order)."""
    t1 = (node[:, 0:3] - o) * inv
    t2 = (node[:, 3:6] - o) * inv
    lo = torch.minimum(t1, t2)
    hi = torch.maximum(t1, t2)
    t_min = torch.maximum(torch.maximum(lo[:, 0], lo[:, 1]), lo[:, 2])
    t_max = torch.minimum(torch.minimum(hi[:, 0], hi[:, 1]), hi[:, 2])
    hit = (t_max >= t_min) & (t_max >= 0.0)
    return torch.where(hit, t_min, F32_MAX)


def safe_inverse(rd):
    """make_ray's inverse direction: components below 1e-20 in magnitude
    become +-1e-20 first."""
    tiny = torch.where(rd < 0.0, -1e-20, 1e-20)
    return div(1.0, torch.where(torch.abs(rd) < 1e-20, tiny, rd))


def _new_state(shadow, n, dev):
    """A walk's running result: t_best (shadow: t_d,best and |det|_best),
    u, v, prim and instance."""
    st = {"td": torch.full((n,), F32_MAX, device=dev),
          "inst": torch.full((n,), -1.0, device=dev)}
    if shadow:
        st["ads"] = torch.ones((n,), device=dev)
    else:
        st["u"] = torch.zeros((n,), device=dev)
        st["v"] = torch.zeros((n,), device=dev)
        st["prim"] = torch.full((n,), -1, dtype=torch.int64, device=dev)
    return st


def _test_leaves(st, k, prim, row, rays):
    """The triangle tests of rays k at triangles prim, rows [v0, ab, ac,
    instance] ([M,10]), into the state st; returns the number of tests
    (those the masks let through)."""
    ro, rd, max_t, ex, inc = rays
    inst_i = row[:, 9]
    accept = (inst_i >= 0.0) & _tp._accepts(inst_i, ex[k], inc[k])
    if not bool(accept.any()):
        return 0
    k, row, inst_i, prim = k[accept], row[accept], inst_i[accept], prim[accept]
    terms = _tp.mt_terms(ro[k].unbind(-1), rd[k].unbind(-1),
                         row[:, 0:3].unbind(-1), row[:, 3:6].unbind(-1),
                         row[:, 6:9].unbind(-1))
    if "ads" in st:
        ok, tdk, adk = _tp.shadow_accept(terms, max_t[k], st["td"][k],
                                         st["ads"][k])
        st["ads"][k] = torch.where(ok, adk, st["ads"][k])
    else:
        ok, uk, vk, tdk = _tp.closest_accept(terms, max_t[k], st["td"][k])
        st["u"][k] = torch.where(ok, uk, st["u"][k])
        st["v"][k] = torch.where(ok, vk, st["v"][k])
        st["prim"][k] = torch.where(ok, prim, st["prim"][k])
    st["td"][k] = torch.where(ok, tdk, st["td"][k])
    st["inst"][k] = torch.where(ok, inst_i, st["inst"][k])
    return k.numel()


def _visit(st, te, mt, k):
    """The walk's node test of rays k with slab entries te: below max_t mt
    and the nearest hit (shadow: te * |det|_best < t_d,best)."""
    if "ads" in st:
        return (te < mt) & (te * st["ads"][k] < st["td"][k])
    return (te < mt) & (te < st["td"][k])


def _result(mode, st, attrs):
    """The mode's outputs as the kernel writes them."""
    inst = st["inst"]
    ids = torch.round(inst).to(torch.int32)
    if mode == "shadow":
        return {"t": torch.where(inst >= 0.0, div(st["td"], st["ads"]),
                                 F32_MAX), "inst": ids}
    prim = st["prim"].to(torch.int32)
    u, v = st["u"], st["v"]
    if mode == "hit":
        return {"t": st["td"], "u": u, "v": v, "prim": prim, "inst": ids}
    normal, uv, mat = _tp.interpolate(attrs, prim, u, v)
    return {"t": st["td"], "prim": prim, "normal": torch.stack(normal, -1),
            "uv": torch.stack(uv, -1), "mat": mat, "inst": ids}


def _count(stats, nodes, tests):
    if stats is not None:
        stats["nodes"] = stats.get("nodes", 0) + nodes
        stats["tests"] = stats.get("tests", 0) + tests


def _stackless(st, rays, inv, sel, n_nodes, node_of, tri_of):
    """The stackless walk of rays `sel` from node 0, one node per step in
    lockstep: node_of(indices) gives (boxes [M,6], leaf flags, the leaf's
    triangle or the inner node's first child, exit links), tri_of(triangles)
    the rows [v0, ab, ac, instance]. Returns (node visits, triangle
    tests)."""
    ro, _, max_t, _, _ = rays
    idx = torch.zeros_like(sel)
    nodes = tests = 0
    while sel.numel():
        box, leaf, payload, exit_ = node_of(idx)
        te = _slab_entry(ro[sel], inv[sel], box)
        visit = _visit(st, te, max_t[sel], sel)
        nodes += sel.numel()
        lv = leaf & visit
        tests += _test_leaves(st, sel[lv], payload[lv], tri_of(payload[lv]),
                              rays)
        nxt = torch.where(leaf | ~visit, exit_, payload)
        keep = nxt < n_nodes
        sel, idx = sel[keep], nxt[keep]
    return nodes, tests


def walk_plain(mode, bvh, tris, attrs, ro, rd, max_t, excl, incl,
               stats=None):
    """The walk of every ray in lockstep. Returns the mode's outputs as the
    kernel writes them: hit {t, u, v, prim, inst}; full {t, prim, normal
    [N,3] unnormalized, uv [N,2], mat (float id, -1 on a miss), inst};
    shadow {t, inst} (ids int32; a miss has t F32_MAX and ids -1). With a
    dict `stats`, adds its node visits ("nodes", one slab test each) and
    triangle tests ("tests")."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r}")
    n, dev = ro.shape[0], ro.device
    rays = (ro, rd, max_t, excl.to(torch.float32), incl.to(torch.float32))
    st = _new_state(mode == "shadow", n, dev)

    def node_of(idx):       # rows [min3, max3, is_leaf, payload, exit]
        node = bvh[idx]
        return (node[:, 0:6], node[:, 6] > 0.5,
                torch.round(node[:, 7]).to(torch.int64),
                torch.round(node[:, 8]).to(torch.int64))

    def tri_of(prim):
        row = tris[prim]
        v0 = row[:, 0:3]
        return torch.cat([v0, row[:, 3:6] - v0, row[:, 6:9] - v0,
                          row[:, 9:]], 1)

    _count(stats, *_stackless(st, rays, safe_inverse(rd),
                              torch.arange(n, device=dev), bvh.shape[0],
                              node_of, tri_of))
    return _result(mode, st, attrs)


def bvh_closest(scene, ro, rd, max_t, excl, incl):
    """Kernel 13, mode hit: the scene dict (bvh_packed, tri_pos_flat),
    ro/rd [N,3] f32, max_t [N] f32, excl/incl [N] int32. Returns
    walk_plain's hit dict."""
    return walk_plain("hit", scene["bvh_packed"], scene["tri_pos_flat"],
                      None, ro, rd, max_t, excl, incl)


def bvh_full(scene, ro, rd, max_t, excl, incl):
    """Kernel 13, mode full: as bvh_closest, with tri_attr. Returns
    walk_plain's full dict."""
    return walk_plain("full", scene["bvh_packed"], scene["tri_pos_flat"],
                      scene["tri_attr"], ro, rd, max_t, excl, incl)


def bvh_shadow(scene, ro, rd, max_t, excl, incl):
    """Kernel 13, mode shadow: the arguments of bvh_closest. Returns
    walk_plain's shadow dict."""
    return walk_plain("shadow", scene["bvh_packed"],
                      scene["tri_pos_flat"], None, ro, rd, max_t, excl,
                      incl)

