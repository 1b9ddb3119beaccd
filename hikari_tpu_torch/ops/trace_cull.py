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

The kernel walks other tables with the same words (models/walk_tables.py,
the argument in csrc/trace_bvh.cu): a warp with a ray included to an
instance that has a subtree walks 3-wide nodes whose slots keep the binary
DFS order, that ray through its emitter's subtree, and every other warp
walks the world's rows as float4s, stackless; triangle rows come with
their edges subtracted. `walk_tables_plain` is that walk in lockstep, with
the kernel's warps, pushes, pops and re-tests; it counts its own work, and
the CPU tests hold it to `walk_plain` word for word.

walk_plain is traverse_bvh's lockstep loop: every ray still walking steps
one node per iteration (the finished ones drop out), through trace_pallas's
Moller-Trumbore terms, so it repeats the kernel's arithmetic operation by
operation. Both walks can count the slab tests and the triangle tests of a
call (the work the kernel's bound is made of). A wrapper takes the scene
dict, runs walk_plain for CPU tensors and launches its kernel for CUDA
tensors.
"""

from __future__ import annotations

import torch

from hikari_tpu_torch.models import walk_tables as _wt
from hikari_tpu_torch.ops import trace_pallas as _tp
from hikari_tpu_torch.ops._kernel import (bind, check, check_launch, div,
                                          on_cpu, ptr, stream)
from hikari_tpu_torch.utils.math import F32_MAX

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


def _walk_wide(st, wide, tri_of, rays, inv, sel, node):
    """The kernel's walk of the 3-slot nodes for rays `sel` from their
    nodes `node` in lockstep: expanding a node slab-tests its slots and
    pushes those below the bound (shadow mode: below max_t only), the last
    slot first; a popped slot is tested again against the bound of that
    moment, then tests its triangle (a leaf) or is expanded. Returns (slab
    tests, triangle tests)."""
    ro, _, max_t, _, _ = rays
    shadow = "ads" in st
    m, dev = sel.numel(), sel.device
    depth = _wt.WALK_STACK + _wt.WIDTH
    stack_ref = torch.zeros((m, depth), dtype=torch.int64, device=dev)
    stack_te = torch.zeros((m, depth), device=dev)
    sp = torch.zeros((m,), dtype=torch.int64, device=dev)
    slots = torch.arange(_wt.WIDTH, device=dev)
    live = torch.arange(m, device=dev)          # positions in sel
    nodes = tests = 0
    while live.numel():
        e = live[node[live] >= 0]               # expand
        if e.numel():
            rows = wide[node[e][:, None] * _wt.WIDTH + slots]   # [E,3,8]
            ref = torch.round(rows[..., 3]).to(torch.int64)
            ray = sel[e].repeat_interleave(_wt.WIDTH)
            te = _slab_entry(ro[ray], inv[ray],
                             rows.reshape(-1, 8)[:, [0, 1, 2, 4, 5, 6]]
                             ).reshape(-1, _wt.WIDTH)
            below = te < max_t[sel[e]][:, None]
            if not shadow:
                below &= te < st["td"][sel[e]][:, None]
            push = (ref != 0) & below
            nodes += int((ref != 0).sum())
            for k in reversed(range(_wt.WIDTH)):
                q = e[push[:, k]]
                stack_ref[q, sp[q]] = ref[push[:, k], k]
                stack_te[q, sp[q]] = te[push[:, k], k]
                sp[q] += 1
            node[e] = -1
        p = live[sp[live] > 0]                  # pop
        sp[p] -= 1
        ref = stack_ref[p, sp[p]]
        visit = _visit(st, stack_te[p, sp[p]], max_t[sel[p]], sel[p])
        lv = visit & (ref < 0)
        prim = -ref[lv] - 1
        tests += _test_leaves(st, sel[p[lv]], prim, tri_of(prim), rays)
        inner = visit & (ref > 0)
        node[p[inner]] = ref[inner]
        live = live[(node[live] >= 0) | (sp[live] > 0)]
    return nodes, tests


def walk_tables_plain(mode, scene, ro, rd, max_t, excl, incl, stats=None):
    """The kernel's walk of its tables (models/walk_tables.py) for every
    ray in lockstep; returns walk_plain's outputs. Rays go in warps of 32
    (the kernel's threads): a warp in which some ray is included to an
    instance with a subtree (`bvh_sub_root` > 0) walks the 3-slot nodes,
    that ray from its subtree's root and the others from the world's
    (_walk_wide); every other warp walks the world's binary rows
    `bvh_nodes` stackless, as walk_plain walks bvh_packed. With a dict
    `stats`, adds its slab tests ("nodes") and triangle tests ("tests")."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r}")
    bin_rows, sub_root = scene["bvh_nodes"], scene["bvh_sub_root"]
    edges = scene["tri_edges"]
    n, dev = ro.shape[0], ro.device
    inv = safe_inverse(rd)
    rays = (ro, rd, max_t, excl.to(torch.float32), incl.to(torch.float32))
    st = _new_state(mode == "shadow", n, dev)
    has_sub = (incl >= 0) & (incl < sub_root.shape[0])
    root = torch.where(has_sub, sub_root[incl.clamp(0, sub_root.shape[0] - 1)
                                         .long()], 0).long()
    warp = torch.arange(n, device=dev) // 32
    subtrees = torch.zeros((n + 31) // 32, dtype=torch.int64,
                           device=dev).index_add_(0, warp, (root > 0).long())
    wide = subtrees[warp] > 0

    def tri_of(prim):
        row = edges[prim]
        return torch.cat([row[:, 0:3], row[:, 4:7], row[:, 8:11],
                          row[:, 3:4]], 1)

    def node_of(idx):
        node = bin_rows[idx]
        ref = torch.round(node[:, 3]).to(torch.int64)
        leaf = ref < 0
        return (node[:, [0, 1, 2, 4, 5, 6]], leaf,
                torch.where(leaf, -ref - 1, ref),
                torch.round(node[:, 7]).to(torch.int64))

    sel = torch.nonzero(wide).flatten()
    work_w = _walk_wide(st, scene["bvh_wide"], tri_of, rays, inv, sel,
                        root[sel].clone())
    work_b = _stackless(st, rays, inv, torch.nonzero(~wide).flatten(),
                        bin_rows.shape[0], node_of, tri_of)
    _count(stats, work_w[0] + work_b[0], work_w[1] + work_b[1])
    return _result(mode, st, scene["tri_attr_pad"][:, :17]
                   if mode == "full" else None)


def _launch_args(scene, ro, rd, max_t, excl, incl, attrs=False):
    """The kernel's tables and rays, checked: (device, ray count, the
    leading arguments of hk_bvh_* up to the ray count)."""
    dev = ro.device
    n = ro.shape[0]
    keys = _wt.TABLE_KEYS if attrs else _wt.TABLE_KEYS[:4]
    missing = [k for k in keys if k not in scene]
    if missing:
        raise ValueError(f"kernel 13 needs the scene's {', '.join(missing)} "
                         "(models/walk_tables.py)")
    nodes, wide, sub_root, edges = (scene[k] for k in _wt.TABLE_KEYS[:4])
    check("bvh_nodes", nodes, torch.float32, (nodes.shape[0], 8), dev)
    check("bvh_wide", wide, torch.float32, (wide.shape[0], 8), dev)
    if wide.shape[0] % _wt.WIDTH or not wide.shape[0]:
        raise ValueError(f"bvh_wide: {wide.shape[0]} rows, not whole nodes")
    check("bvh_sub_root", sub_root, torch.int32, (sub_root.shape[0],), dev)
    check("tri_edges", edges, torch.float32, (edges.shape[0], 12), dev)
    args = [ptr(nodes), nodes.shape[0], ptr(wide), ptr(sub_root),
            sub_root.shape[0], ptr(edges)]
    if attrs:
        pad = scene["tri_attr_pad"]
        check("tri_attr_pad", pad, torch.float32, (edges.shape[0], 20), dev)
        args.append(ptr(pad))
    check("ro", ro, torch.float32, (n, 3), dev)
    check("rd", rd, torch.float32, (n, 3), dev)
    check("max_t", max_t, torch.float32, (n,), dev)
    check("excl", excl, torch.int32, (n,), dev)
    check("incl", incl, torch.int32, (n,), dev)
    args += [ptr(ro), ptr(rd), ptr(max_t), ptr(excl), ptr(incl), n]
    return dev, n, args


def _load():
    from hikari_tpu_torch.build import load_cuda

    return load_cuda("trace_bvh")


def bvh_closest(scene, ro, rd, max_t, excl, incl):
    """Kernel 13, mode hit: the scene dict (bvh_packed, tri_pos_flat for
    the plain version; bvh_nodes, bvh_wide, bvh_sub_root, tri_edges for
    the kernel),
    ro/rd [N,3] f32, max_t [N] f32, excl/incl [N] int32. Returns
    walk_plain's hit dict; runs it for CPU tensors and launches
    hk_bvh_closest for CUDA tensors."""
    if on_cpu(ro):
        return walk_plain("hit", scene["bvh_packed"], scene["tri_pos_flat"],
                          None, ro, rd, max_t, excl, incl)
    dev, n, args = _launch_args(scene, ro, rd, max_t, excl, incl)
    out = {k: torch.empty(n, dtype=torch.float32, device=dev)
           for k in ("t", "u", "v")}
    out["prim"] = torch.empty(n, dtype=torch.int32, device=dev)
    out["inst"] = torch.empty(n, dtype=torch.int32, device=dev)
    fn = bind(_load(), "hk_bvh_closest", "pippip" + "p" * 5 + "i" + "p" * 6)
    rc = fn(*args, ptr(out["t"]), ptr(out["u"]), ptr(out["v"]),
            ptr(out["prim"]), ptr(out["inst"]), stream(dev))
    check_launch(rc, "bvh_closest")
    bvh_closest.launches += 1
    return out


bvh_closest.launches = 0


def bvh_full(scene, ro, rd, max_t, excl, incl):
    """Kernel 13, mode full: as bvh_closest, with tri_attr for the plain
    version and tri_attr_pad for the kernel. Returns walk_plain's full
    dict; runs it for CPU tensors and launches hk_bvh_full for CUDA
    tensors."""
    if on_cpu(ro):
        return walk_plain("full", scene["bvh_packed"], scene["tri_pos_flat"],
                          scene["tri_attr"], ro, rd, max_t, excl, incl)
    dev, n, args = _launch_args(scene, ro, rd, max_t, excl, incl, True)

    def new(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev)

    out = {"t": new(n), "prim": new(n, dtype=torch.int32),
           "normal": new(n, 3), "uv": new(n, 2), "mat": new(n),
           "inst": new(n, dtype=torch.int32)}
    fn = bind(_load(), "hk_bvh_full", "pippipp" + "p" * 5 + "i" + "p" * 7)
    rc = fn(*args, ptr(out["t"]), ptr(out["prim"]), ptr(out["normal"]),
            ptr(out["uv"]), ptr(out["mat"]), ptr(out["inst"]), stream(dev))
    check_launch(rc, "bvh_full")
    bvh_full.launches += 1
    return out


bvh_full.launches = 0


def bvh_shadow(scene, ro, rd, max_t, excl, incl):
    """Kernel 13, mode shadow: the arguments of bvh_closest. Returns
    walk_plain's shadow dict; runs it for CPU tensors and launches
    hk_bvh_shadow for CUDA tensors."""
    if on_cpu(ro):
        return walk_plain("shadow", scene["bvh_packed"],
                          scene["tri_pos_flat"], None, ro, rd, max_t, excl,
                          incl)
    dev, n, args = _launch_args(scene, ro, rd, max_t, excl, incl)
    out = {"t": torch.empty(n, dtype=torch.float32, device=dev),
           "inst": torch.empty(n, dtype=torch.int32, device=dev)}
    fn = bind(_load(), "hk_bvh_shadow", "pippip" + "p" * 5 + "i" + "p" * 3)
    rc = fn(*args, ptr(out["t"]), ptr(out["inst"]), stream(dev))
    check_launch(rc, "bvh_shadow")
    bvh_shadow.launches += 1
    return out


bvh_shadow.launches = 0
