"""Kernel 13 (csrc/trace_bvh.cu): the tracer of scenes above 768
triangles, and its plain version.

The port of hikari_tpu/ops/trace_cull.py (the tile-cull engine,
`cull_trace`) in its three modes, over the world BVH the scene compiler
already builds (`bvh_packed`): the TPU engine's cluster lists, packed rows
and octant sort exist because the TPU has no per-lane gather, and the
card's form of the same function is the reference's per-ray stackless walk
(hikari_tpu/ops/trace.py:traverse_bvh):

* `bvh_closest` (mode hit): the nearest accepted hit (t, u, v, triangle
  index, instance);
* `bvh_full` (mode full): the same hit with the winner's interpolated
  normal and uv and its material;
* `bvh_shadow` (mode shadow): the nearest occluder (t, instance) below
  max_t, division-free (every test times |det|, as kernel 7).

The contract: each ray walks the nodes from 0; a node is visited when its
slab entry t (make_ray's safe inverse) is below the bound: max_t and the
nearest hit so far (in shadow mode aabb_t < max_t and aabb_t * |det|_best <
t_d,best, so the walk has no division); a leaf tests its triangle with the
masks of kernels 5-7; the next node is the first child after a visited
inner node, else the exit link. A triangle wins only when strictly nearer,
so on an exact tie the first in walk order wins (kernels 5-7 take the
lowest index, the TPU the first cluster). cull_trace's clamp of max_t at
the scene box's exit changes no hit (the root's slab test bounds the walk
the same way) and is not ported; its early_distance is ignored there too.

The plain version is traverse_bvh's lockstep loop: every ray still walking
steps one node per iteration (the finished ones drop out), through
trace_pallas's Moller-Trumbore terms, so it repeats the kernel's arithmetic
operation by operation. It can also count the node visits and the
triangle tests of a call (the work the kernel's bound is made of). A
wrapper runs the plain version for CPU tensors and launches its kernel for
CUDA tensors.
"""

from __future__ import annotations

import torch

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


def walk_plain(mode, bvh, tris, attrs, ro, rd, max_t, excl, incl,
               stats=None):
    """The walk of every ray in lockstep. Returns the mode's outputs as the
    kernel writes them: hit {t, u, v, prim, inst}; full {t, prim, normal
    [N,3] unnormalized, uv [N,2], mat (float id, -1 on a miss), inst};
    shadow {t, inst} (ids int32; a miss has t F32_MAX and ids -1). With a
    dict `stats`, adds its node visits ("nodes") and triangle tests
    ("tests")."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r}")
    n, dev = ro.shape[0], ro.device
    n_nodes = bvh.shape[0]
    inv = safe_inverse(rd)
    ex, inc = excl.to(torch.float32), incl.to(torch.float32)
    shadow = mode == "shadow"
    if shadow:
        td = torch.full((n,), F32_MAX, device=dev)
        ads = torch.ones((n,), device=dev)
    else:
        td = torch.full((n,), F32_MAX, device=dev)          # t_best
        u = torch.zeros((n,), device=dev)
        v = torch.zeros((n,), device=dev)
        prim = torch.full((n,), -1, dtype=torch.int64, device=dev)
    inst = torch.full((n,), -1.0, device=dev)
    idx = torch.zeros((n,), dtype=torch.int64, device=dev)
    sel = torch.arange(n, device=dev)
    nodes = tests = 0
    while sel.numel():
        node = bvh[idx[sel]]
        mt = max_t[sel]
        te = _slab_entry(ro[sel], inv[sel], node)
        if shadow:
            visit = (te < mt) & (te * ads[sel] < td[sel])
        else:
            visit = (te < mt) & (te < td[sel])
        leaf = node[:, 6] > 0.5
        payload = torch.round(node[:, 7]).to(torch.int64)
        exit_ = torch.round(node[:, 8]).to(torch.int64)
        nodes += sel.numel()
        # the leaves visited whose triangle the masks accept
        lv = leaf & visit
        k = sel[lv]
        row = tris[payload[lv]]
        inst_i = row[:, 9]
        accept = (inst_i >= 0.0) & _tp._accepts(inst_i, ex[k], inc[k])
        if bool(accept.any()):
            k, row, inst_i = k[accept], row[accept], inst_i[accept]
            tests += k.numel()
            v0 = row[:, 0:3]
            terms = _tp.mt_terms(ro[k].unbind(-1), rd[k].unbind(-1),
                                 v0.unbind(-1), (row[:, 3:6] - v0).unbind(-1),
                                 (row[:, 6:9] - v0).unbind(-1))
            if shadow:
                ok, tdk, adk = _tp.shadow_accept(terms, max_t[k], td[k],
                                                 ads[k])
                ads[k] = torch.where(ok, adk, ads[k])
            else:
                ok, uk, vk, tdk = _tp.closest_accept(terms, max_t[k], td[k])
                u[k] = torch.where(ok, uk, u[k])
                v[k] = torch.where(ok, vk, v[k])
                prim[k] = torch.where(ok, payload[lv][accept], prim[k])
            td[k] = torch.where(ok, tdk, td[k])
            inst[k] = torch.where(ok, inst_i, inst[k])
        nxt = torch.where(leaf | ~visit, exit_, payload)
        idx[sel] = nxt
        sel = sel[nxt < n_nodes]
    if stats is not None:
        stats["nodes"] = stats.get("nodes", 0) + nodes
        stats["tests"] = stats.get("tests", 0) + tests
    ids = torch.round(inst).to(torch.int32)
    if shadow:
        return {"t": torch.where(inst >= 0.0, div(td, ads), F32_MAX),
                "inst": ids}
    prim = prim.to(torch.int32)
    if mode == "hit":
        return {"t": td, "u": u, "v": v, "prim": prim, "inst": ids}
    normal, uv, mat = _tp.interpolate(attrs, prim, u, v)
    return {"t": td, "prim": prim, "normal": torch.stack(normal, -1),
            "uv": torch.stack(uv, -1), "mat": mat, "inst": ids}


def _check_rays(bvh, tris, ro, rd, max_t, excl, incl):
    dev = ro.device
    n = ro.shape[0]
    check("bvh", bvh, torch.float32, (bvh.shape[0], 9), dev)
    check("tris", tris, torch.float32, (tris.shape[0], 10), dev)
    check("ro", ro, torch.float32, (n, 3), dev)
    check("rd", rd, torch.float32, (n, 3), dev)
    check("max_t", max_t, torch.float32, (n,), dev)
    check("excl", excl, torch.int32, (n,), dev)
    check("incl", incl, torch.int32, (n,), dev)
    return dev, n


def _load():
    from hikari_tpu_torch.build import load_cuda

    return load_cuda("trace_bvh")


def bvh_closest(bvh, tris, ro, rd, max_t, excl, incl):
    """Kernel 13, mode hit: bvh [nodes,9] f32, tris [P,10] f32, ro/rd [N,3]
    f32, max_t [N] f32, excl/incl [N] int32. Returns walk_plain's hit
    dict; runs it for CPU tensors and launches hk_bvh_closest for CUDA
    tensors."""
    if on_cpu(ro):
        return walk_plain("hit", bvh, tris, None, ro, rd, max_t, excl, incl)
    dev, n = _check_rays(bvh, tris, ro, rd, max_t, excl, incl)
    out = {k: torch.empty(n, dtype=torch.float32, device=dev)
           for k in ("t", "u", "v")}
    out["prim"] = torch.empty(n, dtype=torch.int32, device=dev)
    out["inst"] = torch.empty(n, dtype=torch.int32, device=dev)
    fn = bind(_load(), "hk_bvh_closest", "pi" + "p" * 6 + "i" + "p" * 6)
    rc = fn(ptr(bvh), bvh.shape[0], ptr(tris), ptr(ro), ptr(rd), ptr(max_t),
            ptr(excl), ptr(incl), n, ptr(out["t"]), ptr(out["u"]),
            ptr(out["v"]), ptr(out["prim"]), ptr(out["inst"]), stream(dev))
    check_launch(rc, "bvh_closest")
    bvh_closest.launches += 1
    return out


bvh_closest.launches = 0


def bvh_full(bvh, tris, attrs, ro, rd, max_t, excl, incl):
    """Kernel 13, mode full: as bvh_closest with attrs [P,17] f32. Returns
    walk_plain's full dict; runs it for CPU tensors and launches
    hk_bvh_full for CUDA tensors."""
    if on_cpu(ro):
        return walk_plain("full", bvh, tris, attrs, ro, rd, max_t, excl,
                          incl)
    dev, n = _check_rays(bvh, tris, ro, rd, max_t, excl, incl)
    check("attrs", attrs, torch.float32, (tris.shape[0], 17), dev)

    def new(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev)

    out = {"t": new(n), "prim": new(n, dtype=torch.int32),
           "normal": new(n, 3), "uv": new(n, 2), "mat": new(n),
           "inst": new(n, dtype=torch.int32)}
    fn = bind(_load(), "hk_bvh_full", "pi" + "p" * 7 + "i" + "p" * 7)
    rc = fn(ptr(bvh), bvh.shape[0], ptr(tris), ptr(attrs), ptr(ro), ptr(rd),
            ptr(max_t), ptr(excl), ptr(incl), n, ptr(out["t"]),
            ptr(out["prim"]), ptr(out["normal"]), ptr(out["uv"]),
            ptr(out["mat"]), ptr(out["inst"]), stream(dev))
    check_launch(rc, "bvh_full")
    bvh_full.launches += 1
    return out


bvh_full.launches = 0


def bvh_shadow(bvh, tris, ro, rd, max_t, excl, incl):
    """Kernel 13, mode shadow: the arguments of bvh_closest. Returns
    walk_plain's shadow dict; runs it for CPU tensors and launches
    hk_bvh_shadow for CUDA tensors."""
    if on_cpu(ro):
        return walk_plain("shadow", bvh, tris, None, ro, rd, max_t, excl,
                          incl)
    dev, n = _check_rays(bvh, tris, ro, rd, max_t, excl, incl)
    out = {"t": torch.empty(n, dtype=torch.float32, device=dev),
           "inst": torch.empty(n, dtype=torch.int32, device=dev)}
    fn = bind(_load(), "hk_bvh_shadow", "pi" + "p" * 6 + "i" + "p" * 3)
    rc = fn(ptr(bvh), bvh.shape[0], ptr(tris), ptr(ro), ptr(rd), ptr(max_t),
            ptr(excl), ptr(incl), n, ptr(out["t"]), ptr(out["inst"]),
            stream(dev))
    check_launch(rc, "bvh_shadow")
    bvh_shadow.launches += 1
    return out


bvh_shadow.launches = 0
