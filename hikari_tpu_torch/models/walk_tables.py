"""Kernel 13's tables: the world BVH's rows in float4s, the world BVH
collapsed into 3-wide nodes, one subtree per emissive instance for the
include-masked probe rays, and the triangle and attribute rows in whole
float4s.

Everything is derived from the arrays the scene compiler already emits
(`bvh_packed`'s topology and boxes, `tri_pos_flat`, `tri_attr`,
`em_instance`), so hikari_tpu's arrays give the same tables
(`scene_from_arrays`), and the on-device refit rebuilds the boxes every
frame from a plan made once (models/refit_device.py).

Why the walk over these tables gives the world walk's words (the argument
is written out in csrc/trace_bvh.cu): a walk's outputs depend only on the
order in which it reaches the leaves and on each leaf's own slab test
against the bound of that moment, as long as every inner box contains its
leaves' boxes. So a node keeps its leaves in the binary DFS order, the
world tree's child boxes are `bvh_packed`'s own rows, a subtree node's box
is the union of the leaf boxes it keeps, and a subtree drops only leaves
its rays' include mask can never accept.

Tables (`tables(plan, bvh_packed, tri_pos_flat, tri_attr)`):

* `bvh_nodes` [N, 8] f32: `bvh_packed` row i as min xyz, ref, max xyz,
  exit, where ref is an inner node's first child or a leaf's -(triangle +
  1) (`node_rows`): the stackless walk's rows;
* `bvh_wide` [3 W, 8] f32: wide node w's child slot k at row 3 w + k:
  min xyz, ref, max xyz, 0, where ref is the child's wide node (> 0), a
  leaf's -(triangle + 1), or 0 for an empty slot. Node 0 is the world's
  root; the subtrees follow.
* `bvh_sub_root` [I] int32: instance i's subtree root, 0 for none (the
  world).
* `tri_edges` [P, 12] f32: v0 and the instance, v1 - v0, 0, v2 - v0, 0
  (the subtractions of mt_terms, done once).
* `tri_attr_pad` [P, 20] f32: `tri_attr`'s 17 floats and 3 zeros.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from hikari_tpu_torch.models.bvh import range_min_max

# slots per node: 3 beat 2 and 4 on the city's calls (PERF.md)
WIDTH = 3
# the kernel's per-thread stack (HK_STACK in csrc/trace_bvh.cu)
WALK_STACK = 64
# refs are stored as floats: exact integers up to 2^24
_MAX_REF = 1 << 24

TABLE_KEYS = ("bvh_nodes", "bvh_wide", "bvh_sub_root", "tri_edges",
              "tri_attr_pad")


@dataclasses.dataclass
class WalkPlan:
    """The static part of the tables (topology only).

    leaf_tri [m]: the triangle of each leaf position: the world's leaves in
    DFS order, then each subtree's kept leaves in DFS order.
    slot_ref [3 W]: each slot's ref (see the module docstring).
    slot_first / slot_last [3 W]: each slot's box as a range of leaf
    positions (empty slots: 0, 0).
    slot_node [3 W]: the `bvh_packed` row a world slot's box is, else -1.
    node_first / node_last [N]: each `bvh_packed` row's leaf positions.
    sub_root [I]: each instance's subtree root (0 for none).
    stack: the most stack entries the kernel's walk can hold at once."""

    leaf_tri: np.ndarray
    slot_ref: np.ndarray
    slot_first: np.ndarray
    slot_last: np.ndarray
    slot_node: np.ndarray
    node_first: np.ndarray
    node_last: np.ndarray
    sub_root: np.ndarray
    stack: int


def _children(b, left, right, leaf, count):
    """Binary node b's descendants that become one wide node's slots: its
    two children, then the inner slot with the most leaves (the first on a
    tie) replaced by its two children, up to WIDTH, in DFS order."""
    kids = [left[b], right[b]]
    while len(kids) < WIDTH:
        inner = [j for j, c in enumerate(kids) if not leaf[c]]
        if not inner:
            break
        j = max(inner, key=lambda j: (count[kids[j]], -j))
        c = kids[j]
        kids[j:j + 1] = [left[c], right[c]]
    return kids


def _collapse(root, left, right, leaf, count, first, last, tri, base):
    """A binary tree (child arrays, leaf flags, leaf counts, leaf ranges,
    each leaf's triangle) as wide nodes numbered from `base` in DFS order:
    a list of [(ref, first, last, binary node)] per wide node, and the
    stack the walk of it needs."""
    nodes = []
    need = 0

    def build(b, depth):
        nonlocal need
        idx = len(nodes)
        nodes.append(None)
        kids = [b] if leaf[b] else _children(b, left, right, leaf, count)
        need = max(need, depth + len(kids) - 1)
        slots = []
        for k, c in enumerate(kids):
            # the first child is taken at once, the others wait below it
            ref = (-(tri[c] + 1) if leaf[c]
                   else base + build(c, depth + len(kids) - 1 - k))
            slots.append((ref, first[c], last[c], c))
        nodes[idx] = slots
        return idx

    build(root, 0)
    return nodes, need


def plan(bvh_packed, tri_instance, em_instance, num_instances) -> WalkPlan:
    """The plan of a compiled scene: `bvh_packed` [N, 9] (DFS pre-order,
    first child at i + 1, exit links), each triangle's instance id, the
    emissive instance ids (-1 padding allowed) and the instance count.
    Raises ValueError when the walk needs more than WALK_STACK stack
    entries or a ref does not fit a float."""
    bvh_packed = np.asarray(bvh_packed, np.float32)
    n = len(bvh_packed)
    leaf = bvh_packed[:, 6] > 0.5
    payload = np.rint(bvh_packed[:, 7]).astype(np.int64)
    exit_ = np.rint(bvh_packed[:, 8]).astype(np.int64)
    inner = ~leaf
    left = np.where(inner, payload, -1)
    right = np.full(n, -1, np.int64)
    right[inner] = exit_[payload[inner]]
    cum = np.concatenate([[0], np.cumsum(leaf)])
    first = cum[:n].copy()
    last = cum[exit_] - 1
    count = last - first + 1
    leaf_tri = payload[leaf]                    # by DFS leaf position
    tri_of = np.where(leaf, payload, -1)
    if n >= _MAX_REF or len(tri_instance) >= _MAX_REF:
        raise ValueError("kernel 13's tables hold refs below 2^24")

    world, need = _collapse(0, left, right, leaf, count, first, last,
                            tri_of, 0)
    wide = list(world)
    leaf_parts = [leaf_tri]
    sub_root = np.zeros(num_instances, np.int64)
    inst_of_leaf = np.asarray(tri_instance)[leaf_tri]
    for k in sorted({int(e) for e in np.asarray(em_instance) if e >= 0}):
        kept = np.concatenate([[0], np.cumsum(inst_of_leaf == k)])
        sub_first, sub_last = kept[first], kept[last + 1] - 1
        held = sub_last >= sub_first
        if not held[0]:
            continue
        # each kept node's children in the subtree: its kept children,
        # each followed down while it keeps exactly one child
        def down(c):
            while not leaf[c] and held[left[c]] != held[right[c]]:
                c = left[c] if held[left[c]] else right[c]
            return c

        s_left = np.full(n, -1, np.int64)
        s_right = np.full(n, -1, np.int64)
        both = np.zeros(n, bool)
        both[inner] = held[left[inner]] & held[right[inner]]
        for b in np.nonzero(both)[0]:
            s_left[b], s_right[b] = down(left[b]), down(right[b])
        offset = sum(len(p) for p in leaf_parts)
        nodes, sneed = _collapse(
            down(0), s_left, s_right, leaf, sub_last - sub_first + 1,
            sub_first + offset, sub_last + offset, tri_of, len(wide))
        sub_root[k] = len(wide)
        wide.extend([(ref, f, l, -1) for ref, f, l, _ in slots]
                    for slots in nodes)
        leaf_parts.append(leaf_tri[inst_of_leaf == k])
        need = max(need, sneed)
    if need > WALK_STACK:
        raise ValueError(f"kernel 13's walk of this BVH needs {need} stack "
                         f"entries, more than its {WALK_STACK}")
    if len(wide) >= _MAX_REF:
        raise ValueError("kernel 13's tables hold refs below 2^24")
    slots = np.zeros((len(wide), WIDTH, 4), np.int64)
    slots[:, :, 3] = -1
    for w, s in enumerate(wide):
        slots[w, :len(s)] = s
    slots = slots.reshape(-1, 4)
    return WalkPlan(leaf_tri=np.concatenate(leaf_parts),
                    slot_ref=slots[:, 0], slot_first=slots[:, 1],
                    slot_last=slots[:, 2], slot_node=slots[:, 3],
                    node_first=first, node_last=last, sub_root=sub_root,
                    stack=need)


def plan_of(arrays) -> WalkPlan:
    """The plan of a compiled scene's arrays."""
    return plan(arrays["bvh_packed"],
                np.rint(arrays["tri_pos_flat"][:, 9]).astype(np.int64),
                arrays["em_instance"], len(arrays["inst_prim_offset"]))


def edge_rows(tri_pos_flat) -> np.ndarray:
    """[P, 12]: v0 + instance, v1 - v0 + 0, v2 - v0 + 0."""
    t = np.asarray(tri_pos_flat, np.float32)
    z = np.zeros((len(t), 1), np.float32)
    return np.concatenate([t[:, 0:3], t[:, 9:10], t[:, 3:6] - t[:, 0:3], z,
                           t[:, 6:9] - t[:, 0:3], z], 1)


def attr_rows(tri_attr) -> np.ndarray:
    """[P, 20]: the 17 attribute floats and 3 zeros."""
    a = np.asarray(tri_attr, np.float32)
    return np.concatenate([a, np.zeros((len(a), 3), np.float32)], 1)


def node_rows(bvh_packed) -> np.ndarray:
    """[N, 8]: bvh_packed's rows as two float4s: min xyz and the ref (an
    inner node's first child, a leaf's -(triangle + 1)), max xyz and the
    exit link."""
    b = np.asarray(bvh_packed, np.float32)
    ref = np.where(b[:, 6] > 0.5, -(b[:, 7] + 1.0), b[:, 7])
    return np.concatenate([b[:, 0:3], ref[:, None], b[:, 3:6], b[:, 8:9]],
                          1).astype(np.float32)


def tables(p: WalkPlan, bvh_packed, tri_pos_flat, tri_attr) -> dict:
    """The tables of plan p from the scene's current arrays: a world slot's
    box is its `bvh_packed` row, a subtree slot's the union of its leaves'
    `bvh_packed` rows (numpy, vectorized: the host refit recomputes them
    every frame from a plan made once; the device refit computes the same
    words with its own pyramid)."""
    bvh_packed = np.asarray(bvh_packed, np.float32)
    leaf_rows = np.nonzero(bvh_packed[:, 6] > 0.5)[0]
    # leaf position -> its bvh_packed row (the subtrees' leaves are world
    # leaves again)
    row_of_tri = np.zeros(int(p.leaf_tri.max()) + 1, np.int64)
    row_of_tri[np.rint(bvh_packed[leaf_rows, 7]).astype(np.int64)] = leaf_rows
    leaf_box = bvh_packed[row_of_tri[p.leaf_tri], :6]
    lo = np.zeros((len(p.slot_ref), 3), np.float32)
    hi = np.zeros((len(p.slot_ref), 3), np.float32)
    world = p.slot_node >= 0
    lo[world] = bvh_packed[p.slot_node[world], 0:3]
    hi[world] = bvh_packed[p.slot_node[world], 3:6]
    sub = (p.slot_ref != 0) & ~world
    lo[sub], hi[sub] = range_min_max(leaf_box[:, :3], leaf_box[:, 3:],
                                     p.slot_first[sub], p.slot_last[sub])
    ref = p.slot_ref.astype(np.float32)[:, None]
    wide = np.concatenate([lo, ref, hi, np.zeros_like(ref)], 1)
    return {"bvh_nodes": node_rows(bvh_packed), "bvh_wide": wide,
            "bvh_sub_root": p.sub_root.astype(np.int32),
            "tri_edges": edge_rows(tri_pos_flat),
            "tri_attr_pad": attr_rows(tri_attr)}


def scene_tables(arrays) -> dict:
    """Kernel 13's tables of a compiled scene's arrays (numpy)."""
    return tables(plan_of(arrays), arrays["bvh_packed"],
                  arrays["tri_pos_flat"], arrays["tri_attr"])
