"""LBVH builder: Morton sort + Karras radix tree -> stackless entry/exit arrays.

Array semantics match the reference's flattened BVH exactly so the traversal
contract carries over (reference src/mesh_material/mod.rs:186-200 GpuNode::pack
+ the `bvh` crate's flatten: DFS pre-order; inner node -> entry = index of
first child (= own index + 1), exit = skip pointer past the subtree; leaf ->
entry = primitive_index | 0x80000000, exit = skip pointer; traversal loop in
light.wgsl:400-486).

The port's copy of hikari_tpu/models/bvh.py: the same vectorized numpy
LBVH and the same "auto" rule (native binned SAH when its library builds,
else LBVH), so the compiled tables equal hikari_tpu's.

Pipeline: centroids -> 30-bit Morton codes (keys made unique with index salt)
-> argsort -> Karras 2012 radix-tree ranges (vectorized binary searches) ->
closed-form DFS pre-order ranks (sort by (first_leaf, -last_leaf)) ->
node AABBs via idempotent range-min/max sparse-table queries.
"""

from __future__ import annotations

import dataclasses

import numpy as np

BVH_LEAF_FLAG = np.uint32(0x80000000)


@dataclasses.dataclass
class Bvh:
    """Flattened stackless BVH.

    Traversal contract (matches light.wgsl:400-440):
        index = 0
        while index < count:
            if entry[index] >= BVH_LEAF_FLAG:
                prim = entry[index] - BVH_LEAF_FLAG   # original primitive id
                <intersect prim>; index = exit[index]
            else:
                hit = ray vs (node_min[index], node_max[index])
                index = entry[index] if hit else exit[index]
    """

    node_min: np.ndarray  # [N,3] f32
    node_max: np.ndarray  # [N,3] f32
    entry: np.ndarray  # [N] u32 (leaf: prim | 0x80000000)
    exit: np.ndarray  # [N] u32
    # Topology kept for O(n) refit on animated scenes:
    first: np.ndarray  # [N] i64 — first sorted-leaf in subtree
    last: np.ndarray  # [N] i64 — last sorted-leaf in subtree
    prim_order: np.ndarray  # [num_prims] i64 — sorted-leaf -> original prim

    @property
    def count(self) -> int:
        return len(self.entry)


def _popcount64(x: np.ndarray) -> np.ndarray:
    bits = np.unpackbits(np.ascontiguousarray(x, dtype=np.uint64).view(np.uint8).reshape(-1, 8), axis=1)
    return bits.sum(axis=1).reshape(x.shape).astype(np.int64)


def _bit_length64(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint64).copy()
    for s in (1, 2, 4, 8, 16, 32):
        x |= x >> np.uint64(s)
    return _popcount64(x)


def _expand_bits(v: np.ndarray) -> np.ndarray:
    """Spread 10 bits of v so there are two zero bits between each."""
    v = v.astype(np.uint64)
    v = (v * np.uint64(0x00010001)) & np.uint64(0xFF0000FF)
    v = (v * np.uint64(0x00000101)) & np.uint64(0x0F00F00F)
    v = (v * np.uint64(0x00000011)) & np.uint64(0xC30C30C3)
    v = (v * np.uint64(0x00000005)) & np.uint64(0x49249249)
    return v


def morton3d(points: np.ndarray) -> np.ndarray:
    """[N,3] points in [0,1] -> 30-bit interleaved Morton codes (uint64)."""
    q = np.clip(points * 1024.0, 0.0, 1023.0).astype(np.uint64)
    return (_expand_bits(q[:, 0]) << np.uint64(2)) | (_expand_bits(q[:, 1]) << np.uint64(1)) | _expand_bits(q[:, 2])


def _karras_ranges(keys: np.ndarray):
    """Vectorized Karras 2012 radix-tree construction over unique sorted keys.

    Returns (first, last, split) for the n-1 internal nodes: node i covers
    sorted leaves [first_i, last_i] and splits after leaf `split_i` (left
    subtree = [first, split], right = [split+1, last]).
    """
    n = len(keys)
    m = n - 1  # internal node count
    i = np.arange(m, dtype=np.int64)

    def delta(a: np.ndarray, b: np.ndarray) -> np.ndarray:
        valid = (b >= 0) & (b < n)
        bc = np.clip(b, 0, n - 1)
        x = keys[a] ^ keys[bc]
        cpl = 64 - _bit_length64(x)
        return np.where(valid, cpl, -1).astype(np.int64)

    d = np.sign(delta(i, i + 1) - delta(i, i - 1)).astype(np.int64)
    d = np.where(d == 0, 1, d)  # unique keys make ties impossible; belt & braces
    delta_min = delta(i, i - d)

    # Upper bound on range length by doubling.
    l_max = np.full(m, 2, dtype=np.int64)
    while True:
        cond = delta(i, i + l_max * d) > delta_min
        if not cond.any():
            break
        l_max = np.where(cond, l_max * 2, l_max)

    # Binary search for exact length.
    l = np.zeros(m, dtype=np.int64)
    t = l_max // 2
    while (t >= 1).any():
        tt = np.maximum(t, 1)
        cond = (t >= 1) & (delta(i, i + (l + tt) * d) > delta_min)
        l = np.where(cond, l + tt, l)
        t = t // 2
    j = i + l * d

    # Binary search for the split position.
    delta_node = delta(i, j)
    s = np.zeros(m, dtype=np.int64)
    t = l.copy()
    done = l == 0
    while not done.all():
        t = (t + 1) >> 1
        cond = (~done) & (delta(i, i + (s + t) * d) > delta_node)
        s = np.where(cond, s + t, s)
        done |= t <= 1
    split = i + s * d + np.minimum(d, 0)

    first = np.minimum(i, j)
    last = np.maximum(i, j)
    return first, last, split


def range_min_max(leaf_min, leaf_max, first, last):
    """The union of the leaf boxes over each range [first, last] of leaf
    positions: the min and max of two power-of-2 windows (length
    2**floor(log2(last - first + 1)), from first and ending at last) of a
    sparse-table pyramid, one level in memory at a time. Min and max only,
    so the words equal a direct reduction's."""
    cur_min = np.asarray(leaf_min, np.float32)
    cur_max = np.asarray(leaf_max, np.float32)
    klev = np.floor(np.log2(last - first + 1)).astype(np.int64)
    lo = np.empty((len(first), 3), np.float32)
    hi = np.empty((len(first), 3), np.float32)
    for k in range(int(klev.max(initial=0)) + 1):
        if k:
            half = 1 << (k - 1)
            cur_min = np.minimum(cur_min[:-half], cur_min[half:])
            cur_max = np.maximum(cur_max[:-half], cur_max[half:])
        sel = klev == k
        if sel.any():
            f, e = first[sel], last[sel] - (1 << k) + 1
            lo[sel] = np.minimum(cur_min[f], cur_min[e])
            hi[sel] = np.maximum(cur_max[f], cur_max[e])
    return lo, hi


def _preorder_flatten(first, last, prim_order, leaf_min, leaf_max) -> Bvh:
    """Closed-form DFS pre-order flatten.

    In pre-order, node A precedes node B iff first_A < first_B, or
    first_A == first_B and last_A > last_B (ancestors before descendants on
    the same left spine). So the pre-order rank is just a lexicographic sort.
    exit (skip) pointer = rank + subtree size, where a subtree over k leaves
    has exactly 2k-1 nodes.
    """
    n = len(prim_order)
    if n == 1:
        node_min = leaf_min.astype(np.float32)
        node_max = leaf_max.astype(np.float32)
        entry = np.array([np.uint32(prim_order[0]) | BVH_LEAF_FLAG], dtype=np.uint32)
        exit_ = np.array([1], dtype=np.uint32)
        return Bvh(node_min, node_max, entry, exit_,
                   np.zeros(1, np.int64), np.zeros(1, np.int64), prim_order)

    m = n - 1
    total = 2 * n - 1
    all_first = np.concatenate([first, np.arange(n, dtype=np.int64)])
    all_last = np.concatenate([last, np.arange(n, dtype=np.int64)])
    is_leaf = np.zeros(total, dtype=bool)
    is_leaf[m:] = True

    order = np.lexsort((-all_last, all_first))  # pre-order node sequence
    rank = np.empty(total, dtype=np.int64)
    rank[order] = np.arange(total, dtype=np.int64)

    subtree = 2 * (all_last - all_first) + 1
    exit_ = (rank + subtree).astype(np.uint32)
    entry = np.where(
        is_leaf,
        (prim_order[np.clip(all_first, 0, n - 1)].astype(np.uint32) | BVH_LEAF_FLAG),
        (rank + 1).astype(np.uint32),
    )

    # node AABBs: sparse-table range min/max
    node_min, node_max = range_min_max(leaf_min, leaf_max, all_first,
                                       all_last)

    # Reorder into pre-order storage.
    out_min = np.empty_like(node_min)
    out_max = np.empty_like(node_max)
    out_entry = np.empty_like(entry)
    out_exit = np.empty_like(exit_)
    out_first = np.empty(total, dtype=np.int64)
    out_last = np.empty(total, dtype=np.int64)
    out_min[rank] = node_min
    out_max[rank] = node_max
    out_entry[rank] = entry
    out_exit[rank] = exit_
    out_first[rank] = all_first
    out_last[rank] = all_last
    return Bvh(out_min, out_max, out_entry, out_exit, out_first, out_last, prim_order)


def build_bvh(aabb_min: np.ndarray, aabb_max: np.ndarray,
              method: str = "auto") -> Bvh:
    """Build a flattened BVH over primitives given their AABBs.

    Replaces the reference's `BVH::build` + `flatten_custom(&GpuNode::pack)`
    calls for BLAS (src/mesh_material/mod.rs:458-459), TLAS
    (src/mesh_material/instance.rs:365-371) and the emissive light BVH
    (src/mesh_material/instance.rs:422-428).

    method: "auto" (native binned-SAH when available, else LBVH),
    "sah" (native, error if unavailable), or "lbvh" (vectorized numpy,
    used for per-frame rebuilds of dynamic scenes).
    """
    aabb_min = np.asarray(aabb_min, dtype=np.float64).reshape(-1, 3)
    aabb_max = np.asarray(aabb_max, dtype=np.float64).reshape(-1, 3)
    n = len(aabb_min)

    if method == "sah":
        raise RuntimeError("this copy builds every BVH as an LBVH in numpy")
    if n == 0:
        z3 = np.zeros((0, 3), np.float32)
        z = np.zeros((0,), np.uint32)
        zi = np.zeros((0,), np.int64)
        return Bvh(z3, z3, z, z, zi, zi, zi)

    centroids = 0.5 * (aabb_min + aabb_max)
    lo = centroids.min(axis=0)
    hi = centroids.max(axis=0)
    extent = np.where(hi - lo < 1e-12, 1.0, hi - lo)
    codes = morton3d((centroids - lo) / extent)
    # Salt with index to make keys unique (required by the radix tree).
    order = np.argsort(codes, kind="stable").astype(np.int64)
    keys = (codes[order] << np.uint64(22)) | np.arange(n, dtype=np.uint64)

    leaf_min = aabb_min[order]
    leaf_max = aabb_max[order]

    if n == 1:
        return _preorder_flatten(None, None, order, leaf_min, leaf_max)

    first, last, _split = _karras_ranges(keys)
    return _preorder_flatten(first, last, order, leaf_min, leaf_max)


def refit_bvh(bvh: Bvh, aabb_min: np.ndarray, aabb_max: np.ndarray) -> Bvh:
    """Recompute node AABBs for new primitive bounds, keeping topology.

    O(n log n) vectorized (range_min_max over each node's sorted-leaf
    range); used for animated scenes in place of a full rebuild.
    """
    node_min, node_max = range_min_max(
        np.asarray(aabb_min, np.float32)[bvh.prim_order],
        np.asarray(aabb_max, np.float32)[bvh.prim_order],
        bvh.first, bvh.last)
    return dataclasses.replace(bvh, node_min=node_min, node_max=node_max)
