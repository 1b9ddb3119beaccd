"""On-device transform update and BVH refit for animated scenes: the port
of hikari_tpu/models/refit_device.py without its cluster-table part (the
reference walks `bvh_packed` itself, so there are no cluster tables).

1. Local-space triangle and normal tables are built once on the host in
   float64 from the compiled scene.
2. Per update each table row takes its instance's model matrix by index
   (hikari_tpu selects it with a one-hot matmul on the MXU; an index gives
   the same matrix), and vertices and normals are transformed term by
   term: x' = R x + t, n' = (R^-1)^T n renormalized. Inverses, products
   and lengths are written out elementwise (no library inverse or
   matmul), so the refit rounds alike on the CPU and the card.
3. BVH node AABBs are refit with a sparse-table pyramid: a node's box is
   the union of two power-of-2 windows over its leaf range
   (models/bvh.refit_bvh's math), min/max only, so it is exact.
4. Instance AABBs come from the 8 transformed corners of the instance's
   local box (instance.rs:286-305).
5. `inst_motion`, the emissive positions and radii (`em_packed`) and the
   emissive-only probe tables are refreshed in their layouts; alias tables
   are scale-invariant under rigid motion and kept.

The emissive BVH is kept as compiled (the walk reads no inner box, and
its leaf order em_leaf_order stays). Above SMALL_EMISSIVE_MAX emissives
Renderer.update_scene takes the host refit instead
(GpuScene.update_transforms, which rebuilds the emissive BVH in LBVH
leaf order), as hikari_tpu does.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.hk.ops._kernel import div


def _corners() -> np.ndarray:
    """The 8 corners of the unit cube, (x, y, z) in {0, 1}, x slowest."""
    g = np.stack(np.meshgrid(np.arange(2.0), np.arange(2.0), np.arange(2.0),
                             indexing="ij"), -1)
    return g.reshape(8, 3).astype(np.float32)


def _apply(m, v):
    """m [N,3,3] applied to vectors v [N,V,3], term by term:
    out_i = m_i0 v_0 + m_i1 v_1 + m_i2 v_2."""
    return torch.stack([m[:, None, i, 0] * v[..., 0]
                        + m[:, None, i, 1] * v[..., 1]
                        + m[:, None, i, 2] * v[..., 2] for i in range(3)], -1)


def _cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def _length(v):
    return torch.sqrt(v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1]
                      + v[..., 2] * v[..., 2])


def affine_inverse(m):
    """The inverse of affine [N,4,4] matrices in closed form (the adjugate
    of the 3x3 part over its determinant, then -R^-1 t), elementwise only,
    so it rounds alike on every device."""
    r0, r1, r2 = m[:, 0, :3], m[:, 1, :3], m[:, 2, :3]
    c0, c1, c2 = _cross(r1, r2), _cross(r2, r0), _cross(r0, r1)
    det = (r0[:, 0] * c0[:, 0] + r0[:, 1] * c0[:, 1]
           + r0[:, 2] * c0[:, 2])[:, None, None]
    inv3 = div(torch.stack([c0, c1, c2], -1), det)   # columns c0 c1 c2
    t = -_apply(inv3, m[:, None, :3, 3])[:, 0]
    top = torch.cat([inv3, t[:, :, None]], -1)
    bottom = torch.zeros_like(m[:, 3:, :])
    bottom[:, 0, 3] = 1.0
    return torch.cat([top, bottom], 1)


def _matmul4(a, b):
    """[N,4,4] products term by term: out_ik = sum over j = 0..3 in order
    of a_ij b_jk."""
    out = a[:, :, 0, None] * b[:, None, 0, :]
    for j in range(1, 4):
        out = out + a[:, :, j, None] * b[:, None, j, :]
    return out


def leaf_ranges(bvh_packed):
    """(each leaf position's triangle, each row's first and last leaf
    position) of `bvh_packed` [N, 9] (DFS pre-order, first child at i + 1,
    exit links), the leaves numbered in DFS order."""
    bvh_packed = np.asarray(bvh_packed, np.float32)
    leaf = bvh_packed[:, 6] > 0.5
    payload = np.rint(bvh_packed[:, 7]).astype(np.int64)
    exit_ = np.rint(bvh_packed[:, 8]).astype(np.int64)
    cum = np.concatenate([[0], np.cumsum(leaf)])
    return payload[leaf], cum[:len(bvh_packed)].copy(), cum[exit_] - 1


class DeviceRefitter:
    """Precomputes the static local-space tables and the refit plan of a
    compiled GpuScene on `device`; `update(models, prev_models)` returns
    the scene tensors the new transforms change."""

    def __init__(self, gpu, device):
        a = gpu.arrays
        self.num_instances = gpu.num_instances
        self.num_triangles = n = gpu.num_triangles
        model0 = np.asarray(a["inst_model"], np.float64).reshape(-1, 4, 4)
        inv0 = np.linalg.inv(model0)

        def dev(x, dtype=torch.float32):
            return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype,
                                   device=device)

        # local-space triangle and normal tables (instance-grouped rows)
        tp = np.asarray(a["tri_pos_flat"], np.float64)
        inst = np.round(tp[:, 9]).astype(np.int64)
        valid = inst >= 0
        iid = np.clip(inst, 0, self.num_instances - 1)
        loc = (tp[:, :9].reshape(-1, 3, 3) @ inv0[iid, :3, :3].transpose(
            0, 2, 1) + inv0[iid, None, :3, 3])
        loc = np.where(valid[:, None, None], loc, tp[:, :9].reshape(-1, 3, 3))
        ta = np.asarray(a["tri_attr"], np.float64)
        # n_world = (R^-1)^T n_local, so n_local = R^T n_world
        nloc = ta[:, :9].reshape(-1, 3, 3) @ model0[iid, :3, :3]
        nloc = np.where(valid[:, None, None], nloc,
                        ta[:, :9].reshape(-1, 3, 3))
        self.tri_local = dev(loc.reshape(-1, 3, 3))
        self.nrm_local = dev(nloc.reshape(-1, 3, 3))
        self.tri_iid = dev(iid, torch.int64)
        self.tri_valid = dev(valid, torch.bool)
        self.tri_pos_tail = dev(a["tri_pos_flat"][:, 9:])
        self.tri_attr_tail = dev(a["tri_attr"][:, 9:])

        # tight local instance boxes, for the 8-corner world boxes
        offs, cnts = a["inst_prim_offset"], a["inst_prim_count"]
        lmin = np.stack([loc[o:o + c].reshape(-1, 3).min(axis=0)
                         for o, c in zip(offs, cnts)]).astype(np.float32)
        lmax = np.stack([loc[o:o + c].reshape(-1, 3).max(axis=0)
                         for o, c in zip(offs, cnts)]).astype(np.float32)
        corners = torch.as_tensor(_corners(), device=device)
        lo, hi = dev(lmin), dev(lmax)
        self.local_corners = lo[:, None, :] + corners[None] * (hi - lo)[:, None]

        # emissive statics
        self.num_emissives = gpu.num_emissives
        if gpu.num_emissives:
            em_inst = a["em_instance"]
            half_diag0 = 0.5 * np.linalg.norm(
                a["inst_aabb_max"][em_inst] - a["inst_aabb_min"][em_inst],
                axis=-1)
            self.em_instance = dev(em_inst, torch.int64)
            self.em_extra = dev((a["em_radius"] - half_diag0).astype(
                np.float32))
            self.em_packed0 = dev(a["em_packed"])
            self.em_rows = dev(np.nonzero(np.isin(inst, em_inst[em_inst >= 0]))
                               [0], torch.int64)
            self.em_pad_pos = dev(a["em_tri_pos_flat"][len(self.em_rows):])
            self.em_pad_attr = dev(a["em_tri_attr"][len(self.em_rows):])

        # the BVH refit plan (sparse-table windows, models/bvh.refit_bvh):
        # one pyramid over the world's leaf positions serves bvh_packed's
        # rows
        leaf_tri, first, last = leaf_ranges(a["bvh_packed"])
        m = len(leaf_tri)
        klev = np.floor(np.log2(last - first + 1)).astype(np.int64)
        self.num_levels = int(klev.max()) + 1
        level_off = np.zeros(self.num_levels + 1, np.int64)
        for k in range(self.num_levels):
            level_off[k + 1] = level_off[k] + (m - (1 << k) + 1)
        self.leaf_perm = dev(leaf_tri, torch.int64)
        self.fidx = dev(level_off[klev] + first, torch.int64)
        self.eidx = dev(level_off[klev] + last - (1 << klev) + 1,
                        torch.int64)
        self.bvh_tail = dev(a["bvh_packed"][:, 6:])

    def boxes(self, world):
        """bvh_packed [nodes,9] for the triangles world [P,3,3]: each box
        the union of two power-of-2 windows over its leaf positions."""
        v = world[:self.num_triangles]
        leaf = torch.cat([v.amin(1), v.amax(1)], 1)[self.leaf_perm]
        levels = [leaf]
        cur = leaf
        for k in range(1, self.num_levels):
            half = 1 << (k - 1)
            cur = torch.cat([torch.minimum(cur[:-half, :3], cur[half:, :3]),
                             torch.maximum(cur[:-half, 3:], cur[half:, 3:])],
                            1)
            levels.append(cur)
        pyramid = torch.cat(levels, 0)
        fa, ea = pyramid[self.fidx], pyramid[self.eidx]
        lo = torch.minimum(fa[:, :3], ea[:, :3])
        hi = torch.maximum(fa[:, 3:], ea[:, 3:])
        return torch.cat([lo, hi, self.bvh_tail], 1)

    def update(self, models, prev_models) -> dict:
        """models, prev_models: [I,4,4] float32 tensors on the device (this
        and the previous frame's world transforms, instance order). Returns
        the updated scene tensors, to merge over the scene dict."""
        inv = affine_inverse(models)
        out = {}
        # triangles and normals, each row by its instance's matrix
        rows = models[self.tri_iid]
        world = _apply(rows[:, :3, :3], self.tri_local) + rows[:, None, :3, 3]
        world = torch.where(self.tri_valid[:, None, None], world,
                            self.tri_local)
        inv_t = inv[self.tri_iid][:, :3, :3].transpose(1, 2)
        nrm = _apply(inv_t, self.nrm_local)
        nrm = div(nrm, torch.clamp(_length(nrm), min=1e-20)[..., None])
        nrm = torch.where(self.tri_valid[:, None, None], nrm, self.nrm_local)
        world9 = world.reshape(-1, 9)
        out["tri_pos"] = world
        out["tri_pos_flat"] = torch.cat([world9, self.tri_pos_tail], 1)
        out["tri_attr"] = torch.cat([nrm.reshape(-1, 9), self.tri_attr_tail],
                                    1)
        out["bvh_packed"] = self.boxes(world)

        # instance tables
        out["inst_model"] = models
        out["inst_motion"] = _matmul4(prev_models, inv).reshape(-1, 16)
        wpts = (_apply(models[:, :3, :3], self.local_corners)
                + models[:, None, :3, 3])
        out["inst_aabb_min"] = wpts.amin(1)
        out["inst_aabb_max"] = wpts.amax(1)

        # emissive tables
        if self.num_emissives:
            lo = out["inst_aabb_min"][self.em_instance]
            hi = out["inst_aabb_max"][self.em_instance]
            em_pos = 0.5 * (lo + hi)
            em_rad = 0.5 * _length(hi - lo) + self.em_extra
            out["em_position"] = em_pos
            out["em_radius"] = em_rad
            out["em_packed"] = torch.cat([self.em_packed0[:, :4], em_pos,
                                          em_rad[:, None],
                                          self.em_packed0[:, 8:]], 1)
            out["em_tri_pos_flat"] = torch.cat(
                [out["tri_pos_flat"][self.em_rows], self.em_pad_pos], 0)
            out["em_tri_attr"] = torch.cat(
                [out["tri_attr"][self.em_rows], self.em_pad_attr], 0)
        return out
