"""Scene assembly and the scene compiler (hikari_tpu/models/scene.py).

Like hikari_tpu, the compiler flattens the scene: every instance's
triangles are pre-transformed to world space into one triangle table with
per-triangle instance/material ids, plus a world BVH, the emissive list,
the emissive light BVH, per-instance alias tables (instance.rs:381-428)
and the texture atlas with each texture's rect.
Host code stays numpy; `GpuScene.as_pytree(device)` uploads the arrays as
torch tensors, and `GpuScene.bvh` keeps the BVH's topology for the refits:
on the host (`GpuScene.update_transforms`, hikari_tpu's numpy steps) and on
the device (models/refit_device.py). hikari_tpu's cluster tables
(models/clusters.py, built above 512 triangles for its tile-cull tracer)
are left out (the reference walks `bvh_packed`), and its bf16 atlas
layouts (`atlas_panels` for the TPU window DMA, `atlas_quad` for one row
gather per bilinear sample) by per-pixel gathers from the f32 `atlas`.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from portbench.reference.hk.config import HikariUniversalSettings
from portbench.reference.hk.models.alias_table import (build_alias_table,
                                                 triangle_areas)
from portbench.reference.hk.models.bvh import build_bvh, refit_bvh
from portbench.reference.hk.models.material import StandardMaterial, pack_materials
from portbench.reference.hk.models.mesh import Mesh

TRI_PAD = 8  # triangle count padded to a multiple of this, as hikari_tpu

_TENSOR_DTYPES = (np.float32, np.float64, np.int32, np.int64, np.uint8,
                  np.bool_)


@dataclasses.dataclass
class DirectionalLight:
    """Single directional (sun) light."""

    illuminance: float = 100000.0
    color: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    # direction the light travels; direction_to_light = -direction
    direction: Tuple[float, float, float] = (0.0, -1.0, 0.0)

    @staticmethod
    def from_euler(x: float, y: float, z: float, illuminance: float = 100000.0,
                   color=(1.0, 1.0, 1.0)) -> "DirectionalLight":
        """Bevy-style XYZ euler rotation of a light looking down -Z."""
        cx, sx = np.cos(x), np.sin(x)
        cy, sy = np.cos(y), np.sin(y)
        cz, sz = np.cos(z), np.sin(z)
        rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
        ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
        rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
        fwd = rx @ ry @ rz @ np.array([0.0, 0.0, -1.0])
        return DirectionalLight(illuminance=illuminance, color=color,
                                direction=tuple(fwd))

    def gpu_color(self) -> np.ndarray:
        # Bevy uploads color * illuminance * exposure with a fixed physical
        # camera (f/4, 1/250 s, ISO 100): ev100 ~= 11.97
        ev100 = np.log2(4.0 * 4.0 / (1.0 / 250.0))
        exposure = 1.0 / (2.0 ** ev100 * 1.2)
        c = (np.asarray(self.color, np.float32)
             * np.float32(self.illuminance * exposure))
        return np.concatenate([c, [1.0]]).astype(np.float32)


@dataclasses.dataclass
class AmbientLight:
    """Bevy AmbientLight default: white x 0.05 brightness."""

    color: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    brightness: float = 0.05

    def gpu_color(self) -> np.ndarray:
        c = np.asarray(self.color, np.float32) * np.float32(self.brightness)
        return np.concatenate([c, [1.0]]).astype(np.float32)


@dataclasses.dataclass
class Instance:
    mesh: int
    material: int
    transform: np.ndarray  # 4x4 model matrix
    prev_transform: Optional[np.ndarray] = None  # defaults to transform
    visible: bool = True


def make_transform(translation=(0, 0, 0), rotation=None,
                   scale=(1, 1, 1)) -> np.ndarray:
    m = np.eye(4)
    r = np.eye(3) if rotation is None else np.asarray(rotation, np.float64)
    m[:3, :3] = r * np.asarray(scale, np.float64)[None, :]
    m[:3, 3] = translation
    return m


class Scene:
    """Host-side scene: meshes + materials + instances + lights."""

    def __init__(self):
        self.meshes: List[Mesh] = []
        self.materials: List[StandardMaterial] = []
        self.instances: List[Instance] = []
        self.directional_light = DirectionalLight()
        self.ambient_light = AmbientLight()

    def add_mesh(self, mesh: Mesh) -> int:
        self.meshes.append(mesh)
        return len(self.meshes) - 1

    def add_material(self, material) -> int:
        if not isinstance(material, StandardMaterial):
            material = material.to_standard_material()
        self.materials.append(material)
        return len(self.materials) - 1

    def spawn(self, mesh: int, material: int,
              transform: Optional[np.ndarray] = None,
              prev_transform: Optional[np.ndarray] = None) -> int:
        self.instances.append(Instance(
            mesh, material,
            np.eye(4) if transform is None
            else np.asarray(transform, np.float64),
            prev_transform))
        return len(self.instances) - 1

    def compile(self, universal=None) -> "GpuScene":
        return compile_scene(self, universal)


def upload(arrays: Dict[str, np.ndarray], device) -> dict:
    """numpy arrays as tensors on `device`; arrays of other dtypes
    (hikari_tpu's bf16 `atlas_panels` and `atlas_quad`) are left out."""
    out = {}
    for k, v in arrays.items():
        a = np.asarray(v)
        if a.dtype.type in _TENSOR_DTYPES:
            out[k] = torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return out


@dataclasses.dataclass
class GpuScene:
    """Flat SoA numpy arrays ready for upload, plus the static counts."""

    arrays: Dict[str, np.ndarray]
    num_triangles: int
    num_nodes: int
    num_instances: int
    num_emissives: int
    num_textures: int
    bvh: object  # the world BVH's topology (host-only, for refit)

    def as_pytree(self, device) -> dict:
        return upload(self.arrays, device)

    @property
    def has_sun(self) -> bool:
        """True iff the directional light contributes."""
        return bool(np.any(np.abs(self.arrays["dir_color"][:3]) > 0.0))

    def update_transforms(self, scene: "Scene") -> "GpuScene":
        """The host refit (hikari_tpu's GpuScene.update_transforms, the
        analog of the reference's per-frame TLAS rebuild,
        instance.rs:352-371): keep the topology, retransform the moved
        instances' world triangles in float64, refit the BVH's boxes
        (models/bvh.refit_bvh), refresh the instance, motion and emissive
        tables and rebuild the emissive BVH (LBVH, so its leaf order may
        differ from the compiled one's). Alias tables are kept (rigid
        motion). Kernel 13's tables are recomputed from the plan made once
        for the topology (in place of hikari_tpu's cluster tables). Every
        array hikari_tpu writes is computed by its numpy steps in its
        order; arrays it does not touch are the same objects."""
        visible = [inst for inst in scene.instances if inst.visible]
        if len(visible) != self.num_instances:
            raise ValueError("the scene's topology changed: use compile()")
        a = self.arrays
        tri_pos = a["tri_pos"].copy()
        tri_nrm = a["tri_normal"].copy()
        offsets = a["inst_prim_offset"]
        counts = a["inst_prim_count"]
        inst_model = []
        inst_motion = []
        for iid, inst in enumerate(visible):
            model = np.asarray(inst.transform, np.float64)
            prev = (model if inst.prev_transform is None
                    else np.asarray(inst.prev_transform, np.float64))
            inst_model.append(model.astype(np.float32))
            inst_motion.append((prev @ np.linalg.inv(model)).astype(
                np.float32))
            old = a["inst_model"][iid].astype(np.float64)
            if np.allclose(model, old, atol=1e-9):
                continue
            rel = model @ np.linalg.inv(old)
            o, c = offsets[iid], counts[iid]
            sl = tri_pos[o:o + c].reshape(-1, 3)
            tri_pos[o:o + c] = (sl @ rel[:3, :3].T + rel[:3, 3]).reshape(
                -1, 3, 3).astype(np.float32)
            itn = np.linalg.inv(rel[:3, :3]).T
            nsl = tri_nrm[o:o + c].reshape(-1, 3) @ itn.T
            nsl /= np.maximum(np.linalg.norm(nsl, axis=-1, keepdims=True),
                              1e-20)
            tri_nrm[o:o + c] = nsl.reshape(-1, 3, 3).astype(np.float32)

        n = self.num_triangles
        bvh2 = refit_bvh(self.bvh, tri_pos[:n].min(axis=1),
                         tri_pos[:n].max(axis=1))

        arrays = dict(a)
        arrays["tri_pos"] = tri_pos
        arrays["tri_normal"] = tri_nrm
        arrays["inst_model"] = np.asarray(inst_model, np.float32)
        arrays["inst_motion"] = np.asarray(inst_motion, np.float32).reshape(
            -1, 16)
        arrays["bvh_min"] = bvh2.node_min
        arrays["bvh_max"] = bvh2.node_max
        arrays["bvh_packed"] = _packed_bvh(bvh2.node_min, bvh2.node_max,
                                           bvh2.entry, bvh2.exit)
        arrays["tri_pos_flat"] = np.concatenate([
            tri_pos.reshape(len(tri_pos), 9),
            a["tri_instance"].astype(np.float32)[:, None],
        ], axis=1).astype(np.float32)
        arrays["tri_attr"] = np.concatenate([
            tri_nrm.reshape(len(tri_nrm), 9),
            a["tri_uv"].reshape(len(tri_nrm), 6),
            a["tri_instance"].astype(np.float32)[:, None],
            a["tri_material"].astype(np.float32)[:, None],
        ], axis=1).astype(np.float32)
        # instance boxes from the moved triangles
        n_i = self.num_instances
        amin = np.empty((n_i, 3), np.float32)
        amax = np.empty((n_i, 3), np.float32)
        for iid in range(n_i):
            o, c = offsets[iid], counts[iid]
            amin[iid] = tri_pos[o:o + c].reshape(-1, 3).min(axis=0)
            amax[iid] = tri_pos[o:o + c].reshape(-1, 3).max(axis=0)
        arrays["inst_aabb_min"] = amin
        arrays["inst_aabb_max"] = amax
        if self.num_emissives:
            em_inst = a["em_instance"]
            lo, hi = amin[em_inst], amax[em_inst]
            # each radius keeps its intensity term, read against the old
            # instance boxes
            old_extra = (a["em_radius"]
                         - 0.5 * np.linalg.norm(
                             a["inst_aabb_max"][em_inst]
                             - a["inst_aabb_min"][em_inst], axis=-1))
            arrays["em_position"] = (0.5 * (lo + hi)).astype(np.float32)
            arrays["em_radius"] = (0.5 * np.linalg.norm(hi - lo, axis=-1)
                                   + old_extra).astype(np.float32)
            em_pos = arrays["em_position"]
            em_r = arrays["em_radius"][:, None]
            em_bvh = build_bvh(em_pos - em_r, em_pos + em_r, method="lbvh")
            arrays["em_bvh_packed"] = _packed_bvh(
                em_bvh.node_min, em_bvh.node_max, em_bvh.entry, em_bvh.exit)
            eleaf = (em_bvh.entry & np.uint32(0x80000000)) != 0
            epay = np.where(eleaf, em_bvh.entry & np.uint32(0x7FFFFFFF),
                            em_bvh.entry)
            arrays["em_leaf_order"] = epay[eleaf].astype(np.int32)
            arrays["em_packed"] = np.concatenate([
                a["em_rgba"], arrays["em_position"],
                arrays["em_radius"][:, None],
                a["em_instance"].astype(np.float32)[:, None],
                a["em_alias_offset"].astype(np.float32)[:, None],
                a["em_alias_count"].astype(np.float32)[:, None],
                a["em_surface_area"][:, None],
            ], axis=1).astype(np.float32)
        _add_emissive_tri_tables(arrays)
        return dataclasses.replace(self, arrays=arrays, bvh=bvh2)


def _pad_to(x: np.ndarray, n: int, fill=0):
    if len(x) == n:
        return x
    pad_shape = (n - len(x),) + x.shape[1:]
    return np.concatenate([x, np.full(pad_shape, fill, dtype=x.dtype)],
                          axis=0)


def _packed_bvh(node_min, node_max, entry_u32, exit_) -> np.ndarray:
    """[N,9] float rows: min(3), max(3), is_leaf, payload, exit."""
    is_leaf = (entry_u32 & np.uint32(0x80000000)) != 0
    payload = np.where(is_leaf, entry_u32 & np.uint32(0x7FFFFFFF), entry_u32)
    return np.concatenate([
        node_min, node_max,
        is_leaf.astype(np.float32)[:, None],
        payload.astype(np.float32)[:, None],
        np.asarray(exit_).astype(np.float32)[:, None],
    ], axis=1).astype(np.float32)


def _add_emissive_tri_tables(arrays) -> None:
    """Emissive-only triangle tables for the light-probe traces, padded to a
    multiple of 8 with far-away instance -1 rows, plus each instance's row
    offset into them."""
    em_inst = arrays["em_instance"]
    em_inst = em_inst[em_inst >= 0]
    mask = np.isin(
        np.round(arrays["tri_pos_flat"][:, 9]).astype(np.int64), em_inst)
    pos = arrays["tri_pos_flat"][mask]
    attr = arrays["tri_attr"][mask]
    n_pad = max(8, -(-len(pos) // 8) * 8)
    pad_pos = np.full((n_pad - len(pos), pos.shape[1]), 1e30, np.float32)
    pad_pos[:, 9] = -1.0
    pad_attr = np.zeros((n_pad - len(attr), attr.shape[1]), np.float32)
    pad_attr[:, 15] = -1.0
    arrays["em_tri_pos_flat"] = np.concatenate([pos, pad_pos], axis=0)
    arrays["em_tri_attr"] = np.concatenate([attr, pad_attr], axis=0)
    masked_inst = (np.round(pos[:, 9]).astype(np.int64) if len(pos)
                   else np.zeros(0, np.int64))
    offs = np.zeros(len(arrays["inst_prim_offset"]), np.float32)
    if len(masked_inst):
        uniq, first = np.unique(masked_inst, return_index=True)
        offs[uniq] = first.astype(np.float32)
    arrays["em_inst_tri_offset_f"] = offs


def compile_scene(scene: Scene, universal=None) -> GpuScene:
    """Scene -> flat world-space SoA arrays + acceleration structures.

    `universal`: HikariUniversalSettings; without
    build_mesh_acceleration_structure the world BVH is a single leaf over
    triangle 0, as hikari_tpu builds it (its debug toggle: only the
    brute-force engine sees the other triangles)."""
    universal = universal or HikariUniversalSettings()
    tri_pos, tri_nrm, tri_uv = [], [], []
    tri_inst, tri_mat = [], []
    inst_aabb_min, inst_aabb_max = [], []
    inst_prim_offset, inst_prim_count = [], []
    inst_material = []
    inst_model, inst_prev_model = [], []

    visible = [inst for inst in scene.instances if inst.visible]
    if not visible:
        raise ValueError("scene has no visible instances")

    offset = 0
    for iid, inst in enumerate(visible):
        mesh = scene.meshes[inst.mesh]
        model = np.asarray(inst.transform, np.float64)
        prev = (model if inst.prev_transform is None
                else np.asarray(inst.prev_transform, np.float64))
        wpos = mesh.positions @ model[:3, :3].T + model[:3, 3]
        # normals with the inverse transpose
        it = np.linalg.inv(model[:3, :3]).T
        wnrm = mesh.normals @ it.T
        wnrm /= np.maximum(np.linalg.norm(wnrm, axis=-1, keepdims=True),
                           1e-20)
        idx = mesh.indices.astype(np.int64)
        tri_pos.append(wpos[idx])
        tri_nrm.append(wnrm[idx])
        tri_uv.append(mesh.uvs[idx])
        f = len(idx)
        tri_inst.append(np.full(f, iid, np.int32))
        tri_mat.append(np.full(f, inst.material, np.int32))
        inst_aabb_min.append(wpos.min(axis=0))
        inst_aabb_max.append(wpos.max(axis=0))
        inst_prim_offset.append(offset)
        inst_prim_count.append(f)
        inst_material.append(inst.material)
        inst_model.append(model)
        inst_prev_model.append(prev)
        offset += f

    tri_pos = np.concatenate(tri_pos).astype(np.float32)
    tri_nrm = np.concatenate(tri_nrm).astype(np.float32)
    tri_uv = np.concatenate(tri_uv).astype(np.float32)
    tri_inst = np.concatenate(tri_inst)
    tri_mat = np.concatenate(tri_mat)
    num_tris = len(tri_pos)

    aabb_min, aabb_max = tri_pos.min(axis=1), tri_pos.max(axis=1)
    if universal.build_mesh_acceleration_structure:
        bvh = build_bvh(aabb_min, aabb_max)
    else:
        bvh = build_bvh(aabb_min[:1], aabb_max[:1])

    # emissive list + per-instance alias tables (instance.rs:381-419)
    em_rgba, em_pos, em_radius, em_instance = [], [], [], []
    em_alias_offset, em_alias_count, em_area = [], [], []
    alias_prob_all, alias_index_all = [], []
    for iid, inst in enumerate(visible):
        mat = scene.materials[inst.material]
        intensity = mat.emissive_intensity
        if intensity <= 0.0:
            continue
        mesh = scene.meshes[inst.mesh]
        model = np.asarray(inst.transform, np.float64)
        areas = triangle_areas(mesh.positions,
                               mesh.indices.astype(np.int64), model)
        prob, index = build_alias_table(areas)
        em_alias_offset.append(sum(len(p) for p in alias_prob_all))
        em_alias_count.append(len(prob))
        alias_prob_all.append(prob)
        alias_index_all.append(index)
        em_area.append(float(areas.sum()))
        lo, hi = inst_aabb_min[iid], inst_aabb_max[iid]
        em_pos.append(0.5 * (lo + hi))
        em_radius.append(0.5 * float(np.linalg.norm(hi - lo))
                         + float(np.sqrt(intensity)))
        em_rgba.append(np.asarray(mat.emissive, np.float32))
        em_instance.append(iid)

    num_emissives = len(em_instance)
    if num_emissives:
        em_pos_a = np.asarray(em_pos, np.float32)
        em_radius_a = np.asarray(em_radius, np.float32)
        em_bvh = build_bvh(em_pos_a - em_radius_a[:, None],
                           em_pos_a + em_radius_a[:, None])
        alias_prob = np.concatenate(alias_prob_all).astype(np.float32)
        alias_index = np.concatenate(alias_index_all).astype(np.int32)
    else:
        em_pos_a = np.zeros((1, 3), np.float32)
        em_radius_a = np.zeros(1, np.float32)
        em_rgba = [np.zeros(4, np.float32)]
        em_instance = [-1]
        em_alias_offset, em_alias_count, em_area = [0], [0], [0.0]
        em_bvh = None
        alias_prob = np.zeros(1, np.float32)
        alias_index = np.zeros(1, np.int32)

    mat_table, atlas, tex_rects, num_textures = pack_materials(
        scene.materials)

    num_pad = -(-num_tris // TRI_PAD) * TRI_PAD
    arrays = {
        "tri_pos": _pad_to(tri_pos, num_pad, fill=np.float32(1e30)),
        "tri_normal": _pad_to(tri_nrm, num_pad),
        "tri_uv": _pad_to(tri_uv, num_pad),
        "tri_instance": _pad_to(tri_inst, num_pad, fill=-1),
        "tri_material": _pad_to(tri_mat, num_pad, fill=0),
        "bvh_min": bvh.node_min,
        "bvh_max": bvh.node_max,
        "bvh_entry": bvh.entry.view(np.int32),
        "bvh_exit": bvh.exit.view(np.int32).astype(np.int32),
        "inst_aabb_min": np.asarray(inst_aabb_min, np.float32),
        "inst_aabb_max": np.asarray(inst_aabb_max, np.float32),
        "inst_material": np.asarray(inst_material, np.int32),
        "inst_prim_offset": np.asarray(inst_prim_offset, np.int32),
        "inst_prim_count": np.asarray(inst_prim_count, np.int32),
        "inst_model": np.asarray(inst_model, np.float32),
        "inst_prev_model": np.asarray(inst_prev_model, np.float32),
        "em_rgba": np.asarray(em_rgba, np.float32).reshape(-1, 4),
        "em_position": em_pos_a,
        "em_radius": em_radius_a,
        "em_instance": np.asarray(em_instance, np.int32),
        "em_alias_offset": np.asarray(em_alias_offset, np.int32),
        "em_alias_count": np.asarray(em_alias_count, np.int32),
        "em_surface_area": np.asarray(em_area, np.float32),
        "alias_prob": alias_prob,
        "alias_index": alias_index,
        **{f"mat_{k}": v for k, v in mat_table.items()},
        "atlas": atlas,
        "tex_rect": tex_rects,
        "dir_to_light": (
            -np.asarray(scene.directional_light.direction, np.float32)
            / np.linalg.norm(scene.directional_light.direction)
        ).astype(np.float32),
        "dir_color": scene.directional_light.gpu_color(),
        "ambient_color": scene.ambient_light.gpu_color(),
    }

    # packed per-row tables: one lookup per consumer
    arrays["tri_attr"] = np.concatenate([
        arrays["tri_normal"].reshape(num_pad, 9),
        arrays["tri_uv"].reshape(num_pad, 6),
        arrays["tri_instance"].astype(np.float32)[:, None],
        arrays["tri_material"].astype(np.float32)[:, None],
    ], axis=1).astype(np.float32)
    m = len(scene.materials)
    arrays["mat_packed"] = np.concatenate([
        arrays["mat_base_color"].reshape(m, 4),
        arrays["mat_emissive"].reshape(m, 4),
        arrays["mat_perceptual_roughness"][:, None],
        arrays["mat_metallic"][:, None],
        arrays["mat_reflectance"][:, None],
        arrays["mat_base_color_texture"].astype(np.float32)[:, None],
        arrays["mat_emissive_texture"].astype(np.float32)[:, None],
        arrays["mat_metallic_roughness_texture"].astype(np.float32)[:, None],
        arrays["mat_occlusion_texture"].astype(np.float32)[:, None],
    ], axis=1).astype(np.float32)
    # per-instance motion matrix prev_model @ inv(model): maps the current
    # world position to the previous frame's (velocity)
    motion = np.stack([
        np.asarray(p, np.float64) @ np.linalg.inv(np.asarray(c, np.float64))
        for p, c in zip(inst_prev_model, inst_model)
    ]).astype(np.float32)
    arrays["inst_motion"] = motion.reshape(len(visible), 16)
    arrays["em_packed"] = np.concatenate([
        arrays["em_rgba"],
        arrays["em_position"],
        arrays["em_radius"][:, None],
        arrays["em_instance"].astype(np.float32)[:, None],
        arrays["em_alias_offset"].astype(np.float32)[:, None],
        arrays["em_alias_count"].astype(np.float32)[:, None],
        arrays["em_surface_area"][:, None],
    ], axis=1).astype(np.float32)
    arrays["alias_packed"] = np.stack([
        arrays["alias_prob"], arrays["alias_index"].astype(np.float32)
    ], axis=1).astype(np.float32)
    arrays["inst_prim_offset_f"] = arrays["inst_prim_offset"].astype(
        np.float32)
    arrays["bvh_packed"] = _packed_bvh(bvh.node_min, bvh.node_max, bvh.entry,
                                       bvh.exit)
    # 9 vertex floats + instance id
    arrays["tri_pos_flat"] = np.concatenate([
        arrays["tri_pos"].reshape(num_pad, 9),
        arrays["tri_instance"].astype(np.float32)[:, None],
    ], axis=1).astype(np.float32)
    if num_emissives:
        arrays.update(
            em_bvh_min=em_bvh.node_min,
            em_bvh_max=em_bvh.node_max,
            em_bvh_entry=em_bvh.entry.view(np.int32),
            em_bvh_exit=em_bvh.exit.view(np.int32).astype(np.int32),
        )
    else:
        arrays.update(
            em_bvh_min=np.zeros((1, 3), np.float32),
            em_bvh_max=np.zeros((1, 3), np.float32),
            em_bvh_entry=np.zeros(1, np.int32),
            em_bvh_exit=np.ones(1, np.int32),
        )
    em_entry = arrays["em_bvh_entry"].view(np.uint32)
    arrays["em_bvh_packed"] = _packed_bvh(
        arrays["em_bvh_min"], arrays["em_bvh_max"], em_entry,
        arrays["em_bvh_exit"])
    # DFS leaf order: the emissive walk visits leaves in this order
    em_is_leaf = (em_entry & np.uint32(0x80000000)) != 0
    em_payload = np.where(em_is_leaf, em_entry & np.uint32(0x7FFFFFFF),
                          em_entry)
    arrays["em_leaf_order"] = (em_payload[em_is_leaf].astype(np.int32)
                               if num_emissives else np.zeros(1, np.int32))
    _add_emissive_tri_tables(arrays)

    return GpuScene(
        arrays=arrays,
        num_triangles=num_tris,
        num_nodes=bvh.count,
        num_instances=len(visible),
        num_emissives=num_emissives,
        num_textures=num_textures,
        bvh=bvh,
    )
