"""Scenes as plain data, and the two ways they are handed over.

A configuration's scene module (portbench/configs/<config>.py `build()`)
returns a SceneDesc: meshes, materials, instances and the sun as numpy
arrays and numbers. `to_scene` gives the same description to a renderer
package through its public API (Scene, Mesh, StandardMaterial,
DirectionalLight): hikari_tpu_torch for the timed path, the frozen copy
portbench.reference.hk for the reference. The shapes are the Bevy shapes
the reference examples spawn (plane, box, UV sphere), frozen here."""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class MeshDesc:
    positions: np.ndarray   # [V,3] f32
    normals: np.ndarray     # [V,3] f32
    uvs: np.ndarray         # [V,2] f32
    indices: np.ndarray     # [F,3] u32

    @property
    def num_triangles(self) -> int:
        return len(self.indices)


@dataclasses.dataclass
class SceneDesc:
    meshes: list            # [MeshDesc]
    materials: list         # [dict of StandardMaterial fields]
    instances: list         # [(mesh, material, transform [4,4] f64)]
    sun: dict               # DirectionalLight.from_euler's arguments

    @property
    def num_triangles(self) -> int:
        return sum(self.meshes[m].num_triangles for m, _, _ in self.instances)


def make_transform(translation=(0, 0, 0), rotation=None,
                   scale=(1, 1, 1)) -> np.ndarray:
    m = np.eye(4)
    r = np.eye(3) if rotation is None else np.asarray(rotation, np.float64)
    m[:3, :3] = r * np.asarray(scale, np.float64)[None, :]
    m[:3, 3] = translation
    return m


def rot_x(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]])


def rot_y(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])


def _mesh(positions, normals, uvs, indices) -> MeshDesc:
    return MeshDesc(np.ascontiguousarray(positions, np.float32),
                    np.ascontiguousarray(normals, np.float32),
                    np.ascontiguousarray(uvs, np.float32),
                    np.ascontiguousarray(indices, np.uint32).reshape(-1, 3))


def plane(size: float = 1.0) -> MeshDesc:
    """Bevy shape::Plane: a square in XZ at y = 0, +Y normal."""
    e = size / 2.0
    return _mesh([[e, 0, -e], [-e, 0, -e], [-e, 0, e], [e, 0, e]],
                 np.tile([0.0, 1.0, 0.0], (4, 1)),
                 [[1, 0], [0, 0], [0, 1], [1, 1]], [[0, 2, 1], [0, 3, 2]])


def box(x_length: float, y_length: float, z_length: float) -> MeshDesc:
    """Bevy shape::Box, centred: 24 vertices, 12 triangles."""
    hx, hy, hz = x_length / 2.0, y_length / 2.0, z_length / 2.0
    faces = [
        ([[-hx, -hy, hz], [hx, -hy, hz], [hx, hy, hz], [-hx, hy, hz]],
         [0, 0, 1]),
        ([[-hx, hy, -hz], [hx, hy, -hz], [hx, -hy, -hz], [-hx, -hy, -hz]],
         [0, 0, -1]),
        ([[hx, -hy, -hz], [hx, hy, -hz], [hx, hy, hz], [hx, -hy, hz]],
         [1, 0, 0]),
        ([[-hx, -hy, hz], [-hx, hy, hz], [-hx, hy, -hz], [-hx, -hy, -hz]],
         [-1, 0, 0]),
        ([[hx, hy, -hz], [-hx, hy, -hz], [-hx, hy, hz], [hx, hy, hz]],
         [0, 1, 0]),
        ([[hx, -hy, hz], [-hx, -hy, hz], [-hx, -hy, -hz], [hx, -hy, -hz]],
         [0, -1, 0]),
    ]
    uv_quad = [[0, 0], [1, 0], [1, 1], [0, 1]]
    pos, nrm, uvs, idx = [], [], [], []
    for fi, (quad, n) in enumerate(faces):
        b = 4 * fi
        pos.extend(quad)
        nrm.extend([n] * 4)
        uvs.extend(uv_quad)
        idx.extend([[b, b + 1, b + 2], [b + 2, b + 3, b]])
    return _mesh(pos, nrm, uvs, idx)


def cube(size: float = 1.0) -> MeshDesc:
    return box(size, size, size)


def uv_sphere(radius: float = 1.0, sectors: int = 36,
              stacks: int = 18) -> MeshDesc:
    """Bevy shape::UVSphere (the sector/stack grid), in float64 cast to
    float32."""
    pos, nrm, uvs = [], [], []
    for i in range(stacks + 1):
        stack_angle = np.pi / 2 - i * np.pi / stacks
        xy = radius * np.cos(stack_angle)
        z = radius * np.sin(stack_angle)
        for j in range(sectors + 1):
            sector_angle = j * 2 * np.pi / sectors
            x = xy * np.cos(sector_angle)
            y = xy * np.sin(sector_angle)
            pos.append([x, y, z])
            nrm.append([x / radius, y / radius, z / radius])
            uvs.append([j / sectors, i / stacks])
    idx = []
    for i in range(stacks):
        k1 = i * (sectors + 1)
        k2 = k1 + sectors + 1
        for j in range(sectors):
            if i != 0:
                idx.append([k1 + j, k2 + j, k1 + j + 1])
            if i != stacks - 1:
                idx.append([k1 + j + 1, k2 + j, k2 + j + 1])
    return _mesh(pos, nrm, uvs, idx)


def to_scene(desc: SceneDesc, api, transforms=None, prev_transforms=None):
    """The description as a Scene of the renderer package `api` (a module
    exporting Scene, Mesh, StandardMaterial and DirectionalLight), with
    each instance's transform taken from `transforms` where given and its
    previous transform from `prev_transforms` (None: the same)."""
    sc = api.Scene()
    for m in desc.meshes:
        sc.add_mesh(api.Mesh(m.positions.copy(), m.normals.copy(),
                             m.uvs.copy(), m.indices.copy()))
    for mat in desc.materials:
        sc.add_material(api.StandardMaterial(**mat))
    for i, (mesh, mat, tf) in enumerate(desc.instances):
        t = tf if transforms is None else transforms[i]
        p = None if prev_transforms is None else prev_transforms[i]
        sc.spawn(mesh, mat, np.array(t, np.float64),
                 prev_transform=None if p is None
                 else np.array(p, np.float64))
    sc.directional_light = api.DirectionalLight.from_euler(
        *desc.sun["euler"], illuminance=desc.sun["illuminance"])
    return sc


def move_instances(scene, transforms, prev_transforms):
    """Sets each instance of a Scene to its transform and previous
    transform (the frame's scene motion), in place; returns the scene."""
    for inst, t, p in zip(scene.instances, transforms, prev_transforms):
        inst.transform = np.array(t, np.float64)
        inst.prev_transform = np.array(p, np.float64)
    return scene
