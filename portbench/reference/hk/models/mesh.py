"""Triangle meshes and procedural shapes (plane, box/cube, quad, UV sphere,
icosphere), with Bevy's vertex layouts as in hikari_tpu/models/mesh.py.

`Mesh.from_triangle_strip` follows the reference's `GpuMesh::try_from`
(src/mesh_material/mod.rs:432-452): odd triangles of a strip swap v0 and
v1."""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Mesh:
    positions: np.ndarray  # [V,3] f32
    normals: np.ndarray  # [V,3] f32
    uvs: np.ndarray  # [V,2] f32
    indices: np.ndarray  # [F,3] u32 triangle list

    def __post_init__(self):
        self.positions = np.ascontiguousarray(self.positions, dtype=np.float32)
        self.normals = np.ascontiguousarray(self.normals, dtype=np.float32)
        self.uvs = np.ascontiguousarray(self.uvs, dtype=np.float32)
        self.indices = np.ascontiguousarray(
            self.indices, dtype=np.uint32).reshape(-1, 3)

    @property
    def num_vertices(self) -> int:
        return len(self.positions)

    @property
    def num_triangles(self) -> int:
        return len(self.indices)

    @staticmethod
    def from_triangle_strip(positions, normals, uvs, strip_indices) -> "Mesh":
        """A strip as a triangle list: window i is (v_i, v_i+1, v_i+2),
        its first two swapped when i is odd."""
        idx = np.asarray(strip_indices, dtype=np.uint32)
        tris = []
        for i in range(len(idx) - 2):
            v0, v1, v2 = idx[i], idx[i + 1], idx[i + 2]
            tris.append([v1, v0, v2] if i & 1 else [v0, v1, v2])
        return Mesh(positions, normals, uvs, np.asarray(tris, dtype=np.uint32))

    def local_aabb(self):
        """(min, max) of the positions, per axis."""
        return self.positions.min(axis=0), self.positions.max(axis=0)


def plane(size: float = 1.0) -> Mesh:
    """Bevy shape::Plane: square in XZ at y=0, +Y normal."""
    e = size / 2.0
    positions = np.array(
        [[e, 0, -e], [-e, 0, -e], [-e, 0, e], [e, 0, e]], dtype=np.float32)
    normals = np.tile([0.0, 1.0, 0.0], (4, 1)).astype(np.float32)
    uvs = np.array([[1, 0], [0, 0], [0, 1], [1, 1]], dtype=np.float32)
    indices = np.array([[0, 2, 1], [0, 3, 2]], dtype=np.uint32)
    return Mesh(positions, normals, uvs, indices)


def box(x_length: float, y_length: float, z_length: float) -> Mesh:
    """Bevy shape::Box (axis-aligned, centered): 24 vertices, 12 triangles."""
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
    uv_quad = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], dtype=np.float32)
    positions, normals, uvs, indices = [], [], [], []
    for fi, (quad_pts, n) in enumerate(faces):
        base = 4 * fi
        positions.extend(quad_pts)
        normals.extend([n] * 4)
        uvs.extend(uv_quad)
        indices.extend([[base, base + 1, base + 2], [base + 2, base + 3, base]])
    return Mesh(np.asarray(positions, np.float32),
                np.asarray(normals, np.float32),
                np.asarray(uvs, np.float32),
                np.asarray(indices, np.uint32))


def cube(size: float = 1.0) -> Mesh:
    return box(size, size, size)


def quad(width: float = 1.0, height: float = 1.0) -> Mesh:
    """Quad in XY at z=0, +Z normal."""
    hw, hh = width / 2.0, height / 2.0
    positions = np.array(
        [[-hw, -hh, 0], [hw, -hh, 0], [hw, hh, 0], [-hw, hh, 0]],
        dtype=np.float32)
    normals = np.tile([0.0, 0.0, 1.0], (4, 1)).astype(np.float32)
    uvs = np.array([[0, 1], [1, 1], [1, 0], [0, 0]], dtype=np.float32)
    indices = np.array([[0, 1, 2], [0, 2, 3]], dtype=np.uint32)
    return Mesh(positions, normals, uvs, indices)


def uv_sphere(radius: float = 1.0, sectors: int = 36,
              stacks: int = 18) -> Mesh:
    """Bevy shape::UVSphere layout (sector/stack grid), in float64 cast to
    float32 as hikari_tpu builds it."""
    positions, normals, uvs = [], [], []
    for i in range(stacks + 1):
        stack_angle = np.pi / 2 - i * np.pi / stacks
        xy = radius * np.cos(stack_angle)
        z = radius * np.sin(stack_angle)
        for j in range(sectors + 1):
            sector_angle = j * 2 * np.pi / sectors
            x = xy * np.cos(sector_angle)
            y = xy * np.sin(sector_angle)
            positions.append([x, y, z])
            normals.append([x / radius, y / radius, z / radius])
            uvs.append([j / sectors, i / stacks])
    indices = []
    for i in range(stacks):
        k1 = i * (sectors + 1)
        k2 = k1 + sectors + 1
        for j in range(sectors):
            if i != 0:
                indices.append([k1 + j, k2 + j, k1 + j + 1])
            if i != stacks - 1:
                indices.append([k1 + j + 1, k2 + j, k2 + j + 1])
    return Mesh(np.asarray(positions, np.float32),
                np.asarray(normals, np.float32),
                np.asarray(uvs, np.float32),
                np.asarray(indices, np.uint32))


def icosphere(radius: float = 1.0, subdivisions: int = 2) -> Mesh:
    """Subdivided icosahedron (Bevy shape::Icosphere equivalent), in
    float64 cast to float32 as hikari_tpu builds it."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array(
        [
            [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
            [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
            [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
        ],
        dtype=np.float64,
    )
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = [
        (0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
        (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
        (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
        (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1),
    ]
    verts = [tuple(v) for v in verts]
    cache = {tuple(np.round(v, 12)): i for i, v in enumerate(verts)}

    def midpoint(a, b):
        m = np.asarray(verts[a]) + np.asarray(verts[b])
        m /= np.linalg.norm(m)
        key = tuple(np.round(m, 12))
        if key not in cache:
            cache[key] = len(verts)
            verts.append(tuple(m))
        return cache[key]

    for _ in range(subdivisions):
        new_faces = []
        for a, b, c in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [(a, ab, ca), (b, bc, ab), (c, ca, bc), (ab, bc, ca)]
        faces = new_faces

    v = np.asarray(verts, dtype=np.float32)
    n = v.copy()
    u = np.stack(
        [
            0.5 + np.arctan2(v[:, 2], v[:, 0]) / (2 * np.pi),
            0.5 - np.arcsin(np.clip(v[:, 1], -1, 1)) / np.pi,
        ],
        axis=-1,
    ).astype(np.float32)
    return Mesh(v * radius, n, u, np.asarray(faces, np.uint32))
