"""glTF 2.0 files written from numpy, for the loaders' tests and
chip_smoke.py: both packages' `load_gltf_scene` read the same bytes.

* `GltfWriter` builds one file: buffer views (4-byte aligned), accessors,
  PNG images in a buffer view, textures, materials, meshes, nodes; and
  writes it as a GLB (`write_glb`), as a .gltf + .bin pair (`write_gltf`)
  or as a .gltf with its buffer in a data URI (`write_gltf(data_uri=True)`).
* `feature_file(path, fmt)` writes a file that covers what the loaders
  read: u8 / u16 / u32 indices, a non-indexed primitive, an interleaved
  (strided) vertex buffer, a primitive without normals, a LINES primitive
  (skipped), a primitive without a material, TRS and matrix nodes in a
  hierarchy, pbrMetallicRoughness, KHR_materials_emissive_strength and an
  embedded PNG texture of FEATURE_TEXTURE_SHAPE (above
  FEATURE_MAX_TEXTURE_SIDE).
* `write_scene_glb(scene, path)` writes a Scene of either package (its
  meshes, its materials' factors, an instance per node at its transform)
  as a GLB; `write_cornell_glb(path, package)` writes the procedural
  Cornell box (tests/cornell_box.py) that way, the stand-in for the
  reference's absent cornell.glb.
"""

from __future__ import annotations

import base64
import io
import json
import os
import struct

import numpy as np

FLOAT, U8, U16, U32 = 5126, 5121, 5123, 5125
_TYPES = {1: "SCALAR", 2: "VEC2", 3: "VEC3", 4: "VEC4", 16: "MAT4"}
FEATURE_TEXTURE_SHAPE = (40, 80)
FEATURE_MAX_TEXTURE_SIDE = 32


class GltfWriter:
    def __init__(self):
        self.js = {"asset": {"version": "2.0"}, "buffers": [],
                   "bufferViews": [], "accessors": [], "images": [],
                   "textures": [], "materials": [], "meshes": [],
                   "nodes": [], "scenes": [{"nodes": []}], "scene": 0}
        self.bin = bytearray()

    def view(self, data: bytes, stride=None) -> int:
        """A buffer view of `data`, 4-byte aligned in the one buffer."""
        self.bin += b"\0" * (-len(self.bin) % 4)
        bv = {"buffer": 0, "byteOffset": len(self.bin),
              "byteLength": len(data)}
        if stride:
            bv["byteStride"] = stride
        self.bin += data
        self.js["bufferViews"].append(bv)
        return len(self.js["bufferViews"]) - 1

    def accessor(self, arr, ctype=FLOAT, view=None, offset=0, count=None,
                 ncomp=None) -> int:
        """An accessor of `arr` [count, ncomp] (its own view), or of
        `count` items of `ncomp` components at `offset` of `view`."""
        if view is None:
            arr = np.ascontiguousarray(arr)
            view = self.view(arr.tobytes())
            count = arr.shape[0]
            ncomp = 1 if arr.ndim == 1 else arr.shape[1]
        acc = {"bufferView": view, "byteOffset": offset,
               "componentType": ctype, "count": count,
               "type": _TYPES[ncomp]}
        self.js["accessors"].append(acc)
        return len(self.js["accessors"]) - 1

    def texture_png(self, rgba: np.ndarray) -> int:
        """A texture of an RGBA uint8 image stored as a PNG in a buffer
        view."""
        from PIL import Image

        png = io.BytesIO()
        Image.fromarray(rgba).save(png, format="PNG")
        view = self.view(png.getvalue())
        self.js["images"].append({"bufferView": view,
                                  "mimeType": "image/png"})
        self.js["textures"].append({"source": len(self.js["images"]) - 1})
        return len(self.js["textures"]) - 1

    def material(self, mat: dict) -> int:
        self.js["materials"].append(mat)
        return len(self.js["materials"]) - 1

    def mesh(self, primitives) -> int:
        self.js["meshes"].append({"primitives": list(primitives)})
        return len(self.js["meshes"]) - 1

    def node(self, node: dict, root: bool = False) -> int:
        self.js["nodes"].append(node)
        i = len(self.js["nodes"]) - 1
        if root:
            self.js["scenes"][0]["nodes"].append(i)
        return i

    def triangles(self, positions, normals=None, uvs=None, indices=None,
                  index_type=U32, material=None) -> dict:
        """A TRIANGLES primitive of the given arrays (indices stored as
        `index_type`)."""
        attrs = {"POSITION": self.accessor(np.asarray(positions, np.float32))}
        if normals is not None:
            attrs["NORMAL"] = self.accessor(np.asarray(normals, np.float32))
        if uvs is not None:
            attrs["TEXCOORD_0"] = self.accessor(np.asarray(uvs, np.float32))
        prim = {"attributes": attrs}
        if indices is not None:
            dt = {U8: np.uint8, U16: np.uint16, U32: np.uint32}[index_type]
            prim["indices"] = self.accessor(
                np.asarray(indices).reshape(-1).astype(dt), index_type)
        if material is not None:
            prim["material"] = material
        return prim

    def _json_bytes(self, uri=None) -> bytes:
        js = dict(self.js)
        buf = {"byteLength": len(self.bin)}
        if uri is not None:
            buf["uri"] = uri
        js["buffers"] = [buf]
        return json.dumps(js).encode()

    def write_glb(self, path: str):
        """One GLB: the header, the JSON chunk (space padded) and the BIN
        chunk (zero padded)."""
        js = self._json_bytes()
        js += b" " * (-len(js) % 4)
        bn = bytes(self.bin) + b"\0" * (-len(self.bin) % 4)
        body = (struct.pack("<II", len(js), 0x4E4F534A) + js
                + struct.pack("<II", len(bn), 0x004E4942) + bn)
        with open(path, "wb") as f:
            f.write(struct.pack("<III", 0x46546C67, 2, 12 + len(body)))
            f.write(body)

    def write_gltf(self, path: str, data_uri: bool = False):
        """A .gltf with its buffer beside it (<stem>.bin) or inline as a
        base64 data URI."""
        if data_uri:
            uri = ("data:application/octet-stream;base64,"
                   + base64.b64encode(bytes(self.bin)).decode())
        else:
            uri = os.path.splitext(os.path.basename(path))[0] + ".bin"
            with open(os.path.join(os.path.dirname(path), uri), "wb") as f:
                f.write(bytes(self.bin))
        with open(path, "wb") as f:
            f.write(self._json_bytes(uri))

    def write(self, path: str, fmt: str):
        """fmt: "glb", "gltf" (+ .bin) or "data_uri"."""
        if fmt == "glb":
            self.write_glb(path)
        else:
            self.write_gltf(path, data_uri=fmt == "data_uri")


def _box(seed):
    """A unit cube's 24 vertices and 12 triangles, jittered by `seed`."""
    g = np.random.default_rng(seed)
    faces = []
    for axis in range(3):
        for sign in (-1.0, 1.0):
            n = np.zeros(3)
            n[axis] = sign
            u, v = np.roll(np.eye(3), axis + 1, 0)[:2]
            quad = [0.5 * n + 0.5 * (a * u + b * v)
                    for a, b in ((-1, -1), (1, -1), (1, 1), (-1, 1))]
            faces.append((quad, n))
    pos = np.concatenate([q for q, _ in faces]).astype(np.float32)
    pos += g.uniform(-0.01, 0.01, pos.shape).astype(np.float32)
    nrm = np.repeat([n for _, n in faces], 4, axis=0).astype(np.float32)
    uv = np.tile([[0, 0], [1, 0], [1, 1], [0, 1]], (6, 1)).astype(np.float32)
    idx = np.concatenate([[4 * f, 4 * f + 1, 4 * f + 2, 4 * f + 2,
                           4 * f + 3, 4 * f] for f in range(6)])
    return pos, nrm, uv, idx


def feature_file(path: str, fmt: str = "glb", seed: int = 0) -> str:
    """Write the feature file (the module docstring's list) as `fmt` to
    `path`; returns `path`."""
    g = np.random.default_rng(seed)
    w = GltfWriter()
    h, wd = FEATURE_TEXTURE_SHAPE
    tex = w.texture_png(g.integers(0, 256, (h, wd, 4), dtype=np.uint8))
    glow = w.material({
        "pbrMetallicRoughness": {
            "baseColorFactor": [0.9, 0.5, 0.25, 1.0],
            "baseColorTexture": {"index": tex},
            "metallicFactor": 0.2, "roughnessFactor": 0.7},
        "emissiveFactor": [1.0, 0.8, 0.5],
        "extensions": {"KHR_materials_emissive_strength":
                       {"emissiveStrength": 3.0}}})
    matte = w.material({"pbrMetallicRoughness": {
        "baseColorFactor": [0.2, 0.6, 0.3, 1.0]}})
    pos, nrm, uv, idx = _box(seed)
    # the cube with u16 indices and a LINES primitive beside it (skipped)
    cube = w.mesh([
        w.triangles(pos, nrm, uv, idx, U16, material=glow),
        {"attributes": {"POSITION": w.accessor(pos[:4])}, "mode": 1,
         "material": matte}])
    # a primitive without normals (flat normals) and u8 indices
    tri_pos = g.uniform(-1, 1, (5, 3)).astype(np.float32)
    fan = w.mesh([w.triangles(tri_pos, None, None,
                              [0, 1, 2, 0, 2, 3, 0, 3, 4], U8,
                              material=matte)])
    # u32 indices over an interleaved buffer (position and normal, 24 B a
    # vertex), without a material (the loader's default)
    inter = np.concatenate([pos, nrm], 1).astype(np.float32)
    view = w.view(inter.tobytes(), stride=24)
    inter_prim = {"attributes": {
        "POSITION": w.accessor(None, view=view, offset=0, count=24, ncomp=3),
        "NORMAL": w.accessor(None, view=view, offset=12, count=24,
                             ncomp=3)},
        "indices": w.accessor(idx.astype(np.uint32), U32)}
    strided = w.mesh([inter_prim])
    # a non-indexed primitive (sequential vertices, a partial triangle
    # dropped)
    loose = w.mesh([w.triangles(g.uniform(-1, 1, (7, 3)), g.uniform(
        -1, 1, (7, 3)), g.uniform(0, 1, (7, 2)), material=glow)])
    q = np.array([0.1, 0.3, -0.2, 0.9])
    q /= np.linalg.norm(q)
    child_m = np.eye(4)
    child_m[:3, 3] = (0.5, -0.25, 1.0)
    child_m[:3, :3] = np.diag([1.0, 2.0, 0.5])
    child = w.node({"mesh": fan, "matrix": list(child_m.T.reshape(-1))})
    leaf = w.node({"mesh": loose, "scale": [0.5, 0.5, 0.5]})
    w.node({"mesh": cube, "translation": [1.0, 2.0, -3.0],
            "rotation": list(q), "scale": [1.5, 1.0, 0.75],
            "children": [child, leaf]}, root=True)
    root_m = np.eye(4)
    root_m[:3, 3] = (-2.0, 0.0, 1.0)
    w.node({"mesh": strided, "matrix": list(root_m.T.reshape(-1))},
           root=True)
    w.write(path, fmt)
    return path


def write_scene_glb(scene, path: str):
    """A GLB of `scene` (either package's Scene): one glTF mesh per (mesh,
    material) pair its instances use (u32 indices), each material's
    base colour, emissive rgb (alpha 1), roughness and metallic, and one
    root node per instance with its transform as a matrix. The loaders
    read it back as the same meshes, materials and transforms (mesh and
    material order by first use)."""
    w = GltfWriter()
    mats, meshes = {}, {}
    for inst in scene.instances:
        if inst.material not in mats:
            m = scene.materials[inst.material]
            mats[inst.material] = w.material({
                "pbrMetallicRoughness": {
                    "baseColorFactor": [float(c) for c in m.base_color],
                    "metallicFactor": float(m.metallic),
                    "roughnessFactor": float(m.perceptual_roughness)},
                "emissiveFactor": [float(c) for c in m.emissive[:3]]})
        key = (inst.mesh, inst.material)
        if key not in meshes:
            mesh = scene.meshes[inst.mesh]
            meshes[key] = w.mesh([w.triangles(
                mesh.positions, mesh.normals, mesh.uvs, mesh.indices, U32,
                material=mats[inst.material])])
        mat = np.asarray(inst.transform, np.float64)
        w.node({"mesh": meshes[key], "matrix": [float(x) for x in
                                                mat.T.reshape(-1)]},
               root=True)
    w.write_glb(path)
    return path


def write_cornell_glb(path: str, package: str = "hikari_tpu_torch"):
    """The procedural Cornell box (tests/cornell_box.py) as a GLB at
    `path` (its directory made): the stand-in for the reference's
    assets/models/cornell.glb."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "cornell_box", os.path.join(os.path.dirname(
            os.path.abspath(__file__)), "cornell_box.py"))
    box = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(box)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    return write_scene_glb(box.build_cornell_box(package), path)
