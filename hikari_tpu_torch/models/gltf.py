"""Minimal glTF 2.0 / GLB loader into a hikari_tpu_torch Scene (the port of
hikari_tpu/models/gltf.py, the same steps on the same bytes).

It reads what the reference's example assets use: GLB binary chunks,
external .bin buffers, data URIs, u8/u16/u32 indices, VEC2/VEC3 f32
attributes, node TRS / matrix hierarchies, pbrMetallicRoughness materials
(with KHR_materials_emissive_strength) and PNG/JPEG textures, scaled down
to `max_texture_side`. Only TRIANGLES primitives load; a primitive without
normals gets area-weighted flat normals. The material mapping is Bevy's
glTF importer's: perceptual_roughness = roughnessFactor, metallic =
metallicFactor, reflectance 0.5, emissive = emissiveFactor (times the
emissive strength) with alpha 1.
"""

from __future__ import annotations

import base64
import io
import json
import os
import struct
from typing import Dict, List, Optional
from urllib.parse import unquote

import numpy as np

from hikari_tpu_torch.models.material import StandardMaterial, Texture
from hikari_tpu_torch.models.mesh import Mesh

_COMPONENT_DTYPES = {
    5120: np.int8, 5121: np.uint8, 5122: np.int16,
    5123: np.uint16, 5125: np.uint32, 5126: np.float32,
}
_TYPE_COUNTS = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4,
                "MAT4": 16}
_GLB_MAGIC = b"glTF"
_CHUNK_JSON = 0x4E4F534A
_CHUNK_BIN = 0x004E4942


class GltfFile:
    """A .gltf or .glb file: its JSON, its GLB binary chunk (if any), and
    its buffers, accessors and images on demand."""

    def __init__(self, path: str):
        self.path = path
        self.dir = os.path.dirname(path)
        with open(path, "rb") as f:
            data = f.read()
        self.json = None
        self.bin = None
        if data[:4] == _GLB_MAGIC:
            _, _, length = struct.unpack_from("<III", data, 0)
            offset = 12
            while offset < length:
                clen, ctype = struct.unpack_from("<II", data, offset)
                chunk = data[offset + 8:offset + 8 + clen]
                if ctype == _CHUNK_JSON:
                    self.json = json.loads(chunk)
                elif ctype == _CHUNK_BIN:
                    self.bin = chunk
                offset += 8 + clen
        else:
            self.json = json.loads(data)
        self._buffers: Dict[int, bytes] = {}

    def buffer(self, index: int) -> bytes:
        """Buffer `index`: the GLB chunk, a data URI's bytes or a file
        beside this one."""
        if index not in self._buffers:
            uri = self.json["buffers"][index].get("uri")
            if uri is None:
                data = self.bin
            elif uri.startswith("data:"):
                data = base64.b64decode(uri.split(",", 1)[1])
            else:
                with open(os.path.join(self.dir, unquote(uri)), "rb") as f:
                    data = f.read()
            self._buffers[index] = data
        return self._buffers[index]

    def accessor(self, index: int) -> np.ndarray:
        """Accessor `index` as [count, components] (normalized integers as
        float32 in [0, 1]; an accessor without a buffer view is zeros)."""
        acc = self.json["accessors"][index]
        count = acc["count"]
        ncomp = _TYPE_COUNTS[acc["type"]]
        dtype = _COMPONENT_DTYPES[acc["componentType"]]
        itemsize = np.dtype(dtype).itemsize * ncomp
        if "bufferView" not in acc:
            return np.zeros((count, ncomp), dtype)
        bv = self.json["bufferViews"][acc["bufferView"]]
        data = self.buffer(bv["buffer"])
        start = bv.get("byteOffset", 0) + acc.get("byteOffset", 0)
        stride = bv.get("byteStride", itemsize)
        if stride == itemsize:
            arr = np.frombuffer(data, dtype, count * ncomp, start)
            arr = arr.reshape(count, ncomp)
        else:
            raw = np.frombuffer(data, np.uint8,
                                stride * (count - 1) + itemsize, start)
            arr = np.lib.stride_tricks.as_strided(
                raw.view(dtype), (count, ncomp),
                (stride, np.dtype(dtype).itemsize)).copy()
        if acc.get("normalized"):
            info = np.iinfo(dtype)
            arr = arr.astype(np.float32) / info.max
        return arr

    def image(self, index: int) -> np.ndarray:
        """Image `index` as [h, w, 4] uint8 RGBA (a file beside this one,
        a data URI, or a buffer view)."""
        from PIL import Image

        img = self.json["images"][index]
        if "uri" in img and not img["uri"].startswith("data:"):
            pil = Image.open(os.path.join(self.dir, unquote(img["uri"])))
        else:
            if "uri" in img:
                raw = base64.b64decode(img["uri"].split(",", 1)[1])
            else:
                bv = self.json["bufferViews"][img["bufferView"]]
                data = self.buffer(bv["buffer"])
                start = bv.get("byteOffset", 0)
                raw = data[start:start + bv["byteLength"]]
            pil = Image.open(io.BytesIO(raw))
        return np.asarray(pil.convert("RGBA"))


def _node_matrix(node: dict) -> np.ndarray:
    """A node's local 4x4 matrix (float64): its column-major `matrix`, or
    translation @ rotation (xyzw quaternion) @ scale."""
    if "matrix" in node:
        return np.asarray(node["matrix"], np.float64).reshape(4, 4).T
    m = np.eye(4)
    t = node.get("translation", [0, 0, 0])
    q = node.get("rotation", [0, 0, 0, 1])
    s = node.get("scale", [1, 1, 1])
    x, y, z, w = q
    rot = np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ])
    m[:3, :3] = rot * np.asarray(s, np.float64)[None, :]
    m[:3, 3] = t
    return m


def _flat_normals(pos: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """Per-vertex normals: the unit face normals of the triangles using
    each vertex, summed and normalized."""
    v0, v1, v2 = pos[idx[:, 0]], pos[idx[:, 1]], pos[idx[:, 2]]
    fn = np.cross(v1 - v0, v2 - v0)
    fn /= np.maximum(np.linalg.norm(fn, axis=-1, keepdims=True), 1e-20)
    nrm = np.zeros_like(pos)
    for k in range(3):
        np.add.at(nrm, idx[:, k], fn)
    nrm /= np.maximum(np.linalg.norm(nrm, axis=-1, keepdims=True), 1e-20)
    return nrm


def load_gltf_scene(path: str, scene, max_texture_side: int = 1024,
                    load_textures: bool = True) -> List[int]:
    """Load a glTF / GLB file into `scene` (a hikari_tpu_torch Scene): its
    materials, one Mesh per TRIANGLES primitive, and an instance per
    primitive of every mesh node of the default scene, at the node's
    world matrix. Returns the spawned instance ids."""
    from PIL import Image

    g = GltfFile(path)
    js = g.json

    tex_cache: Dict[int, Texture] = {}

    def get_texture(ref: Optional[dict], srgb: bool) -> Optional[Texture]:
        if ref is None or not load_textures:
            return None
        tex_index = ref.get("index")
        if tex_index is None:
            return None
        if tex_index in tex_cache:
            t = tex_cache[tex_index]
            t.is_srgb = t.is_srgb or srgb
            return t
        data = g.image(js["textures"][tex_index]["source"])
        h, w = data.shape[:2]
        if max(h, w) > max_texture_side:
            scale = max_texture_side / max(h, w)
            pil = Image.fromarray(data).resize(
                (max(1, int(w * scale)), max(1, int(h * scale))),
                Image.BILINEAR)
            data = np.asarray(pil)
        t = Texture(data=data, is_srgb=srgb, repeat=True)
        tex_cache[tex_index] = t
        return t

    mat_ids: List[int] = []
    for m in js.get("materials", []):
        pbr = m.get("pbrMetallicRoughness", {})
        emissive = list(m.get("emissiveFactor", [0, 0, 0])) + [1.0]
        strength = m.get("extensions", {}).get(
            "KHR_materials_emissive_strength", {}).get("emissiveStrength")
        if strength:
            emissive[:3] = [c * strength for c in emissive[:3]]
        mat = StandardMaterial(
            base_color=tuple(pbr.get("baseColorFactor", [1, 1, 1, 1])),
            base_color_texture=get_texture(pbr.get("baseColorTexture"),
                                           srgb=True),
            emissive=tuple(emissive),
            emissive_texture=get_texture(m.get("emissiveTexture"),
                                         srgb=True),
            perceptual_roughness=pbr.get("roughnessFactor", 1.0),
            metallic=pbr.get("metallicFactor", 1.0),
            metallic_roughness_texture=get_texture(
                pbr.get("metallicRoughnessTexture"), srgb=False),
            occlusion_texture=get_texture(m.get("occlusionTexture"),
                                          srgb=False),
        )
        mat_ids.append(scene.add_material(mat))
    default_mat: List[int] = []  # the default material, made at first use

    mesh_prims: List[List[tuple]] = []
    for m in js.get("meshes", []):
        prims = []
        for p in m["primitives"]:
            if p.get("mode", 4) != 4:  # TRIANGLES only
                continue
            attrs = p["attributes"]
            if "POSITION" not in attrs:
                continue
            pos = g.accessor(attrs["POSITION"]).astype(np.float32)
            n_v = len(pos)
            nrm = (g.accessor(attrs["NORMAL"]).astype(np.float32)
                   if "NORMAL" in attrs else np.zeros_like(pos))
            uv = (g.accessor(attrs["TEXCOORD_0"]).astype(np.float32)[:, :2]
                  if "TEXCOORD_0" in attrs
                  else np.zeros((n_v, 2), np.float32))
            if "indices" in p:
                idx = g.accessor(p["indices"]).reshape(-1).astype(np.uint32)
            else:
                idx = np.arange(n_v, dtype=np.uint32)
            if len(idx) < 3:
                continue
            idx = idx[:len(idx) - len(idx) % 3].reshape(-1, 3)
            if not np.any(nrm):
                nrm = _flat_normals(pos, idx)
            mesh_id = scene.add_mesh(Mesh(pos, nrm, uv, idx))
            mat_index = p.get("material")
            if mat_index is None:
                if not default_mat:
                    default_mat.append(scene.add_material(StandardMaterial()))
                mat_id = default_mat[0]
            else:
                mat_id = mat_ids[mat_index]
            prims.append((mesh_id, mat_id))
        mesh_prims.append(prims)

    spawned: List[int] = []

    def visit(node_index: int, parent: np.ndarray):
        node = js["nodes"][node_index]
        world = parent @ _node_matrix(node)
        if "mesh" in node:
            for mesh_id, mat_id in mesh_prims[node["mesh"]]:
                spawned.append(scene.spawn(mesh_id, mat_id, world))
        for child in node.get("children", []):
            visit(child, world)

    scene_def = js["scenes"][js.get("scene", 0)]
    for root in scene_def.get("nodes", []):
        visit(root, np.eye(4))
    return spawned
