"""Materials and the texture atlas (hikari_tpu/models/material.py).

`StandardMaterial` mirrors the subset of Bevy's StandardMaterial the
reference packs into its GPU material array: base color, emissive,
perceptual roughness, metallic, reflectance and five texture slots, with
-1 as the "no texture" id.

Textures are shelf-packed into ONE float32 atlas, linear-light (sRGB
decoded at pack time), each with a 1-texel wrapped border, and sampled by
computed offset + bilinear gather (ops/shading.py sample_atlas, kernel 14
in ops/texture_pallas.py). hikari_tpu's bf16 panel and quad layouts of the
atlas (TPU window DMA and row gather) are not built: the port gathers its
four texels per pixel from the f32 atlas.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

NO_TEXTURE = -1

_TEXTURE_SLOTS = ("base_color_texture", "emissive_texture",
                  "metallic_roughness_texture", "normal_map_texture",
                  "occlusion_texture")


@dataclasses.dataclass
class Texture:
    """Host-side image: [h, w, 4] uint8 (or float32 already-linear)."""

    data: np.ndarray
    is_srgb: bool = True  # decode to linear when packed
    repeat: bool = True  # wrap addressing (glTF default)

    @property
    def height(self):
        return self.data.shape[0]

    @property
    def width(self):
        return self.data.shape[1]


@dataclasses.dataclass
class StandardMaterial:
    base_color: Tuple[float, float, float, float] = (1.0, 1.0, 1.0, 1.0)
    base_color_texture: Optional[Texture] = None
    emissive: Tuple[float, float, float, float] = (0.0, 0.0, 0.0, 1.0)
    emissive_texture: Optional[Texture] = None
    perceptual_roughness: float = 0.5
    metallic: float = 0.01
    metallic_roughness_texture: Optional[Texture] = None
    reflectance: float = 0.5
    normal_map_texture: Optional[Texture] = None
    occlusion_texture: Optional[Texture] = None

    @staticmethod
    def from_color(r, g, b, a=1.0) -> "StandardMaterial":
        return StandardMaterial(base_color=(r, g, b, a))

    @property
    def emissive_intensity(self) -> float:
        """intensity = 255 * emissive.a * |emissive.rgb|
        (src/mesh_material/instance.rs:381-383)."""
        e = np.asarray(self.emissive, dtype=np.float64)
        return float(255.0 * e[3] * np.linalg.norm(e[:3]))


def srgb_to_linear(c: np.ndarray) -> np.ndarray:
    c = c.astype(np.float32)
    return np.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4)


def _to_linear_f32(tex: Texture) -> np.ndarray:
    """[h, w, 4] float32 linear texels (missing channels padded with 1)."""
    d = tex.data
    f = d.astype(np.float32) / 255.0 if d.dtype == np.uint8 \
        else d.astype(np.float32)
    if f.ndim == 2:
        f = f[..., None]
    if f.shape[-1] < 4:
        pad = np.ones(f.shape[:-1] + (4 - f.shape[-1],), np.float32)
        f = np.concatenate([f, pad], axis=-1)
    if tex.is_srgb:
        f = np.concatenate([srgb_to_linear(f[..., :3]), f[..., 3:4]], axis=-1)
    return f


def pack_atlas(textures: List[Texture], max_side: int = 8192):
    """Shelf-pack textures (tallest first) into one [A, A, 4] float32
    atlas, A a power of two from 128. Returns (atlas, rects [T,4] int32 as
    (x, y, w, h) of each inner rect). Every texture keeps a 1-texel WRAPPED
    border, so a bilinear footprint's taps at -1 and w read real texels.
    No textures give an 8x128 white atlas and one zero rect."""
    if not textures:
        return np.ones((8, 128, 4), dtype=np.float32), np.zeros((1, 4),
                                                                 np.int32)
    imgs = [_to_linear_f32(t) for t in textures]
    order = sorted(range(len(imgs)), key=lambda i: -imgs[i].shape[0])

    side = 128
    total_area = sum((im.shape[0] + 2) * (im.shape[1] + 2) for im in imgs)
    while side * side < total_area * 1.2 and side < max_side:
        side *= 2

    while True:
        rects = np.zeros((len(imgs), 4), np.int32)
        x = y = shelf_h = 0
        ok = True
        for i in order:
            h, w = imgs[i].shape[0] + 2, imgs[i].shape[1] + 2
            if w > side:
                ok = False
                break
            if x + w > side:
                x = 0
                y += shelf_h
                shelf_h = 0
            if y + h > side:
                ok = False
                break
            rects[i] = (x + 1, y + 1, w - 2, h - 2)
            x += w
            shelf_h = max(shelf_h, h)
        if ok:
            break
        side *= 2
        if side > max_side:
            raise ValueError("textures do not fit in the atlas")

    atlas = np.zeros((side, side, 4), dtype=np.float32)
    for i, im in enumerate(imgs):
        x0, y0, w, h = rects[i]
        atlas[y0:y0 + h, x0:x0 + w] = im
        atlas[y0 - 1, x0:x0 + w] = im[-1]
        atlas[y0 + h, x0:x0 + w] = im[0]
        atlas[y0:y0 + h, x0 - 1] = im[:, -1]
        atlas[y0:y0 + h, x0 + w] = im[:, 0]
        atlas[y0 - 1, x0 - 1] = im[-1, -1]
        atlas[y0 - 1, x0 + w] = im[-1, 0]
        atlas[y0 + h, x0 - 1] = im[0, -1]
        atlas[y0 + h, x0 + w] = im[0, 0]
    return atlas, rects


def pack_materials(materials: List[StandardMaterial]):
    """The material table (SoA numpy dict) with each slot's texture id,
    textures deduplicated by object identity (material.rs:54-87), and the
    atlas. Returns (table, atlas, rects, number of textures)."""
    textures: List[Texture] = []
    tex_ids = {}

    def tex_id(t: Optional[Texture]) -> int:
        if t is None:
            return NO_TEXTURE
        if id(t) not in tex_ids:
            tex_ids[id(t)] = len(textures)
            textures.append(t)
        return tex_ids[id(t)]

    n = len(materials)
    table = {
        "base_color": np.zeros((n, 4), np.float32),
        "emissive": np.zeros((n, 4), np.float32),
        "perceptual_roughness": np.zeros(n, np.float32),
        "metallic": np.zeros(n, np.float32),
        "reflectance": np.zeros(n, np.float32),
        **{slot: np.full(n, NO_TEXTURE, np.int32) for slot in _TEXTURE_SLOTS},
    }
    for i, m in enumerate(materials):
        table["base_color"][i] = m.base_color
        table["emissive"][i] = m.emissive
        table["perceptual_roughness"][i] = m.perceptual_roughness
        table["metallic"][i] = m.metallic
        table["reflectance"][i] = m.reflectance
        for slot in _TEXTURE_SLOTS:
            table[slot][i] = tex_id(getattr(m, slot))
    atlas, rects = pack_atlas(textures)
    return table, atlas, rects, len(textures)
