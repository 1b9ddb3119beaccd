"""Materials (the no-texture part of hikari_tpu/models/material.py).

`StandardMaterial` mirrors the subset of Bevy's StandardMaterial the
reference packs into its GPU material array. The port has no texture path
yet: any texture slot set raises NotImplementedError at pack time.
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
class StandardMaterial:
    base_color: Tuple[float, float, float, float] = (1.0, 1.0, 1.0, 1.0)
    base_color_texture: Optional[object] = None
    emissive: Tuple[float, float, float, float] = (0.0, 0.0, 0.0, 1.0)
    emissive_texture: Optional[object] = None
    perceptual_roughness: float = 0.5
    metallic: float = 0.01
    metallic_roughness_texture: Optional[object] = None
    reflectance: float = 0.5
    normal_map_texture: Optional[object] = None
    occlusion_texture: Optional[object] = None

    @staticmethod
    def from_color(r, g, b, a=1.0) -> "StandardMaterial":
        return StandardMaterial(base_color=(r, g, b, a))

    @property
    def emissive_intensity(self) -> float:
        """intensity = 255 * emissive.a * |emissive.rgb|
        (src/mesh_material/instance.rs:381-383)."""
        e = np.asarray(self.emissive, dtype=np.float64)
        return float(255.0 * e[3] * np.linalg.norm(e[:3]))


def pack_materials(materials: List[StandardMaterial]):
    """Pack the material table (SoA numpy dict) for scenes without
    textures; the same table as hikari_tpu's pack_materials."""
    n = len(materials)
    for i, m in enumerate(materials):
        for slot in _TEXTURE_SLOTS:
            if getattr(m, slot) is not None:
                raise NotImplementedError(
                    f"material {i}: {slot} set; textures are not ported yet")
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
    return table
