"""Surface retrieval (the no-texture part of hikari_tpu/ops/shading.py).

Batched over arbitrary leading dims [...]."""

from __future__ import annotations

import torch

from hikari_tpu_torch.utils.math import perceptual_roughness_to_roughness


def retrieve_surface(scene, material_idx: torch.Tensor, no_texture: bool):
    """Material table lookup (light.wgsl:729-781) for scenes without
    textures. material_idx < 0 (a miss) reads material 0; callers mask.
    Returns {base_color, emissive, reflectance, metallic, roughness,
    occlusion}."""
    if not no_texture:
        raise NotImplementedError("textured surfaces are not ported yet")
    table = scene["mat_packed"]
    m = torch.clamp(material_idx.long(), 0, table.shape[0] - 1)
    row = table[m]
    metallic = row[..., 9]
    return {
        "base_color": row[..., 0:4],
        "emissive": row[..., 4:8],
        "reflectance": row[..., 10],
        "metallic": metallic,
        "roughness": perceptual_roughness_to_roughness(row[..., 8]),
        "occlusion": torch.ones_like(metallic),
    }


def compute_emissive_radiance(emissive):
    """light.wgsl:594-596: radiance = 255 * a * rgb."""
    return 255.0 * emissive[..., 3:4] * emissive[..., :3]
