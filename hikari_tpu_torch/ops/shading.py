"""Surface retrieval and PBR shading (light.wgsl:711-908): the no-texture
part of hikari_tpu/ops/shading.py.

Batched over arbitrary leading dims [...]."""

from __future__ import annotations

import torch

from hikari_tpu_torch.utils.math import (dot3, env_brdf_approx, fd_burley,
                                         normalize,
                                         perceptual_roughness_to_roughness,
                                         saturate, specular_brdf)


def _material_rows(scene, material_idx, no_texture: bool):
    if not no_texture:
        raise NotImplementedError("textured surfaces are not ported yet")
    table = scene["mat_packed"]
    m = torch.clamp(material_idx.long(), 0, table.shape[0] - 1)
    return table[m]


def retrieve_surface(scene, material_idx: torch.Tensor, uv,
                     no_texture: bool):
    """Material table lookup (light.wgsl:729-781) for scenes without
    textures (`uv` would address them). material_idx < 0 (a miss) reads
    material 0; callers mask. Returns {base_color, emissive, reflectance,
    metallic, roughness, occlusion}."""
    row = _material_rows(scene, material_idx, no_texture)
    metallic = row[..., 9]
    return {
        "base_color": row[..., 0:4],
        "emissive": row[..., 4:8],
        "reflectance": row[..., 10],
        "metallic": metallic,
        "roughness": perceptual_roughness_to_roughness(row[..., 8]),
        "occlusion": torch.ones_like(metallic),
    }


def retrieve_emissive(scene, material_idx, uv, no_texture: bool):
    """The material's emissive rgba."""
    return _material_rows(scene, material_idx, no_texture)[..., 4:8]


def compute_emissive_radiance(emissive):
    """light.wgsl:594-596: radiance = 255 * a * rgb."""
    return 255.0 * emissive[..., 3:4] * emissive[..., :3]


def calculate_view(view, world_position):
    """View vector (light.wgsl:714-727), perspective branch."""
    return normalize(view["world_position"][:3] - world_position[..., :3])


def lit(radiance, diffuse_color, roughness, f0, l, n, v):
    """Burley diffuse + GGX specular (light.wgsl:796-818)."""
    h = normalize(l + v)
    nol = saturate(dot3(n, l))
    noh = saturate(dot3(n, h))
    loh = saturate(dot3(l, h))
    nov = torch.clamp(dot3(n, v), min=0.0001)
    diffuse = diffuse_color * fd_burley(roughness, nov, nol, loh)[..., None]
    spec = specular_brdf(f0, roughness, nov, nol, noh, loh)
    return (spec + diffuse) * radiance * nol[..., None]


def ambient(scene, diffuse_color, roughness, occlusion, f0, n, v):
    """Ambient env-BRDF term (light.wgsl:820-833)."""
    nov = torch.clamp(dot3(n, v), min=0.0001)
    diffuse_ambient = env_brdf_approx(diffuse_color, torch.ones_like(nov), nov)
    specular_ambient = env_brdf_approx(f0, roughness, nov)
    return (occlusion[..., None] * (diffuse_ambient + specular_ambient)
            * scene["ambient_color"][:3])


def _f0_diffuse(surface):
    base = surface["base_color"][..., :3]
    refl = surface["reflectance"][..., None]
    metal = surface["metallic"][..., None]
    f0 = 0.16 * refl * refl * (1.0 - metal) + base * metal
    return f0, base * (1.0 - metal)


def shading(scene, v, n, l, surface, input_radiance):
    """Mix of lit and ambient by the input alpha (light.wgsl:869-888)."""
    f0, diffuse_color = _f0_diffuse(surface)
    lit_radiance = lit(input_radiance[..., :3], diffuse_color,
                       surface["roughness"], f0, l, n, v)
    amb = ambient(scene, diffuse_color, surface["roughness"],
                  surface["occlusion"], f0, n, v)
    a = input_radiance[..., 3:4]
    return lit_radiance * a + amb * (1.0 - a)


def env_brdf(surface, v, n):
    """The full-reflectance approximation (light.wgsl:890-908)."""
    f0, diffuse_color = _f0_diffuse(surface)
    nov = torch.clamp(dot3(n, v), min=0.0001)
    diffuse_ambient = env_brdf_approx(diffuse_color, torch.ones_like(nov), nov)
    specular_ambient = env_brdf_approx(f0, surface["roughness"], nov)
    return surface["occlusion"][..., None] * (diffuse_ambient
                                              + specular_ambient)


def input_radiance(scene, rd, hit_instance, hit_material, hit_uv,
                   sample_directional: bool, sample_emissive,
                   sample_ambient: bool, cos_solar: float,
                   no_texture: bool):
    """Incoming radiance along a traced ray (light.wgsl:835-867): [..., 4],
    rgb + (1 - ambient flag). sample_emissive: the per-ray instance id that
    may emit; cos_solar: the cosine of the solar angle (a host float32)."""
    miss = hit_instance < 0
    hit_directional = dot3(rd, scene["dir_to_light"][:3].expand(rd.shape)) \
        >= cos_solar
    take_dir = miss & hit_directional if sample_directional \
        else torch.zeros_like(miss)
    dir_rgb = scene["dir_color"][:3]
    amb_rgb = (scene["ambient_color"][:3] if sample_ambient
               else torch.zeros(3, device=rd.device))
    em_rgb = compute_emissive_radiance(
        retrieve_emissive(scene, hit_material, hit_uv, no_texture))
    take_em = (~miss) & (hit_instance == sample_emissive)
    rgb = torch.where(take_dir[..., None], dir_rgb,
                      torch.where(miss[..., None], amb_rgb.expand(rd.shape),
                                  torch.where(take_em[..., None], em_rgb,
                                              0.0)))
    a = 1.0 - (miss & ~take_dir).to(torch.float32)
    return torch.cat([rgb, a[..., None]], -1)
