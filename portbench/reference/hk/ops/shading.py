"""Surface retrieval and PBR shading (light.wgsl:711-908), the port of
hikari_tpu/ops/shading.py.

Textures live in one f32 atlas (models/material.py pack_atlas) and are
sampled bilinearly with repeat addressing: mip-less `textureSampleLevel(...,
0.0)` is plain bilinear. `sample_atlas` is the exact four-texel gather; the
screen-coherent primary surfaces go through kernel 14
(ops/texture_pallas.py), which computes the same function on the card.

Batched over arbitrary leading dims [...]."""

from __future__ import annotations

import torch

from portbench.reference.hk.utils.math import (dot3, env_brdf_approx, fd_burley,
                                         normalize,
                                         perceptual_roughness_to_roughness,
                                         saturate, specular_brdf)

# mat_packed's columns of the texture ids of the sampled slots: base
# colour, emissive, metallic-roughness, occlusion
TEX_COLUMNS = slice(11, 15)
ALL_SLOTS = (True, True, True, True)


def _material_rows(scene, material_idx):
    table = scene["mat_packed"]
    m = torch.clamp(material_idx.long(), 0, table.shape[0] - 1)
    return table[m]


def texture_ids(row):
    """The four slots' texture ids (int32, -1 = none) of material rows."""
    return torch.round(row[..., TEX_COLUMNS]).to(torch.int32)


def sample_atlas(scene, tex_id, uv):
    """Bilinear atlas sample with repeat addressing: tex_id [...] int32
    (-1 = none), uv [..., 2]. Returns [..., 4]; tex_id < 0 yields 1.0 (a
    neutral multiplier). The exact mod-addressed four-texel gather of
    hikari_tpu's sample_atlas, one operation at a time; kernel 14 computes
    the same function. Ids beyond the rect table and indices outside the
    atlas clamp (only a non-finite uv reaches the atlas clamp)."""
    atlas, rects = scene["atlas"], scene["tex_rect"]
    ah, aw = atlas.shape[:2]
    rect = rects[torch.clamp(tex_id.long(), 0, rects.shape[0] - 1)]
    x0, y0 = rect[..., 0].long(), rect[..., 1].long()
    twi = torch.clamp(rect[..., 2].long(), min=1)
    thi = torch.clamp(rect[..., 3].long(), min=1)
    u = uv[..., 0] - torch.floor(uv[..., 0])
    v = uv[..., 1] - torch.floor(uv[..., 1])
    fx = u * twi.to(torch.float32) - 0.5
    fy = v * thi.to(torch.float32) - 0.5
    ix = torch.floor(fx)
    iy = torch.floor(fy)
    ax = (fx - ix)[..., None]
    ay = (fy - iy)[..., None]
    xi, yi = ix.long(), iy.long()

    def fetch(px, py):
        # repeat within the texture rect (integer-valued, so exact)
        x = torch.clamp(torch.remainder(px, twi) + x0, 0, aw - 1)
        y = torch.clamp(torch.remainder(py, thi) + y0, 0, ah - 1)
        return atlas[y, x]

    c00 = fetch(xi, yi)
    c10 = fetch(xi + 1, yi)
    c01 = fetch(xi, yi + 1)
    c11 = fetch(xi + 1, yi + 1)
    color = (c00 * (1 - ax) * (1 - ay) + c10 * ax * (1 - ay)
             + c01 * (1 - ax) * ay + c11 * ax * ay)
    return torch.where((tex_id >= 0)[..., None], color, 1.0)


def retrieve_surface(scene, material_idx: torch.Tensor, uv,
                     no_texture: bool, coherent: bool = False,
                     slots=ALL_SLOTS):
    """Material table lookup and texture modulation (light.wgsl:729-781),
    in the reference's channel conventions: metallic *= tex.r, occlusion =
    tex.r, roughness from perceptual_roughness only. material_idx < 0 (a
    miss) reads material 0; callers mask. A screen-coherent uv field
    (`coherent`, the primary surface) samples through kernel 14, one
    launch for all the slots sampled, any other through sample_atlas.
    `slots` (base colour, emissive, metallic-roughness, occlusion): the
    slots to sample; a slot no material of the scene textures multiplies
    by 1.0 everywhere, so a caller that knows so may leave it out with the
    same result. Returns {base_color, emissive, reflectance, metallic,
    roughness, occlusion}."""
    row = _material_rows(scene, material_idx)
    base_color = row[..., 0:4]
    emissive = row[..., 4:8]
    metallic = row[..., 9]
    occlusion = torch.ones_like(metallic)
    wanted = [s for s in range(4) if slots[s]]
    if not no_texture and wanted:
        tid = texture_ids(row)
        if coherent:
            from portbench.reference.hk.ops import texture_pallas as _tx

            texel = dict(zip(wanted, _tx.sample_atlas_slots(scene, tid, uv,
                                                            wanted)))
        else:
            texel = {s: sample_atlas(scene, tid[..., s], uv) for s in wanted}
        if slots[0]:
            base_color = base_color * texel[0]
        if slots[1]:
            emissive = emissive * texel[1]
        if slots[2]:
            metallic = metallic * torch.where(tid[..., 2] >= 0,
                                              texel[2][..., 0], 1.0)
        if slots[3]:
            occlusion = torch.where(tid[..., 3] >= 0, texel[3][..., 0], 1.0)
    return {
        "base_color": base_color,
        "emissive": emissive,
        "reflectance": row[..., 10],
        "metallic": metallic,
        "roughness": perceptual_roughness_to_roughness(row[..., 8]),
        "occlusion": occlusion,
    }


def retrieve_emissive(scene, material_idx, uv, no_texture: bool):
    """The material's emissive rgba, times its emissive texture."""
    row = _material_rows(scene, material_idx)
    emissive = row[..., 4:8]
    if not no_texture:
        emissive = emissive * sample_atlas(scene, texture_ids(row)[..., 1],
                                           uv)
    return emissive


def used_slots(scene) -> tuple:
    """Which texture slots any material of the scene textures (a host
    copy of the small material table: call it once per compiled scene)."""
    ids = scene["mat_packed"][:, TEX_COLUMNS].cpu()
    return tuple(bool(b) for b in (ids >= 0).any(0))


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
