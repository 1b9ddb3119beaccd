"""Next-event-estimation light candidate selection (light.wgsl:599-708):
the port of hikari_tpu/ops/sampling.py.

Per ray: sample the solar cone of the directional light; walk the
emissive light BVH (every leaf in DFS order, the words of hikari_tpu's
stackless walk), reservoir-picking uniformly among the emissives whose
bounding-sphere box holds the point; pick one of the chosen emitter's
triangles through its alias table, sample a barycentric point, and probe
a ray masked to that emitter (tracer.probe_info, kernel 6 or 13) for the
real surface point and the area-to-solid-angle pdf. Occluded or back-facing picks fall back to the
directional candidate. All tensors are flat [N, ...].
"""

from __future__ import annotations

import torch

from portbench.reference.hk.ops._kernel import div
from portbench.reference.hk.ops.trace_pallas import DISTANCE_MAX
from portbench.reference.hk.utils.math import (F32_MAX, GOLDEN_RATIO,
                                         apply_normal_basis, dot3, normalize,
                                         sample_uniform_cone,
                                         sample_uniform_triangle_barycentric)

RAY_BIAS = 0.02
# hikari_tpu's table_gather reads row 0 for an out-of-range index in
# tables of up to this many rows, and clamps in larger ones
SMALL_TABLE_MAX = 64


def table_gather(table, idx):
    """table[idx] with hikari_tpu's out-of-range rule (an index into a
    small table that is out of range reads row 0; a large table clamps)."""
    t = table.shape[0]
    if t > SMALL_TABLE_MAX:
        return table[torch.clamp(idx.long(), 0, t - 1)]
    ok = (idx >= 0) & (idx < t)
    return table[torch.where(ok, idx, 0).long()]


def _round_i32(x):
    return torch.round(x).to(torch.int32)


def empty_hit_info(position, direction):
    """light.wgsl:488-494."""
    n = position.shape[0]
    dev = position.device
    pos = position + direction * DISTANCE_MAX
    return {
        "position": torch.cat([pos, torch.zeros((n, 1), device=dev)], -1),
        "normal": torch.zeros((n, 3), device=dev),
        "uv": torch.zeros((n, 2), device=dev),
        "instance": torch.full((n,), -1, dtype=torch.int32, device=dev),
        "material": torch.full((n,), -1, dtype=torch.int32, device=dev),
    }


def walk_emissive_bvh(scene, position, rand_x, exclude_instance):
    """Streaming uniform pick among the emissives containing `position`
    (light.wgsl:624-657). Returns (picked emissive index, -1 for none;
    count).

    Every leaf is visited in DFS order (em_leaf_order), at any number of
    emissives. This gives the words of hikari_tpu's stackless walk of
    `em_bvh_packed`: an inner node's box is the min/max of its leaves'
    float32 centre -+ radius boxes (the compile's builder and the host
    refit's LBVH alike) and the test is strict, so a subtree the walk
    skips holds only leaves that fail their own test, and the walk
    visits the others in the same order with the same golden-ratio
    updates. That walk only gains from its early stop, which lockstep
    tensor ops do not have. A call costs 4 + 28 E PyTorch ops for E
    emissives (480 at 17), of which 7 a leaf are views that launch no
    kernel."""
    em_packed = scene["em_packed"]
    order = scene["em_leaf_order"]
    rows = em_packed[order.long()]            # leaf order, on the device
    n = position.shape[0]
    dev = position.device
    picked = torch.full((n,), -1, dtype=torch.int32, device=dev)
    count = torch.zeros((n,), device=dev)
    rand_1d = rand_x
    for k in range(em_packed.shape[0]):
        c = rows[k, 4:7]
        r = rows[k, 7]
        inside = ((position > c - r) & (position < c + r)).all(-1)
        inst = _round_i32(rows[k, 8])
        take_leaf = inside & (inst != exclude_instance)
        new_rand = torch.fmod(rand_1d + GOLDEN_RATIO, 1.0)
        rand_1d = torch.where(take_leaf, new_rand, rand_1d)
        count = torch.where(take_leaf, count + 1.0, count)
        take = take_leaf & (rand_1d < div(1.0, torch.clamp(count, min=1.0)))
        picked = torch.where(take, order[k], picked)
    return picked, count


def select_light_candidate(scene, tracer, rand4, position, normal,
                           exclude_instance, cos_solar: float,
                           sample_emissive: bool):
    """Returns (candidate, info). candidate: {direction [N,3], p [N],
    max_distance [N], emissive_instance [N] int32 (-1: directional)}; info:
    the hit info of the sampled light point. cos_solar: the cosine of the
    solar angle (a host float32). sample_emissive=False is the direct
    channel's early-out (light.wgsl:619-621)."""
    n = position.shape[0]
    dev = position.device
    cone_dir = scene["dir_to_light"][:3].expand(n, 3)
    local_dir, _ = sample_uniform_cone(rand4[:, 2:4], cos_solar)
    rand_direction = apply_normal_basis(cone_dir, local_dir)
    ones = torch.ones((n,), device=dev)
    candidate = {
        "direction": rand_direction,
        "p": ones,
        "max_distance": torch.full((n,), F32_MAX, device=dev),
        "emissive_instance": torch.full((n,), -1, dtype=torch.int32,
                                        device=dev),
    }
    info = empty_hit_info(position, rand_direction)
    if not sample_emissive or scene["em_packed"].shape[0] == 0:
        return candidate, info

    picked, count = walk_emissive_bvh(scene, position, rand4[:, 0],
                                      exclude_instance)
    has_pick = picked >= 0
    em_row = table_gather(scene["em_packed"], torch.clamp(picked, min=0))

    # alias-table triangle pick (light.wgsl:662-669)
    a_count_f = em_row[:, 10]
    a_count = _round_i32(a_count_f)
    a_offset = _round_i32(em_row[:, 9])
    alias_index = torch.minimum((rand4[:, 0] * a_count_f).to(torch.int32),
                                torch.clamp(a_count - 1, min=0))
    alias_row = table_gather(scene["alias_packed"], a_offset + alias_index)
    take_alias = rand4[:, 1] < alias_row[:, 0]
    prim_local = torch.where(take_alias, _round_i32(alias_row[:, 1]),
                             alias_index)
    em_inst = _round_i32(em_row[:, 8])
    # the sampled triangle's vertices from the emissive-only table
    em_prim = (_round_i32(table_gather(scene["em_inst_tri_offset_f"],
                                       em_inst)) + prim_local)
    v = table_gather(scene["em_tri_pos_flat"], em_prim)[:, :9]
    b = sample_uniform_triangle_barycentric(rand4[:, 2:4])
    b0, b1 = b[:, 0:1], b[:, 1:2]
    p = b0 * v[:, 0:3] + b1 * v[:, 3:6] + (1.0 - b0 - b1) * v[:, 6:9]

    ro = position + normal * RAY_BIAS
    rd = normalize(p - position)
    # the probe ray is include-masked to the picked emitter (-2: no pick)
    pinfo = tracer.probe_info(scene, ro, rd,
                              torch.full((n,), F32_MAX, device=dev), None,
                              torch.where(has_pick, em_inst, -2))
    probe_ok = has_pick & (dot3(rd, normal) > 0.0) & (pinfo["instance"] >= 0)

    delta = pinfo["position"][:, :3] - position
    d2 = dot3(delta, delta)
    denom = torch.abs(dot3(rd, pinfo["normal"]) * em_row[:, 11])
    p_em = div(div(d2, torch.clamp(denom, min=1e-20)),
               torch.clamp(count, min=1.0))

    sel = probe_ok
    sel3 = sel[:, None]
    candidate = {
        "direction": torch.where(sel3, rd, rand_direction),
        "p": torch.where(sel, p_em, 1.0),
        "max_distance": torch.where(sel, pinfo["t"], F32_MAX),
        "emissive_instance": torch.where(sel, em_inst, -1),
    }
    # on a failed probe the empty info starts at the probe ray's origin
    # (light.wgsl:697-704)
    fallback = empty_hit_info(torch.where(sel3, position, ro),
                              rand_direction)
    info = {k: torch.where(sel3 if fallback[k].dim() == 2 else sel,
                           pinfo[k], fallback[k]) for k in fallback}
    return candidate, info


def occlude_hit_info(ro, rd, shadow_hit, info):
    """Overwrite info where the shadow ray hit an occluder
    (light.wgsl:526-533)."""
    occluded = shadow_hit["instance"] >= 0
    o3 = occluded[:, None]
    pos = ro + rd * shadow_hit["t"][:, None]
    pos4 = torch.cat([pos, torch.ones_like(pos[:, :1])], -1)
    return {
        "position": torch.where(o3, pos4, info["position"]),
        "normal": torch.where(o3, 0.0, info["normal"]),
        "uv": info["uv"],
        "instance": torch.where(occluded, shadow_hit["instance"],
                                info["instance"]),
        "material": torch.where(occluded, -1, info["material"]),
    }
