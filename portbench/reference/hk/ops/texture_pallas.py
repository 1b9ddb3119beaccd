"""The coherent atlas sampler: kernel 14 (csrc/texture.cu) and its plain
version, ops/shading.py sample_atlas.

`sample_atlas_slots(scene, tid, uv, slots)` samples the texture atlas
bilinearly with repeat addressing at every pixel of a screen-coherent uv
field (the primary surface's), for each requested texture slot in one
launch: tid [..., 4] int32 (a pixel's four slot ids, -1 = none, which
gives 1.0; `shading.texture_ids` of its material row), uv [..., 2]
float32; returns one [..., 4] float32 per slot of `slots`.
`sample_atlas_coherent(scene, tex_id, uv)` is the one-slot case, tex_id
one slot's column of such an id row.

The TPU kernel (hikari_tpu/ops/texture_pallas.py) has no per-lane gather:
per 16x16 pixel group it DMAs one 64x256-texel bf16 window of a panel
tiling of the atlas, centred on the group's mean texel, applies the y
weights as a matrix product and clamps texels outside the window to its
edge. On Hopper a gather is a plain load, so the port samples every pixel
exactly: its result is sample_atlas's, bit for bit. The window, its clamp
and the bf16 panels are a TPU approximation and are not ported; where a
footprint lies inside its group's window the two agree to the window's
bf16 precision.
"""

from __future__ import annotations

from portbench.reference.hk.ops.shading import sample_atlas


def sample_atlas_slots(scene, tid, uv, slots):
    """Kernel 14: `sample_atlas` of each slot of `slots` (1-4 distinct
    indices of tid's last axis, ascending), slot by slot."""
    return [sample_atlas(scene, tid[..., s], uv) for s in slots]


def sample_atlas_coherent(scene, tex_id, uv):
    """Kernel 14 for one slot: `sample_atlas`."""
    return sample_atlas(scene, tex_id, uv)

