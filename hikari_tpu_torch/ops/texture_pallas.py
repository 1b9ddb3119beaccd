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

The launch is short (a few microseconds on the card), so the host path is
kept thin: the scene's atlas and rect tables are checked once per compiled
scene (the last one's are remembered by identity, so a recompiled scene's
new atlas is checked anew), the inputs are checked only for the layouts
the callers pass (the id row of `shading._material_rows`, the uv half of
the G-buffer's velocity_uv plane), and the call passes one packed table
(SAMPLE_TABLE, csrc/texture.cu's SampleCall) to a binding made once.
"""

from __future__ import annotations

import itertools
import math
import struct
import weakref

import torch

from hikari_tpu_torch import build as _build
from hikari_tpu_torch.ops._kernel import bind, check_launch, on_cpu, stream
from hikari_tpu_torch.ops.shading import sample_atlas

MAX_SLOTS = 4
# every slot tuple a launch takes: 1-4 distinct slot indices, ascending
_SLOT_TUPLES = frozenset(c for k in range(1, MAX_SLOTS + 1)
                         for c in itertools.combinations(range(MAX_SLOTS), k))
# csrc/texture.cu SampleCall: atlas, rect, ids, uv, out (pointers); n, ah,
# aw, n_rect, n_slots, slot[4], pad (ints)
SAMPLE_TABLE = struct.Struct("<5Q10i")
# values per pixel of the planes the callers slice: the id row and
# velocity_uv (csrc/texture.cu HK_ROW)
ROW = 4

# the last checked scene: (weak references to its atlas and rect table,
# (atlas pointer, rect pointer, A_h, A_w, T), its device)
_scene = [None]
# {(pixel shape, slots): (the strides of a contiguous [*lead, ROW] plane
# without / with its last, the shape of its [..., 2:4] slice, the
# output's shape, the pixel count, the table's slot part)}
_layouts = {}


def _scene_tables(scene, dev):
    """The atlas / rect part of a launch's table, checked at the first
    launch on these tensors."""
    atlas, rects = scene["atlas"], scene["tex_rect"]
    last = _scene[0]
    if last is not None and last[0]() is atlas and last[1]() is rects \
            and last[3] == dev:
        return last[2]
    if atlas.dtype != torch.float32 or rects.dtype != torch.int32:
        raise TypeError("atlas float32 and tex_rect int32 expected")
    if atlas.dim() != 3 or atlas.shape[2] != 4 or rects.dim() != 2 \
            or rects.shape[1] != 4:
        raise ValueError("atlas [A_h, A_w, 4] and tex_rect [T, 4] expected")
    if not (atlas.is_contiguous() and rects.is_contiguous()) \
            or atlas.device != dev or rects.device != dev:
        raise ValueError(f"atlas and tex_rect: contiguous, on {dev}")
    part = (atlas.data_ptr(), rects.data_ptr(), atlas.shape[0],
            atlas.shape[1], rects.shape[0])
    _scene[0] = (weakref.ref(atlas), weakref.ref(rects), part, dev)
    return part


def _layout(lead, slots):
    """The expected layouts and the table's fixed parts of a launch over
    the pixels `lead` (see _layouts)."""
    got = _layouts.get((lead, slots))
    if got is None:
        strides, step = [], ROW
        for d in reversed(lead):
            strides.append(step)
            step *= d
        rows = tuple(reversed(strides))
        got = _layouts[lead, slots] = (
            rows, rows + (1,), lead + (2,), (len(slots),) + lead + (4,),
            math.prod(lead),
            (len(slots),) + slots + (0,) * (MAX_SLOTS - len(slots) + 1))
    return got


def _bad_slice(name, t, lead, inner):
    """The error for t, not the [..., inner] (or [...] when inner is 0)
    slice of a contiguous [*lead, ROW] plane."""
    shape = lead + ((inner,) if inner else ())
    if tuple(t.shape) != shape:
        return ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if inner and t.stride(-1) != 1:
        return ValueError(f"{name}: its {inner} values per pixel are not "
                          "contiguous")
    return ValueError(f"{name}: strides {t.stride()}: pixels at no uniform "
                      f"stride of {ROW} (a slice of a contiguous [..., "
                      f"{ROW}] plane expected)")


def _launch(scene, ids, uv, lead, slots, row):
    """One launch of kernel 14 over the pixels `lead`: ids a contiguous
    [*lead, ROW] id row (`row`) or one slot's column of one. Returns the
    [len(slots), *lead, 4] output."""
    dev = ids.device
    atlas, rects, ah, aw, n_rect = _scene_tables(scene, dev)
    cols, rows, uv_shape, out_shape, n, tail = _layout(lead, slots)
    if ids.dtype is not torch.int32:
        raise TypeError(f"ids: dtype {ids.dtype}, expected torch.int32")
    if ids.stride() != (rows if row else cols):
        if row:
            raise ValueError(f"tid: strides {ids.stride()}, expected a "
                             f"contiguous int32 [..., {ROW}]")
        raise _bad_slice("tex_id", ids, lead, 0)
    if uv.stride() != rows or uv.shape != uv_shape \
            or uv.dtype is not torch.float32 or uv.device != dev:
        if uv.dtype is not torch.float32 or uv.device != dev:
            raise TypeError(f"uv: {uv.dtype} on {uv.device}, expected "
                            f"torch.float32 on {dev}")
        raise _bad_slice("uv", uv, lead, 2)
    buf = torch.empty(out_shape, dtype=torch.float32, device=dev)
    table = SAMPLE_TABLE.pack(atlas, rects, ids.data_ptr(), uv.data_ptr(),
                              buf.data_ptr(), n, ah, aw, n_rect, *tail)
    rc = bind(_build.load_cuda("texture"), "hk_sample_atlas", "tp")(
        table, stream(dev))
    check_launch(rc, "sample_atlas")
    return buf


def sample_atlas_slots(scene, tid, uv, slots):
    """Kernel 14: `sample_atlas` of each slot of `slots` (1-4 distinct
    indices of tid's last axis, ascending). Runs it per slot for CPU
    tensors and launches csrc/texture.cu once for all the slots for CUDA
    tensors: tid contiguous [..., 4] int32, uv [..., 2] float32 the last
    two values of a contiguous [..., 4] plane (velocity_uv's uv). The
    outputs are views of one allocation."""
    if on_cpu(tid):
        return [sample_atlas(scene, tid[..., s], uv) for s in slots]
    slots = tuple(slots)
    if slots not in _SLOT_TUPLES:
        raise ValueError(f"slots {slots}: 1-{MAX_SLOTS} distinct indices "
                         f"of the {ROW} ids, ascending, expected")
    shape = tid.shape
    if shape[-1] != ROW:
        raise ValueError(f"tid: shape {tuple(shape)}, expected a contiguous "
                         f"int32 [..., {ROW}]")
    buf = _launch(scene, tid, uv, shape[:-1], slots, True)
    sample_atlas_slots.launches += 1
    return buf.unbind(0)


def sample_atlas_coherent(scene, tex_id, uv):
    """Kernel 14 for one slot: `sample_atlas` for CPU tensors, the one-slot
    launch of sample_atlas_slots for CUDA tensors (tex_id int32: one slot's
    column of a contiguous [..., 4] id row; uv as sample_atlas_slots's)."""
    if on_cpu(tex_id):
        return sample_atlas(scene, tex_id, uv)
    buf = _launch(scene, tex_id, uv, tex_id.shape, (0,), False)
    sample_atlas_slots.launches += 1
    return buf[0]


sample_atlas_slots.launches = 0
