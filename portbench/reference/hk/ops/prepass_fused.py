"""Fused G-buffer prepass: kernel A (csrc/prepass_fused.cu) and its plain
version.

The port of hikari_tpu/ops/prepass_fused.py at full resolution: per pixel
the jittered camera ray, the nearest hit with normal/uv/material
interpolation, position and NDC depth, instance/material ids (+0.5),
velocity through the per-instance motion matrix, and the env-BRDF albedo.
`_assemble` adds the depth gradients (forward differences, plain tensor
ops as on the TPU) and returns ops/prepass.py's G-buffer contract.

Kernel 8 (`prepass_quads_kernel`, same source) writes the four SMAA
parity quads at half resolution, depth, velocity and instance only, by
moving the words of kernel A's planes at the parity pixels: it traces
nothing.
"""

from __future__ import annotations

import torch

from portbench.reference.hk.ops._kernel import const_values, div
from portbench.reference.hk.ops.light_fused import (MAX_MATERIALS, MAX_TRIS,
                                              _env_brdf_approx, _row_index,
                                              _rsqrt_n, _Surface)
from portbench.reference.hk.ops.prepass import (camera_rays, depth_gradient,
                                          jitter_tensor)
from portbench.reference.hk.ops.restir import parity_decimate
from portbench.reference.hk.ops.trace_pallas import closest_sweep, interpolate
from portbench.reference.hk.utils.math import F32_EPSILON, F32_MAX

DISTANCE_MAX = 65535.0
MAX_INSTANCES = 16
# the SMAA parity quads (a, b) in kernel 8's plane order 2a + b
QUAD_PARITIES = ((0, 0), (0, 1), (1, 0), (1, 1))

# parameter vector layout (hikari_tpu's _P_* offsets)
_P_INV_VP = 0     # inverse view_proj, row-major 16
_P_VP = 16        # view_proj 16
_P_PREV_VP = 32   # previous view_proj 16
_P_CAM = 48       # camera world position 3
_P_JIT = 51       # jitter pixels x, y
_P_WH = 53        # width, height (f32)
_P_ROW0 = 55      # the image row of the planes' first row (a row block)


def prepass_caps_error(scene):
    """The reason the scene exceeds kernel A's caps, or None."""
    if scene["tri_pos_flat"].shape[0] > MAX_TRIS:
        return f"{scene['tri_pos_flat'].shape[0]} triangles > {MAX_TRIS}"
    if scene["mat_packed"].shape[0] > MAX_MATERIALS:
        return f"{scene['mat_packed'].shape[0]} materials > {MAX_MATERIALS}"
    if scene["inst_motion"].shape[0] > MAX_INSTANCES:
        return f"{scene['inst_motion'].shape[0]} instances > {MAX_INSTANCES}"
    return None


def pack_params(view, prev_view, jitter, size, row0: int = 0
                ) -> torch.Tensor:
    """[56] f32 parameter vector on the view's device, every word on the
    device: the view's matrices, the jitter (the frame's device words, or
    host values: prepass.jitter_tensor) and the sizes (a constant); row0:
    the image row of the planes' first row (0: the whole image)."""
    h, w = size
    dev = view["view_proj"].device
    return torch.cat([view["inverse_view_proj"].reshape(-1),
                      view["view_proj"].reshape(-1),
                      prev_view["view_proj"].reshape(-1),
                      view["world_position"].reshape(-1)[:3],
                      jitter_tensor(jitter, dev),
                      const_values([w, h, row0], dev)])


def _project(m, px, py, pz):
    """Rows of a row-major 4x4 (a [16] float32 tensor, its entries 0-d
    tensors) applied to (p, 1)."""
    f = m.unbind(0)
    return tuple(px * f[4 * r] + py * f[4 * r + 1] + pz * f[4 * r + 2]
                 + f[4 * r + 3] for r in range(4))


def _surface_point(p, o, d, t_best, inst_f, motion):
    """World position, NDC depth and velocity of the nearest hit (kernel
    A's tail). p: the parameter vector (a tensor on the planes' device).
    Returns (mask, (wx, wy, wz), depth, velocity u, velocity v)."""
    z = torch.zeros_like(t_best)
    dx, dy, dz = d
    mask = inst_f >= 0.0
    tt = torch.where(mask, t_best, DISTANCE_MAX)
    wx = o[0] + dx * tt
    wy = o[1] + dy * tt
    wz = o[2] + dz * tt

    cx, cy, cz, cw = _project(p[_P_VP:_P_VP + 16], wx, wy, wz)
    depth = torch.where(mask, div(cz, cw), z)

    mm = motion[_row_index(torch.clamp(inst_f, min=0.0), motion.shape[0])]
    m = [mm[..., c] for c in range(16)]
    inv_pw = div(1.0, m[12] * wx + m[13] * wy + m[14] * wz + m[15])
    pwx = (m[0] * wx + m[1] * wy + m[2] * wz + m[3]) * inv_pw
    pwy = (m[4] * wx + m[5] * wy + m[6] * wz + m[7]) * inv_pw
    pwz = (m[8] * wx + m[9] * wy + m[10] * wz + m[11]) * inv_pw

    def clip_uv(cx_, cy_, cw_):
        return ((div(cx_, cw_) + 1.0) * 0.5,
                1.0 - (div(cy_, cw_) + 1.0) * 0.5)

    un, vn = clip_uv(cx, cy, cw)
    pcx, pcy, _pcz, pcw = _project(p[_P_PREV_VP:_P_PREV_VP + 16],
                                   pwx, pwy, pwz)
    up, vp = clip_uv(pcx, pcy, pcw)
    return (mask, (wx, wy, wz), depth, torch.where(mask, un - up, z),
            torch.where(mask, vn - vp, z))


def _params_view(params):
    return {"inverse_view_proj":
            params[_P_INV_VP:_P_INV_VP + 16].reshape(4, 4),
            "world_position": params[_P_CAM:_P_CAM + 3]}


def prepass_plain(params, tris, attrs, motion, mats, size):
    """Kernel A's body over whole planes: the image rows params[_P_ROW0]
    onwards, `size` (h, w) of them, of an image of params[_P_WH:_P_WH + 2]
    (w, h). Returns (position [h,w,4], normal [h,w,3], instance_material
    [h,w,2], velocity_uv [h,w,4], albedo [h,w,4])."""
    h, w = size
    dev = params.device
    p = params.cpu().numpy()
    origin, direction = camera_rays(
        _params_view(params), (int(p[_P_WH + 1]), int(p[_P_WH])),
        params[_P_JIT:_P_JIT + 2], rows=(int(p[_P_ROW0]), h))
    o = origin.unbind(-1)
    d = direction.unbind(-1)

    # the nearest hit, attributes interpolated from the winner's row
    t_best, uu, vv, prim, inst_f = closest_sweep(tris.cpu().numpy(), o, d,
                                                 F32_MAX, -1.0)
    (nx, ny, nz), (uvx, uvy), mat_f = interpolate(attrs, prim, uu, vv)
    z = torch.zeros((h, w), device=dev)
    mask, (wx, wy, wz), depth, velu, velv = _surface_point(
        params, o, d, t_best, inst_f, motion)
    nx, ny, nz = (torch.where(mask, c, z) for c in _rsqrt_n(nx, ny, nz))

    valid = depth >= F32_EPSILON
    surf = _Surface(mats, torch.clamp(mat_f, min=0.0))
    vvx, vvy, vvz = _rsqrt_n(o[0] - wx, o[1] - wy, o[2] - wz)
    nov = torch.clamp(nx * vvx + ny * vvy + nz * vvz, min=0.0001)
    da = _env_brdf_approx(*surf.diff, torch.ones_like(nov), nov)
    sa = _env_brdf_approx(*surf.f0, surf.rough, nov)

    position = torch.stack([torch.where(mask, wx, z), torch.where(mask, wy, z),
                            torch.where(mask, wz, z), depth], -1)
    normal = torch.stack([nx, ny, nz], -1)
    inst_mat = torch.stack([inst_f + 0.5, mat_f + 0.5], -1)
    vel_uv = torch.stack([velu, velv, torch.where(mask, uvx, z),
                          torch.where(mask, uvy, z)], -1)
    albedo = torch.stack([torch.where(valid, da[i] + sa[i], z)
                          for i in range(3)] + [valid.to(torch.float32)], -1)
    return position, normal, inst_mat, vel_uv, albedo


def prepass_kernel(params, tris, attrs, motion, mats, size):
    """Kernel A's plain version, `prepass_plain`. size: the (h, w) planes to
    write, the image rows params[_P_ROW0] onwards."""
    return prepass_plain(params, tris, attrs, motion, mats, size)


def quads_plain(position, velocity_uv, instance_material):
    """Kernel 8's body: the words of kernel A's position .w, velocity_uv
    .xy and instance_material .x ([H,W,*] planes) at image pixel
    (2y+a, 2x+b), at (y, x) of an [H/2,W/2] plane for each parity (a, b)
    of QUAD_PARITIES. Returns (depth [4,h,w], velocity [4,h,w,2], instance
    [4,h,w]), copies of the strided views (no arithmetic on the words)."""
    return (torch.stack([position[a::2, b::2, 3] for a, b in QUAD_PARITIES]),
            torch.stack([velocity_uv[a::2, b::2, :2]
                         for a, b in QUAD_PARITIES]),
            torch.stack([instance_material[a::2, b::2, 0]
                         for a, b in QUAD_PARITIES]))


def prepass_quads_kernel(position, velocity_uv, instance_material):
    """Kernel 8's plain version, `quads_plain`, over kernel A's own
    planes."""
    return quads_plain(position, velocity_uv, instance_material)


def _assemble(position, normal, inst_mat, vel_uv, albedo, grad_scale=1.0):
    """Kernel outputs -> (gbuf dict, albedo [h,w,4]); depth gradients are
    forward differences over `grad_scale` image pixels (2 for the
    decimated planes)."""
    gbuf = {
        "position": position,
        "normal": normal,
        "depth_gradient": depth_gradient(position[..., 3], grad_scale),
        "instance_material": inst_mat,
        "velocity_uv": vel_uv,
    }
    return gbuf, albedo


def prepass_fused(scene, view, prev_view, jitter, size, dec_parity=None):
    """Returns (gbuf dict matching ops/prepass.py's contract, albedo
    [H,W,4]). jitter: the [2] pixel jitter, the frame's device words, or
    host values (ops/prepass.frame_jitter).

    With dec_parity s (frame & 1) it also returns (g_dec, albedo_dec) at
    half the size: hikari_tpu's decimated second pass, which traces pixels
    (2y+s, 2x+s) with the full frame's jitter and size, so here they are
    kernel A's strided planes [s::2, s::2] with no second launch. Only the
    depth gradient is not a view: forward differences of the decimated
    depth over two image pixels."""
    err = prepass_caps_error(scene)
    if err is not None:
        raise NotImplementedError(f"scene beyond the prepass kernel: {err}")
    tables = (scene["tri_pos_flat"], scene["tri_attr"], scene["inst_motion"],
              scene["mat_packed"])
    params = pack_params(view, prev_view, jitter, size)
    planes = prepass_kernel(params, *tables, size)
    gbuf, albedo = _assemble(*planes)
    if dec_parity is None:
        return gbuf, albedo
    g_dec, albedo_dec = _assemble(
        *parity_decimate(planes, dec_parity), grad_scale=2.0)
    return gbuf, albedo, g_dec, albedo_dec


def prepass_fused_quads(gbuf):
    """The SMAA TU4X decimation context by kernel 8: {(a, b): {"depth"
    [h,w], "velocity" [h,w,2], "instance" [h,w]}} of image pixels
    (2y+a, 2x+b), h, w half of the size of `gbuf`, the full-size G-buffer
    `prepass_fused` returned for this frame (kernel A's planes).
    hikari_tpu traces these pixels again; their words equal kernel A's
    planes [a::2, b::2]."""
    planes = (gbuf["position"], gbuf["velocity_uv"],
              gbuf["instance_material"])
    depth, vel, inst = prepass_quads_kernel(*planes)
    return {ab: {"depth": depth[i], "velocity": vel[i], "instance": inst[i]}
            for i, ab in enumerate(QUAD_PARITIES)}
