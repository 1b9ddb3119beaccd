"""Math helpers (the part of hikari_tpu/utils/math.py the port's frames
use): tensor helpers batched over trailing ...x3 / ...x4 axes, the Bevy
PBR BRDF terms and low-discrepancy samplers of the modular lighting path,
and the per-frame integer hash on the host."""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.hk.ops._kernel import div, f32

F32_EPSILON = 1.1920929e-7
F32_MAX = 3.402823466e38
TAU = 6.283185307
INV_TAU = 0.159154943
PI = 3.14159265358979
GOLDEN_RATIO = 1.618033989

# Rec. 709 luminance coefficients.
LUMA = (0.2126, 0.7152, 0.0722)


def luminance(rgb: torch.Tensor) -> torch.Tensor:
    """Rec.709 luminance over the trailing rgb axis."""
    return (LUMA[0] * rgb[..., 0] + LUMA[1] * rgb[..., 1]
            + LUMA[2] * rgb[..., 2])


def dot3(a, b):
    return (a * b).sum(-1)


def normalize(v, eps=1e-20):
    return v * torch.rsqrt(torch.clamp(dot3(v, v), min=eps))[..., None]


def pcg_hash(value) -> np.uint32:
    """Integer hash (utils.wgsl:15-25) of one uint32, on the host."""
    m = np.uint64(0xFFFFFFFF)
    k = np.uint64(2654435769)
    state = (np.uint64(value) & m) ^ np.uint64(2747636419)
    state = (state * k) & m
    state = state ^ (state >> np.uint64(16))
    state = (state * k) & m
    state = state ^ (state >> np.uint64(16))
    state = (state * k) & m
    return np.uint32(state)


def random_float(value) -> np.float32:
    """uint32 -> [0,1] float32 (utils.wgsl:27-29), on the host: one scalar
    per frame (the spatial spiral's rotation)."""
    return np.float32(pcg_hash(value)) / np.float32(4294967295.0)


def saturate(x):
    return torch.clamp(x, 0.0, 1.0)


def apply_normal_basis(n: torch.Tensor, local: torch.Tensor) -> torch.Tensor:
    """Rotate `local` (z-up) into the branchless basis around n
    (utils.wgsl:42-50), without building per-pixel 3x3 matrices."""
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    s = torch.clamp(torch.sign(nz) * 2.0 + 1.0, max=1.0)
    u = div(-1.0, s + nz)
    v = nx * ny * u
    tx = 1.0 + s * nx * nx * u
    ty = s * v
    tz = -s * nx
    bx = v
    by = s + ny * ny * u
    bz = -ny
    lx, ly, lz = local[..., 0], local[..., 1], local[..., 2]
    return torch.stack([tx * lx + bx * ly + nx * lz,
                        ty * lx + by * ly + ny * lz,
                        tz * lx + bz * ly + nz * lz], -1)


def sample_uniform_disk(rand2):
    r = torch.sqrt(rand2[..., 0])
    theta = TAU * rand2[..., 1]
    return torch.stack([r * torch.cos(theta), r * torch.sin(theta)], -1)


def sample_cosine_hemisphere(rand2):
    """([..., 3] direction in the +z hemisphere, [...] pdf)."""
    t = sample_uniform_disk(rand2)
    tx, ty = t[..., 0], t[..., 1]
    z = torch.sqrt(torch.clamp(1.0 - (tx * tx + ty * ty), min=0.0))
    return torch.cat([t, z[..., None]], -1), f32(2.0 * INV_TAU) * z


def sample_uniform_cone(rand2, cos_angle):
    """Cone sample around +z with cos(half-apex angle) `cos_angle` (a
    float32 tensor of one word, such as a frame's dynamic word, or a host
    float32 value); returns (direction, pdf), both tensors."""
    cos_angle = torch.as_tensor(cos_angle, dtype=torch.float32,
                                device=rand2.device)
    one_minus = 1.0 - cos_angle
    z = 1.0 - one_minus * rand2[..., 0]
    theta = TAU * rand2[..., 1]
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    direction = torch.stack([r * torch.cos(theta), r * torch.sin(theta), z],
                            -1)
    return direction, div(f32(INV_TAU), torch.clamp(one_minus, min=1e-7))


def sample_uniform_triangle_barycentric(rand2):
    srx = torch.sqrt(rand2[..., 0])
    return torch.stack([1.0 - srx, rand2[..., 1] * srx], -1)


def perceptual_roughness_to_roughness(perceptual):
    clamped = torch.clamp(perceptual, 0.089, 1.0)
    return clamped * clamped


def _pow5(x):
    x2 = x * x
    return x2 * x2 * x


def f_schlick_scalar(f0, f90, voh):
    return f0 + (f90 - f0) * _pow5(1.0 - voh)


def fd_burley(roughness, nov, nol, loh):
    f90 = 0.5 + 2.0 * roughness * loh * loh
    light_scatter = f_schlick_scalar(1.0, f90, nol)
    view_scatter = f_schlick_scalar(1.0, f90, nov)
    return light_scatter * view_scatter * f32(1.0 / PI)


def d_ggx(roughness, noh):
    one_minus = 1.0 - noh * noh
    a = noh * roughness
    k = div(roughness, one_minus + a * a)
    return k * k * f32(1.0 / PI)


def v_smith_ggx_correlated(roughness, nov, nol):
    a2 = roughness * roughness
    lambda_v = nol * torch.sqrt((nov - a2 * nov) * nov + a2)
    lambda_l = nov * torch.sqrt((nol - a2 * nol) * nol + a2)
    return div(0.5, torch.clamp(lambda_v + lambda_l, min=1e-7))


def fresnel(f0, loh):
    f90 = saturate(dot3(f0, torch.full_like(f0, f32(50.0 * 0.33))))
    return f0 + (f90[..., None] - f0) * _pow5(1.0 - loh)[..., None]


def specular_brdf(f0, roughness, nov, nol, noh, loh):
    d = d_ggx(roughness, noh)
    v = v_smith_ggx_correlated(roughness, nov, nol)
    return (d * v)[..., None] * fresnel(f0, loh)


def env_brdf_approx(f0, perceptual_roughness, nov):
    """Karis mobile EnvBRDF approximation (Bevy's EnvBRDFApprox)."""
    pr = perceptual_roughness
    r0 = pr * -1.0 + 1.0
    r1 = pr * -0.0275 + 0.0425
    r2 = pr * -0.572 + 1.04
    r3 = pr * 0.022 + -0.04
    a004 = torch.minimum(r0 * r0, torch.exp2(-9.28 * nov)) * r0 + r1
    ab_x = -1.04 * a004 + r2
    ab_y = 1.04 * a004 + r3
    return f0 * ab_x[..., None] + ab_y[..., None]


def rgb_to_ycocg(rgb: torch.Tensor) -> torch.Tensor:
    """Playdead TAA color space (taa.wgsl:20-26); the divisions by powers
    of two are exact."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    y = r / 4.0 + g / 2.0 + b / 4.0
    co = r / 2.0 - b / 2.0
    cg = -r / 4.0 + g / 2.0 - b / 4.0
    return torch.stack([y, co, cg], -1)


def ycocg_to_rgb(ycocg: torch.Tensor) -> torch.Tensor:
    y, co, cg = ycocg[..., 0], ycocg[..., 1], ycocg[..., 2]
    return torch.clamp(torch.stack([y + co - cg, y + cg, y - co - cg], -1),
                       0.0, 1.0)


def clip_towards_aabb_center(prev_color, aabb_min, aabb_max):
    """Variance clipping (taa.wgsl:37-45)."""
    p_clip = 0.5 * (aabb_max + aabb_min)
    e_clip = 0.5 * (aabb_max - aabb_min)
    v_clip = prev_color - p_clip
    v_unit = div(v_clip, torch.where(e_clip == 0.0, 1e-20, e_clip))
    ma_unit = v_unit.abs().amax(-1, keepdim=True)
    clipped = p_clip + div(v_clip, torch.clamp(ma_unit, min=1e-20))
    return torch.where(ma_unit > 1.0, clipped, prev_color)


def change_luminance(c_in, l_out):
    l_in = torch.clamp(luminance(c_in), min=1e-8)
    return c_in * (l_out / l_in)[..., None]


def reinhard_luminance(color):
    """Bevy's luminance-based Reinhard tone map."""
    l_old = luminance(color)
    l_new = l_old / (1.0 + l_old)
    return change_luminance(color, l_new)


def inverse_reinhard_luminance(color):
    """Inverse Reinhard (overlay.wgsl:28-33)."""
    l_old = torch.clamp(luminance(color), 0.0005, 0.995)
    l_new = l_old / (1.0 - l_old)
    return change_luminance(color, l_new)
