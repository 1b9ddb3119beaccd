"""ReSTIR reservoirs and their 64 B packed carry (the port of
hikari_tpu/ops/reservoir.py: the empty reservoir, the channel-plane layout
and the structured reservoir algebra of the modular lighting path).

A reservoir has two working forms here:

* the structured dict of hikari_tpu (`empty_reservoir`,
  `pack_reservoir_planes`, `unpack_reservoir_planes`): [h,w,C] fields,
  `visible_instance` int32;
* the flat field dict the lighting and spatial kernels work on
  (`unpack_fields`, `pack_fields`): one [h,w] float32 plane per scalar
  field (vpx vpy vpz vpd, spx spy spz spw, vinst, rad_r..rad_a,
  rnd0..rnd3, vnx vny vnz, life, snx sny snz, count, w, w_sum, w2_sum).

Both pack into the same [h,16,w] channel planes, bit for bit as hikari_tpu
does, so carries cross between the two packages:

    0-3  visible position xyz + depth     4-6  sample position xyz
    7    visible instance (as float)      8-9  radiance rgba, bf16 pairs
    10-11 randoms, unorm16 pairs          12   visible normal snorm8 x3 + life u8
    13   sample normal snorm8 x3 + (sample flag * 255) u8
    14   count, w (bf16)                  15   w_sum, w2_sum (bf16)

bf16 is round-to-nearest-even on the raw bits; unorm16/snorm8 round half
to even (torch.round), and every packed word is a u32 bit pattern viewed
as float32 (never an arithmetic cast).
"""

from __future__ import annotations

import torch

from portbench.reference.hk.ops._kernel import div

PACKED_WIDTH = 16

# the sample fields a WRS replace copies (light_fused._RSV_SAMPLE_KEYS)
SAMPLE_KEYS = ("rad_r", "rad_g", "rad_b", "rad_a",
               "rnd0", "rnd1", "rnd2", "rnd3",
               "vpx", "vpy", "vpz", "vpd",
               "vnx", "vny", "vnz", "vinst",
               "spx", "spy", "spz", "spw",
               "snx", "sny", "snz")

_U32 = 0xFFFFFFFF


def _bits(f: torch.Tensor) -> torch.Tensor:
    """The u32 bit pattern of a float32 tensor, as int64."""
    return f.contiguous().view(torch.int32).to(torch.int64) & _U32


def _fbits(u: torch.Tensor) -> torch.Tensor:
    """float32 tensor whose bits are the u32 values in an int64 tensor."""
    u = u & _U32
    return torch.where(u >= 2 ** 31, u - 2 ** 32, u).to(torch.int32).view(
        torch.float32)


def _rne16(f):
    """float32 -> bf16 bits, round to nearest even (u32 arithmetic)."""
    u = _bits(f)
    return ((u + 0x7FFF + ((u >> 16) & 1)) & _U32) >> 16


def bf16_pair(a, b):
    return _fbits(_rne16(a) | (_rne16(b) << 16))


def bf16_unpair(lane):
    u = _bits(lane)
    return _fbits((u & 0xFFFF) << 16), _fbits(u & 0xFFFF0000)


def _unorm16(a):
    return torch.round(torch.clamp(a, 0.0, 1.0) * 65535.0).to(torch.int64)


def unorm16_pair(a, b):
    return _fbits(_unorm16(a) | (_unorm16(b) << 16))


def unorm16_unpair(lane):
    u = _bits(lane)
    return (div((u & 0xFFFF).to(torch.float32), 65535.0),
            div((u >> 16).to(torch.float32), 65535.0))


def snorm8_vec(nx, ny, nz, extra_u8):
    def enc(v):
        return torch.round((torch.clamp(v, -1.0, 1.0) * 0.5 + 0.5)
                           * 255.0).to(torch.int64)

    return _fbits(enc(nx) | (enc(ny) << 8) | (enc(nz) << 16)
                  | (extra_u8.to(torch.int64) << 24))


def snorm8_unvec(lane):
    u = _bits(lane)

    def dec(shift):
        return div(((u >> shift) & 0xFF).to(torch.float32), 255.0) * 2.0 - 1.0

    return (dec(0), dec(8), dec(16)), (u >> 24).to(torch.float32)


def unpack_fields(t: torch.Tensor) -> dict:
    """[h,16,w] channel planes -> flat field dict of [h,w] planes."""
    rad01 = bf16_unpair(t[:, 8])
    rad23 = bf16_unpair(t[:, 9])
    rnd01 = unorm16_unpair(t[:, 10])
    rnd23 = unorm16_unpair(t[:, 11])
    (vnx, vny, vnz), life = snorm8_unvec(t[:, 12])
    (snx, sny, snz), sflag = snorm8_unvec(t[:, 13])
    count, w = bf16_unpair(t[:, 14])
    w_sum, w2_sum = bf16_unpair(t[:, 15])
    return {
        "vpx": t[:, 0], "vpy": t[:, 1], "vpz": t[:, 2], "vpd": t[:, 3],
        "spx": t[:, 4], "spy": t[:, 5], "spz": t[:, 6],
        "spw": (sflag > 127.0).to(torch.float32),
        "vinst": t[:, 7],
        "rad_r": rad01[0], "rad_g": rad01[1],
        "rad_b": rad23[0], "rad_a": rad23[1],
        "rnd0": rnd01[0], "rnd1": rnd01[1],
        "rnd2": rnd23[0], "rnd3": rnd23[1],
        "vnx": vnx, "vny": vny, "vnz": vnz, "life": life,
        "snx": snx, "sny": sny, "snz": snz,
        "count": count, "w": w, "w_sum": w_sum, "w2_sum": w2_sum,
    }


def pack_fields(r: dict) -> torch.Tensor:
    """Flat field dict -> [h,16,w] channel planes (inverse of
    unpack_fields up to the packing's quantization)."""
    planes = [
        r["vpx"], r["vpy"], r["vpz"], r["vpd"],
        r["spx"], r["spy"], r["spz"], r["vinst"],
        bf16_pair(r["rad_r"], r["rad_g"]),
        bf16_pair(r["rad_b"], r["rad_a"]),
        unorm16_pair(r["rnd0"], r["rnd1"]),
        unorm16_pair(r["rnd2"], r["rnd3"]),
        snorm8_vec(r["vnx"], r["vny"], r["vnz"],
                   torch.clamp(r["life"], 0.0, 255.0)),
        snorm8_vec(r["snx"], r["sny"], r["snz"],
                   (r["spw"] > 0.5).to(torch.float32) * 255.0),
        bf16_pair(r["count"], r["w"]),
        bf16_pair(r["w_sum"], r["w2_sum"]),
    ]
    return torch.stack(planes, 1)


def zero_fields_where(mask, r: dict) -> dict:
    """The empty reservoir where `mask` (visible instance -1)."""
    out = {k: torch.where(mask, 0.0, v) for k, v in r.items()}
    out["vinst"] = torch.where(mask, -1.0, r["vinst"])
    return out


def empty_reservoir(size, device=None) -> dict:
    h, w = size

    def f(*c):
        return torch.zeros((h, w) + c, dtype=torch.float32, device=device)

    return {
        "radiance": f(4),
        "random": f(4),
        "visible_position": f(4),
        "visible_normal": f(3),
        "visible_instance": torch.full((h, w), -1, dtype=torch.int32,
                                       device=device),
        "sample_position": f(4),
        "sample_normal": f(3),
        "count": f(),
        "lifetime": f(),
        "w": f(),
        "w_sum": f(),
        "w2_sum": f(),
    }


def pack_reservoir_planes(r: dict) -> torch.Tensor:
    """Structured reservoir -> [h,16,w] channel planes."""
    vp, sp, rad, rnd = (r["visible_position"], r["sample_position"],
                        r["radiance"], r["random"])
    vn, sn = r["visible_normal"], r["sample_normal"]
    return pack_fields({
        "vpx": vp[..., 0], "vpy": vp[..., 1], "vpz": vp[..., 2],
        "vpd": vp[..., 3],
        "spx": sp[..., 0], "spy": sp[..., 1], "spz": sp[..., 2],
        "spw": sp[..., 3],
        "vinst": r["visible_instance"].to(torch.float32),
        "rad_r": rad[..., 0], "rad_g": rad[..., 1], "rad_b": rad[..., 2],
        "rad_a": rad[..., 3],
        "rnd0": rnd[..., 0], "rnd1": rnd[..., 1], "rnd2": rnd[..., 2],
        "rnd3": rnd[..., 3],
        "vnx": vn[..., 0], "vny": vn[..., 1], "vnz": vn[..., 2],
        "life": r["lifetime"],
        "snx": sn[..., 0], "sny": sn[..., 1], "snz": sn[..., 2],
        "count": r["count"], "w": r["w"], "w_sum": r["w_sum"],
        "w2_sum": r["w2_sum"],
    })


def unpack_reservoir_planes(t: torch.Tensor) -> dict:
    """[h,16,w] channel planes -> structured reservoir."""
    f = unpack_fields(t)

    def st(*keys):
        return torch.stack([f[k] for k in keys], -1)

    return {
        "visible_position": st("vpx", "vpy", "vpz", "vpd"),
        "sample_position": st("spx", "spy", "spz", "spw"),
        "visible_instance": f["vinst"].to(torch.int32),
        "radiance": st("rad_r", "rad_g", "rad_b", "rad_a"),
        "random": st("rnd0", "rnd1", "rnd2", "rnd3"),
        "visible_normal": st("vnx", "vny", "vnz"),
        "sample_normal": st("snx", "sny", "snz"),
        "lifetime": f["life"],
        "count": f["count"],
        "w": f["w"],
        "w_sum": f["w_sum"],
        "w2_sum": f["w2_sum"],
    }


# ---------------------------------------------------------------------------
# the structured reservoir algebra of the modular lighting path
# (hikari_tpu/ops/reservoir.py, light.wgsl:138-179, 917-952)
# ---------------------------------------------------------------------------

MAX_VARIANCE = 10.0
# the sample fields an update copies (everything but the statistics)
_STRUCT_SAMPLE_KEYS = ("radiance", "random", "visible_position",
                       "visible_normal", "visible_instance",
                       "sample_position", "sample_normal")


def _bcast(mask, t):
    """mask shaped to broadcast over t's trailing channel axis, if any."""
    return mask[..., None] if t.dim() > mask.dim() else mask


def where_reservoir(mask, a: dict, b: dict) -> dict:
    """Per-pixel select between two reservoirs (mask [h,w] bool)."""
    return {k: torch.where(_bcast(mask, a[k]), a[k], b[k]) for k in a}


def zero_where(mask, r: dict) -> dict:
    """The empty reservoir where `mask`."""
    return where_reservoir(mask, empty_reservoir(r["count"].shape,
                                                 r["count"].device), r)


def make_sample(radiance, random, visible_position, visible_normal,
                visible_instance, sample_position, sample_normal) -> dict:
    return {"radiance": radiance, "random": random,
            "visible_position": visible_position,
            "visible_normal": visible_normal,
            "visible_instance": visible_instance,
            "sample_position": sample_position,
            "sample_normal": sample_normal}


def set_reservoir(s: dict, w_new) -> dict:
    """A fresh reservoir of one sample (light.wgsl:138-144)."""
    r = dict(s)
    r["count"] = torch.ones_like(w_new)
    r["lifetime"] = torch.zeros_like(w_new)
    r["w"] = torch.zeros_like(w_new)
    r["w_sum"] = w_new
    r["w2_sum"] = w_new * w_new
    return r


def update_reservoir(r: dict, s: dict, w_new, mask=None) -> dict:
    """Weighted reservoir update (light.wgsl:146-173); `mask` gates the
    whole update."""
    if mask is None:
        mask = torch.ones_like(w_new, dtype=torch.bool)
    w_sum = r["w_sum"] + w_new
    w2_sum = r["w2_sum"] + w_new * w_new
    count = r["count"] + 1.0
    rnd = s["random"]
    rand = torch.fmod(rnd[..., 0] + rnd[..., 1] + rnd[..., 2] + rnd[..., 3],
                      1.0)
    replace = mask & (rand < div(w_new, torch.clamp(w_sum, min=1e-30)))
    out = dict(r)
    out["w_sum"] = torch.where(mask, w_sum, r["w_sum"])
    out["w2_sum"] = torch.where(mask, w2_sum, r["w2_sum"])
    out["count"] = torch.where(mask, count, r["count"])
    for k in _STRUCT_SAMPLE_KEYS:
        out[k] = torch.where(_bcast(replace, r[k]), s[k], r[k])
    return out


def merge_reservoir(r: dict, other: dict, p, mask=None) -> dict:
    """Merge another reservoir, count-weighted (light.wgsl:175-179)."""
    if mask is None:
        mask = torch.ones_like(p, dtype=torch.bool)
    out = update_reservoir(r, {k: other[k] for k in _STRUCT_SAMPLE_KEYS},
                           p * other["w"] * other["count"], mask)
    out["count"] = torch.where(mask, r["count"] + other["count"], r["count"])
    return out


def gather_reservoir_planes(planes, iy, ix, valid) -> dict:
    """The structured reservoirs of [h,16,w] planes at pixels (iy, ix)
    ([h',w'] int coordinates), the empty reservoir (zero words, visible
    instance -1) where not `valid`."""
    g = planes[iy.long(), :, ix.long()]                     # [h', w', 16]
    g = torch.where(valid[..., None], g, 0.0)
    r = unpack_reservoir_planes(g.permute(0, 2, 1))
    r["visible_instance"] = torch.where(valid, r["visible_instance"], -1)
    return r


def scatter_reservoir_planes(dst, iy, ix, src: dict, mask) -> torch.Tensor:
    """dst[iy, :, ix] = the packed src where `mask`: the cross-pixel
    invalidation scatter of the modular path (light.wgsl:1092-1095,
    1199-1202) on [h,16,w] planes; src and the coordinates live on the
    lighting domain [h',w']. Where several sources target one pixel the
    highest source index (row-major on the lighting domain) wins, on every
    device (the reference's scatter leaves it unspecified)."""
    h, _, w = dst.shape
    src_rows = pack_reservoir_planes(src).permute(0, 2, 1).reshape(
        -1, PACKED_WIDTH)
    target = (iy.long() * w + ix.long()).reshape(-1)
    m = mask.reshape(-1)
    # every source scatters (no compaction: the shapes stay the frame's);
    # a masked-out one offers -1, the empty winner
    source = torch.where(m, torch.arange(m.numel(), device=dst.device), -1)
    winner = torch.full((h * w,), -1, dtype=torch.int64, device=dst.device)
    winner = winner.scatter_reduce(0, target, source, "amax")
    hit = winner >= 0
    rows = dst.permute(0, 2, 1).reshape(h * w, PACKED_WIDTH)
    rows = torch.where(hit[:, None], src_rows[torch.clamp(winner, min=0)],
                       rows)
    return rows.reshape(h, w, PACKED_WIDTH).permute(0, 2, 1).contiguous()


def clamp_reservoir(r: dict, max_count: float) -> dict:
    """History clamp (light.wgsl:944-951, 1645-1651)."""
    over = r["count"] > max_count
    scale = torch.where(over, div(max_count,
                                  torch.clamp(r["count"], min=1e-30)), 1.0)
    out = dict(r)
    out["w_sum"] = r["w_sum"] * scale
    out["w2_sum"] = r["w2_sum"] * scale
    out["count"] = torch.clamp(r["count"], max=max_count)
    return out


def temporal_restir(r: dict, s: dict, w_new, max_count: float,
                    mask=None) -> dict:
    """update + clamp (light.wgsl:937-952)."""
    return clamp_reservoir(update_reservoir(r, s, w_new, mask), max_count)


def reservoir_variance(r: dict):
    """Stored variance (light.wgsl:1224-1227), capped at MAX_VARIANCE."""
    count = torch.clamp(r["count"], min=1e-30)
    mean = div(r["w_sum"], count)
    var = div(r["w2_sum"], count) - mean * mean
    var = torch.where(r["count"] < 1.0, var, div(var, count))
    return torch.clamp(var, max=MAX_VARIANCE)


def finalize_w(r: dict, target_luminance) -> dict:
    """r.w = w_sum / (count * lum(target)) (light.wgsl:1216-1217)."""
    total = r["count"] * target_luminance
    out = dict(r)
    out["w"] = torch.where(total > 0.0, div(r["w_sum"],
                                            torch.clamp(total, min=1e-30)),
                           0.0)
    return out


def check_previous_reservoir(r: dict, s: dict):
    """Temporal reprojection rejection (light.wgsl:917-935): depth ratio,
    normal dot, instance id. Returns (the reservoir, emptied where
    rejected; the ok mask)."""
    sd = s["visible_position"][..., 3]
    ratio = div(r["visible_position"][..., 3],
                torch.where(sd == 0.0, 1e-30, sd))
    ratio = torch.where(ratio < 1.0,
                        div(1.0, torch.where(ratio == 0.0, 1e-30, ratio)),
                        ratio)
    depth_miss = ratio > 1.05 * (1.0 + 0.5 * s["random"][..., 0])
    instance_miss = r["visible_instance"] != s["visible_instance"]
    vn, rn = s["visible_normal"], r["visible_normal"]
    normal_miss = (vn[..., 0] * rn[..., 0] + vn[..., 1] * rn[..., 1]
                   + vn[..., 2] * rn[..., 2]) < 0.9
    ok = ~(depth_miss | normal_miss | instance_miss)
    return zero_where(~ok, r), ok
