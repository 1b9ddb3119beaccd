"""Renderer configuration (the port of hikari_tpu/config.py).

Fields that pick pipeline structure (taa, upscale, denoise, reuse toggles,
bounce count) are static: they select which passes the frame runs. Numeric
knobs ride the per-frame uniform dict (`make_frame_uniform`), here plain
Python scalars. The frame reads them as device words (frame.frame_words):
the settings' dynamic values (`dynamic_values`), so a retune changes words
and no operation, and what changes with the frame number. The number and
the validation intervals pick the frame's branches (`frame_parity`,
`validates`) only.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Tuple

import numpy as np


class Taa(enum.Enum):
    """Temporal anti-aliasing method."""

    JASMINE = "jasmine"
    NONE = "none"


class UpscaleMode(enum.Enum):
    FSR1 = "fsr1"
    SMAA_TU4X = "smaa_tu4x"
    NONE = "none"


@dataclasses.dataclass(frozen=True)
class Upscale:
    """Upscaler selection; `ratio` is clamped to [1, 2]."""

    mode: UpscaleMode = UpscaleMode.SMAA_TU4X
    ratio: float = 2.0
    sharpness: float = 0.0

    @staticmethod
    def fsr1(ratio: float = 2.0, sharpness: float = 0.0) -> "Upscale":
        return Upscale(UpscaleMode.FSR1, ratio, sharpness)

    @staticmethod
    def smaa_tu4x(ratio: float = 2.0) -> "Upscale":
        return Upscale(UpscaleMode.SMAA_TU4X, ratio)

    @staticmethod
    def none() -> "Upscale":
        """No upscaling: lighting runs at full resolution."""
        return Upscale(UpscaleMode.NONE, 1.0)

    @property
    def clamped_ratio(self) -> float:
        return float(min(2.0, max(1.0, self.ratio)))


@dataclasses.dataclass(frozen=True)
class HikariSettings:
    """Per-camera renderer settings; defaults equal hikari_tpu's."""

    direct_validate_interval: int = 3
    emissive_validate_interval: int = 5
    max_temporal_reuse_count: int = 50
    max_spatial_reuse_count: int = 800
    max_reservoir_lifetime: float = 100.0
    solar_angle: float = 0.046
    indirect_bounces: int = 1
    max_indirect_luminance: float = 10.0
    clear_color: Tuple[float, float, float, float] = (0.4, 0.4, 0.4, 1.0)
    temporal_reuse: bool = True
    emissive_spatial_reuse: bool = False
    indirect_spatial_reuse: bool = True
    denoise: bool = True
    taa: Taa = Taa.JASMINE
    upscale: Upscale = dataclasses.field(default_factory=Upscale)
    checkerboard_lighting: bool = False
    spatial_tap_scramble: bool = False

    @property
    def upscale_ratio(self) -> float:
        return self.upscale.clamped_ratio

    def static_key(self) -> tuple:
        """Fields that specialize the frame pipeline."""
        return (
            self.taa,
            self.upscale.mode,
            self.upscale.clamped_ratio,
            self.denoise,
            self.temporal_reuse,
            self.emissive_spatial_reuse,
            self.indirect_spatial_reuse,
            self.indirect_bounces,
            self.checkerboard_lighting,
            self.spatial_tap_scramble,
        )


@dataclasses.dataclass(frozen=True)
class HikariUniversalSettings:
    """Global toggles of the scene compile (reference src/lib.rs:375-397):
    without `build_mesh_acceleration_structure` the world BVH covers
    triangle 0 only, as hikari_tpu's debug toggle does, so only the
    brute-force engine (make_tracer at a `brute_force_max` at or above
    the triangle count) sees the whole scene."""

    build_mesh_acceleration_structure: bool = True
    build_instance_acceleration_structure: bool = True


# 3x3 a-trous kernel (reference src/view.rs:125-129).
ATROUS_KERNEL = np.array(
    [
        [0.0625, 0.125, 0.0625],
        [0.125, 0.25, 0.125],
        [0.0625, 0.125, 0.0625],
    ],
    dtype=np.float32,
)


def halton(base: int, index: int) -> float:
    """Halton low-discrepancy sequence."""
    result = 0.0
    f = 1.0
    i = index
    while i > 0:
        f /= base
        result += f * (i % base)
        i //= base
    return result


# 16 sub-pixel jitter points (halton bases 2 and 3, indices 0..15).
HALTON_JITTER = np.array(
    [[halton(2, i), halton(3, i)] for i in range(16)], dtype=np.float32
)


def frame_parity(frame_number: int) -> int:
    """The frame's parity in {0, 1}: the decimation's and checkerboard's
    phase and SMAA's odd frame (a host integer, a branch of the frame)."""
    return int(frame_number) & 1


def validates(frame_number: int, interval: int) -> bool:
    """A validation frame of a channel validated every `interval` frames
    (light.wgsl's frame % interval == 0; a branch of the frame)."""
    return int(frame_number) % max(int(interval), 1) == 0


# the settings' dynamic values as the frame reads them: name -> (offset,
# words) in the block of the frame's device words that carries them
# (frame.frame_words), each derived on the host from the frame uniform by
# dynamic_values, so that a retune reaches a captured frame as new words
DYNAMIC_LAYOUT = {"cos_solar": (0, 1), "max_indirect_luminance": (1, 1),
                  "temporal_cap": (2, 1), "spatial_caps": (3, 2),
                  "clear_color": (5, 4)}
DYNAMIC_WORDS = 9
_F32_MAX = np.finfo(np.float32).max


def dynamic_values(frame: dict, name: str) -> np.ndarray:
    """The float32 words of one dynamic value of DYNAMIC_LAYOUT, from the
    frame uniform's entries: cos(solar angle) in float32; the indirect
    luminance clamp; the temporal reuse cap min(count, 1e30); the spatial
    pair (the lifetime limit, F32_MAX for a lifetime <= 1, which never
    expires, and the spatial reuse cap); the clear colour. A branch on a
    value is taken here, on the host."""
    f = np.float32
    if name == "cos_solar":
        v = [np.cos(f(frame["solar_angle"]))]
    elif name == "max_indirect_luminance":
        v = [frame["max_indirect_luminance"]]
    elif name == "temporal_cap":
        v = [min(f(frame.get("max_temporal_reuse_count", 0.0)), f(1e30))]
    elif name == "spatial_caps":
        life = frame["max_reservoir_lifetime"]
        v = [_F32_MAX if life <= 1.0 else life,
             frame["max_spatial_reuse_count"]]
    elif name == "clear_color":
        v = list(frame["clear_color"])
    else:
        raise KeyError(name)
    return np.asarray(v, np.float32)


def dynamic_words(frame: dict) -> np.ndarray:
    """[DYNAMIC_WORDS] float32 words of every dynamic value, in
    DYNAMIC_LAYOUT's order."""
    out = np.zeros(DYNAMIC_WORDS, np.float32)
    for name, (at, n) in DYNAMIC_LAYOUT.items():
        out[at:at + n] = dynamic_values(frame, name)
    return out


def make_frame_uniform(settings: HikariSettings, frame_number: int) -> dict:
    """Per-frame scalars as Python numbers (float32-rounded where the
    reference holds them as f32)."""
    f32 = lambda v: float(np.float32(v))
    return {
        "number": int(frame_number),
        "direct_validate_interval": int(settings.direct_validate_interval),
        "emissive_validate_interval": int(settings.emissive_validate_interval),
        "indirect_bounces": int(settings.indirect_bounces),
        "max_temporal_reuse_count": f32(settings.max_temporal_reuse_count),
        "max_spatial_reuse_count": f32(settings.max_spatial_reuse_count),
        "max_reservoir_lifetime": f32(
            min(settings.max_reservoir_lifetime, 254.0)),
        "solar_angle": f32(settings.solar_angle),
        "max_indirect_luminance": f32(settings.max_indirect_luminance),
        "clear_color": tuple(f32(c) for c in settings.clear_color),
        "upscale_ratio": f32(settings.upscale_ratio),
    }


