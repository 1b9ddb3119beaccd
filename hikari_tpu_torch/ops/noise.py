"""Per-pixel blue-noise randoms (light.wgsl:1075-1079).

value = noise_texture[frame % 16][(pixel + frame) % 64].rgba, then shifted
by frame * golden ratio (mod 1) so sequences decorrelate over time. There
is no random generator: a frame's randoms depend only on its number.
"""

from __future__ import annotations

import numpy as np
import torch

from hikari_tpu_torch.utils.bluenoise import load_blue_noise
from hikari_tpu_torch.utils.math import GOLDEN_RATIO

NOISE_TEXTURE_COUNT = 16
NOISE_SIZE = 64


def noise_constant(device) -> torch.Tensor:
    """[16, 64, 64, 4] f32 blue-noise stack on `device`."""
    return torch.from_numpy(load_blue_noise()).to(device)


def sample_blue_noise(noise: torch.Tensor, frame_number: int, size):
    """[H, W, 4] randoms for this frame: the frame's texture rolled by the
    frame shift and tiled over the screen."""
    h, w = size
    tex = noise[frame_number % NOISE_TEXTURE_COUNT]
    shift = frame_number % NOISE_SIZE
    rolled = torch.roll(tex, shifts=(-shift, -shift), dims=(0, 1))
    reps_y = -(-h // NOISE_SIZE)
    reps_x = -(-w // NOISE_SIZE)
    r = rolled.repeat(reps_y, reps_x, 1)[:h, :w]
    scramble = float(np.float32(frame_number) * np.float32(GOLDEN_RATIO))
    return torch.fmod(r + scramble, 1.0)
