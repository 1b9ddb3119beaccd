"""Per-pixel blue-noise randoms (light.wgsl:1075-1079).

value = noise_texture[frame % 16][(pixel + frame) % 64].rgba, then shifted
by frame * golden ratio (mod 1) so sequences decorrelate over time. There
is no random generator: a frame's randoms depend only on its number, whose
texture, shift and advance reach the frame as device words
(frame.frame_words), so one captured frame serves every number.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.hk.ops._kernel import frame_value
from portbench.reference.hk.utils.bluenoise import load_blue_noise
from portbench.reference.hk.utils.math import GOLDEN_RATIO

NOISE_TEXTURE_COUNT = 16
NOISE_SIZE = 64


def noise_constant(device) -> torch.Tensor:
    """[16, 64, 64, 4] f32 blue-noise stack on `device`."""
    return torch.from_numpy(load_blue_noise()).to(device)


def frame_advance(frame_number: int) -> np.float32:
    """frame_number * GOLDEN_RATIO in float32: the noise's scramble and the
    bounce randoms' advance (hikari_tpu's restir.py:608)."""
    return np.float32(frame_number) * np.float32(GOLDEN_RATIO)


def noise_index(frame_number: int):
    """(texture, shift) of the frame: frame % 16 and frame % 64."""
    return (frame_number % NOISE_TEXTURE_COUNT, frame_number % NOISE_SIZE)


def sample_blue_noise(noise: torch.Tensor, frame, size):
    """[H, W, 4] randoms for this frame: the frame's texture rolled by the
    frame shift and tiled over the screen, as one gather at indices made
    on the device. frame: the frame dict (its words `noise_index` and
    `advance`), or a frame number."""
    if not isinstance(frame, dict):
        frame = {"number": int(frame)}
    h, w = size
    dev = noise.device
    idx = frame_value(frame, "noise_index",
                      lambda: noise_index(frame["number"]), dev).to(
                          torch.int64)
    adv = frame_value(frame, "advance",
                      lambda: [frame_advance(frame["number"])], dev)
    tex = noise.index_select(0, idx[:1])[0]
    # rolled by the shift and tiled: texel ((y + shift) % 64, (x + ...))
    ys = torch.remainder(torch.arange(h, device=dev) + idx[1], NOISE_SIZE)
    xs = torch.remainder(torch.arange(w, device=dev) + idx[1], NOISE_SIZE)
    r = tex.index_select(0, ys).index_select(1, xs)
    return torch.fmod(r + adv, 1.0)
