"""Blue-noise texture stack: 16 textures of 64x64 RGBA, stored in
portbench/reference/hk/assets/blue_noise.npz (void-and-cluster, Ulichney 1993)."""

from __future__ import annotations

import os

import numpy as np

SIZE = 64
COUNT = 16
CHANNELS = 4

_ASSET = os.path.join(os.path.dirname(os.path.dirname(__file__)), "assets",
                      "blue_noise.npz")


def load_blue_noise() -> np.ndarray:
    """[COUNT, SIZE, SIZE, CHANNELS] float32 in [0, 1)."""
    with np.load(_ASSET) as f:
        return f["noise"]
