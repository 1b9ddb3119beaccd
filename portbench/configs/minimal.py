"""The minimal scene of bevy-hikari v0.3.15 examples/minimal.rs:20-66
(hikari_tpu_torch/examples/minimal.py), frozen: a 5 m plane and a unit
cube on it under a 10,000 lux sun, no emissive. 14 triangles, 2
materials."""

from __future__ import annotations

import numpy as np

from portbench.harness.scenes import SceneDesc, cube, make_transform, plane


def build() -> SceneDesc:
    return SceneDesc(
        meshes=[plane(5.0), cube(1.0)],
        materials=[dict(base_color=(0.3, 0.5, 0.3, 1.0)),
                   dict(base_color=(0.8, 0.7, 0.6, 1.0))],
        instances=[(0, 0, np.eye(4)),
                   (1, 1, make_transform((0.0, 0.5, 0.0)))],
        sun=dict(euler=(-np.pi / 4, np.pi / 4, 0.0), illuminance=10000.0))
