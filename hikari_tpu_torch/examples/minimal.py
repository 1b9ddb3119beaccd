"""The minimal scene (the port of examples/minimal.py, reference
examples/minimal.rs:20-66): a cube on a plane, lit by a 10,000 lux sun,
no emissive: 14 triangles.

    python -m hikari_tpu_torch.examples.minimal --width 1920 --height 1080
"""

from __future__ import annotations

import numpy as np

from hikari_tpu_torch.config import HikariSettings
from hikari_tpu_torch.examples.common import parse_args, run
from hikari_tpu_torch.models import mesh as shapes
from hikari_tpu_torch.models.material import StandardMaterial
from hikari_tpu_torch.models.scene import (DirectionalLight, Scene,
                                           make_transform)

EYE, TARGET = (-2.0, 2.5, 5.0), (0.0, 0.0, 0.0)


def settings() -> HikariSettings:
    """The example's settings: HikariSettings()."""
    return HikariSettings()


def build_scene() -> Scene:
    sc = Scene()
    plane = sc.add_mesh(shapes.plane(5.0))
    cube = sc.add_mesh(shapes.cube(1.0))
    green = sc.add_material(StandardMaterial.from_color(0.3, 0.5, 0.3))
    tan = sc.add_material(StandardMaterial.from_color(0.8, 0.7, 0.6))
    sc.spawn(plane, green)
    sc.spawn(cube, tan, make_transform((0.0, 0.5, 0.0)))
    sc.directional_light = DirectionalLight.from_euler(
        -np.pi / 4, np.pi / 4, 0.0, illuminance=10000.0)
    return sc


def main(argv=None):
    """Render the scene from the command line's options; returns (renderer,
    last image)."""
    args = parse_args("minimal: cube + plane + sun", argv=argv)
    return run(build_scene(), dict(eye=EYE, target=TARGET), settings(),
               args, "minimal")


if __name__ == "__main__":
    main()
