"""The simple scene of examples/simple.py (reference examples/simple.rs) for
the port: a box room on a ground plane with two emissive Earth spheres and
a sun (BASELINE config 3; 2,522 triangles, so kernel 13 traces it).

`build_scene(earth_tex)` puts `earth_tex` in both spheres' base-colour and
emissive slots, as the reference does with the Earth image; without one the
spheres are untextured. The image is not in the repository, so
`procedural_earth(seed)` makes a seeded stand-in of the same size as the
reference's thumbnail. `settings()` is the example's HikariSettings() with
emissive spatial reuse, and EYE / TARGET its camera. `main` is the
example's entry point; like hikari_tpu's it textures the spheres with the
Earth image when $HIKARI_ASSETS holds it (city.earth_texture).

    python -m hikari_tpu_torch.examples.simple --width 1920 --height 1080
"""

from __future__ import annotations

import dataclasses

import numpy as np

from hikari_tpu_torch.config import HikariSettings
from hikari_tpu_torch.examples.city import earth_texture
from hikari_tpu_torch.examples.common import parse_args, run
from hikari_tpu_torch.models import mesh as shapes
from hikari_tpu_torch.models.material import StandardMaterial, Texture
from hikari_tpu_torch.models.scene import (DirectionalLight, Scene,
                                           make_transform)

EYE, TARGET = (-10.0, 2.5, 20.0), (0.0, 0.0, 0.0)
# the Earth thumbnail's size: the 2:1 daymap at 1024 texels wide
EARTH_SHAPE = (512, 1024)


def rot_x(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]])


def procedural_earth(seed: int = 0) -> Texture:
    """A seeded 512x1024 RGBA uint8 sRGB stand-in for the Earth image:
    blocky continents (32x32-texel cells, 40% land) in green over blue
    ocean, with per-texel noise; alpha 255. Integer arithmetic only, so
    every machine makes the same texels."""
    rng = np.random.default_rng(seed)
    h, w = EARTH_SHAPE
    land = rng.random((h // 32, w // 32)) < 0.4
    land = np.repeat(np.repeat(land, 32, axis=0), 32, axis=1)
    base = np.where(land[..., None], np.array([40, 120, 50]),
                    np.array([20, 50, 150]))
    rgb = base + rng.integers(0, 64, (h, w, 3))
    alpha = np.full((h, w, 1), 255)
    return Texture(np.concatenate([rgb, alpha], -1).astype(np.uint8),
                   is_srgb=True)


def settings() -> HikariSettings:
    """The example's settings (simple.py:79-80)."""
    return dataclasses.replace(HikariSettings(), emissive_spatial_reuse=True)


def build_scene(earth_tex: Texture | None = None) -> Scene:
    sc = Scene()
    cube = sc.add_mesh(shapes.cube(1.0))
    plane = sc.add_mesh(shapes.plane(1.0))
    sphere = sc.add_mesh(shapes.uv_sphere(0.5))

    def mat(color, rough=0.9, **kw):
        return sc.add_material(StandardMaterial(
            base_color=tuple(color) + (1.0,), perceptual_roughness=rough,
            **kw))

    ground = mat((0.3, 0.5, 0.3))
    white = mat((1.0, 1.0, 1.0))
    pink = mat((1.0, 0.08, 0.58))   # Color::PINK
    aqua = mat((0.5, 1.0, 0.83))    # Color::AQUAMARINE

    sc.spawn(cube, ground, make_transform((0, -0.5, 0), scale=(8, 1, 8)))
    sc.spawn(plane, white, make_transform((0, -1.0, 0), scale=(400, 1, 400)))
    sc.spawn(cube, pink, make_transform((-3.5, 3, 0), scale=(1, 6, 8)))
    sc.spawn(cube, white, make_transform((3.5, 3, 0), scale=(1, 6, 8)))
    sc.spawn(cube, aqua, make_transform((0, 3, -3.5), scale=(6, 6, 1)))
    sc.spawn(cube, white, make_transform((0, 6.5, 0), scale=(8, 1, 8)))

    # the emissive Earth spheres
    for x, alpha in ((2.0, 0.5), (-2.0, 0.1)):
        m = sc.add_material(StandardMaterial(
            base_color_texture=earth_tex, emissive=(1.0, 1.0, 1.0, alpha),
            emissive_texture=earth_tex))
        sc.spawn(sphere, m,
                 make_transform((x, 1.0, 0.0), rotation=rot_x(-np.pi / 2)))

    sc.directional_light = DirectionalLight.from_euler(
        -np.pi / 4, np.pi / 4, 0.0, illuminance=10000.0)
    return sc


def main(argv=None):
    """Render the scene from the command line's options; returns (renderer,
    last image)."""
    args = parse_args("simple: ReSTIR reuse + TAA + emissive spheres",
                      argv=argv)
    return run(build_scene(earth_texture()), dict(eye=EYE, target=TARGET),
               settings(), args, "simple")


if __name__ == "__main__":
    main()
