"""The city with 16 street lamps (path CL), built through either package's
Scene API (hikari_tpu or hikari_tpu_torch), so both render the same scene.
Shared by the port's tests and chip_smoke.py, which loads this file by
path.

The city is BASELINE config 5 after its three waves (examples/city.py for
hikari_tpu, hikari_tpu_torch/examples/city.py for the port: 122 instances,
2,618 triangles, the emissive Earth sphere, a 10,000 lux sun). A lamp
stands at each of 16 places along its two streets, x in {-14, -10, ...,
14} and z in {-4, 4}: a grey pole (a unit cube scaled (0.12, 3.0, 0.12) at
y = 1.5) and an emissive head (a unit cube scaled 0.4 at y = 3.2, emissive
(1.0, 0.8, 0.5, 0.2)). That gives 154 instances, 3,002 triangles and 17
emissives, so the emissive light BVH (33 nodes) is walked rather than
unrolled. Each head's light radius is half its box's diagonal plus
sqrt(255 * 0.2 * |rgb|), about 8.7 m, so a street point lies in several
lamps' boxes.
"""

from __future__ import annotations

import importlib

XS = (-14.0, -10.0, -6.0, -2.0, 2.0, 6.0, 10.0, 14.0)
ZS = (-4.0, 4.0)
# (x, z) of each lamp in spawn order; lamp i's pole is instance
# FIRST_LAMP + 2 i and its head FIRST_LAMP + 2 i + 1
LAMPS = tuple((x, z) for z in ZS for x in XS)
FIRST_LAMP = 122
POLE_Y, HEAD_Y = 1.5, 3.2


def city_module(package: str):
    """The city scene module of `package`: examples/city.py for
    hikari_tpu, hikari_tpu_torch/examples/city.py for the port."""
    if package == "hikari_tpu":
        return importlib.import_module("examples.city")
    return importlib.import_module(f"{package}.examples.city")


def lamp_transforms(package: str, x: float, z: float):
    """(pole, head) model matrices of a lamp at (x, z)."""
    scene_mod = importlib.import_module(f"{package}.models.scene")
    T = scene_mod.make_transform
    return (T((x, POLE_Y, z), scale=(0.12, 3.0, 0.12)),
            T((x, HEAD_Y, z), scale=(0.4, 0.4, 0.4)))


def build_city_lamps(package: str):
    """The lamp city as a Scene of `package` ("hikari_tpu" or
    "hikari_tpu_torch")."""
    shapes = importlib.import_module(f"{package}.models.mesh")
    material = importlib.import_module(f"{package}.models.material")
    Mat = material.StandardMaterial

    sc = city_module(package).build_scene(3)
    assert len(sc.instances) == FIRST_LAMP
    cube = sc.add_mesh(shapes.cube(1.0))
    grey = sc.add_material(Mat(base_color=(0.5, 0.5, 0.5, 1.0),
                               perceptual_roughness=0.9))
    lamp = sc.add_material(Mat(emissive=(1.0, 0.8, 0.5, 0.2)))
    for x, z in LAMPS:
        pole, head = lamp_transforms(package, x, z)
        sc.spawn(cube, grey, pole)
        sc.spawn(cube, lamp, head)
    return sc
