"""A procedural Cornell box built only from plane/cube/quad primitives,
through either package's Scene API (hikari_tpu or hikari_tpu_torch), so
both render the same scene. Shared by the port's tests and chip_smoke.py.

Walls: floor, ceiling, back, red left and green right (2 triangles each),
two white boxes (12 each) and a downward-facing emissive quad under the
ceiling (2): 36 triangles. No sun, as examples/cornell.py. The camera of
bench.py's flagship looks from (0, 1, 3.2) at (0, 1, 0).
"""

from __future__ import annotations

import importlib

import numpy as np

EYE = (0.0, 1.0, 3.2)
TARGET = (0.0, 1.0, 0.0)


def _rot_x(deg):
    a = np.radians(deg)
    c, s = np.cos(a), np.sin(a)
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]])


def _rot_y(deg):
    a = np.radians(deg)
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])


def _rot_z(deg):
    a = np.radians(deg)
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])


def build_cornell_box(package: str):
    """The box as a Scene of `package` ("hikari_tpu" or
    "hikari_tpu_torch")."""
    scene_mod = importlib.import_module(f"{package}.models.scene")
    shapes = importlib.import_module(f"{package}.models.mesh")
    material = importlib.import_module(f"{package}.models.material")
    Mat = material.StandardMaterial
    T = scene_mod.make_transform

    sc = scene_mod.Scene()
    wall = sc.add_mesh(shapes.plane(2.0))
    cube = sc.add_mesh(shapes.cube(1.0))
    lamp = sc.add_mesh(shapes.quad(0.5, 0.5))
    white = sc.add_material(Mat.from_color(0.73, 0.73, 0.73))
    red = sc.add_material(Mat.from_color(0.65, 0.05, 0.05))
    green = sc.add_material(Mat.from_color(0.12, 0.45, 0.15))
    light = sc.add_material(Mat(base_color=(0.78, 0.78, 0.78, 1.0),
                                emissive=(1.0, 0.9, 0.75, 1.0)))

    sc.spawn(wall, white, T((0, 0, 0)))                         # floor
    sc.spawn(wall, white, T((0, 2, 0), _rot_x(180)))            # ceiling
    sc.spawn(wall, white, T((0, 1, -1), _rot_x(90)))            # back
    sc.spawn(wall, red, T((-1, 1, 0), _rot_z(-90)))             # left
    sc.spawn(wall, green, T((1, 1, 0), _rot_z(90)))             # right
    sc.spawn(cube, white, T((0.33, 0.3, 0.3), _rot_y(-18),
                            (0.6, 0.6, 0.6)))                   # short box
    sc.spawn(cube, white, T((-0.35, 0.6, -0.35), _rot_y(17),
                            (0.6, 1.2, 0.6)))                   # tall box
    sc.spawn(lamp, light, T((0, 1.98, 0), _rot_x(90)))          # light
    sc.directional_light = scene_mod.DirectionalLight(illuminance=0.0)
    return sc
