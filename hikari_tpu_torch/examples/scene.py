"""The scene of examples/scene.py (reference examples/scene.rs) for the port:
BASELINE config 4, a ground plane, an emissive UV sphere and a
100,000 lux sun, rendered with 4 indirect bounces and FSR 1.0 at ratio 2.

hikari_tpu's example also loads the FlightHelmet glTF when it finds it
under $HIKARI_ASSETS; the asset is not in the repository and the port has
no glTF loader, so `build_scene()` is the example's scene without it:
1,226 triangles (the 2-triangle plane and the 1,224-triangle sphere),
above kernel A's and the fused lighting kernel's 768, so kernel 13
traces it and the frame takes the modular lighting path. `settings()` is
the example's settings and EYE / TARGET its camera. The command-line
entry point is not ported.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from hikari_tpu_torch.config import HikariSettings, Upscale
from hikari_tpu_torch.models import mesh as shapes
from hikari_tpu_torch.models.material import StandardMaterial
from hikari_tpu_torch.models.scene import (DirectionalLight, Scene,
                                           make_transform)

EYE, TARGET = (-4.0, 2.0, 4.0), (0.0, 1.0, 0.0)


def settings() -> HikariSettings:
    """The example's settings (scene.py:50-51): HikariSettings() with 4
    indirect bounces and FSR 1.0 at ratio 2."""
    return dataclasses.replace(HikariSettings(), indirect_bounces=4,
                               upscale=Upscale.fsr1(2.0))


def build_scene() -> Scene:
    """scene.py:26-46 without the glTF model."""
    sc = Scene()
    ground = sc.add_material(StandardMaterial((0.6, 0.6, 0.6, 1.0),
                                              perceptual_roughness=0.9))
    sc.spawn(sc.add_mesh(shapes.plane(40.0)), ground)

    # emissive sphere (scene.rs:85-104)
    sphere = sc.add_mesh(shapes.uv_sphere(0.5))
    em = sc.add_material(StandardMaterial(emissive=(1.0, 1.0, 1.0, 0.5)))
    sc.spawn(sphere, em, make_transform((2.0, 2.0, 0.0)))

    sc.directional_light = DirectionalLight.from_euler(
        -np.pi / 4, np.pi / 4, 0.0, illuminance=100000.0)
    return sc
