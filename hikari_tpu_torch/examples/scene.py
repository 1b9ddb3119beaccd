"""The scene of examples/scene.py (reference examples/scene.rs) for the port:
BASELINE config 4, a ground plane, an emissive UV sphere and a
100,000 lux sun, rendered with 4 indirect bounces and FSR 1.0 at ratio 2.

hikari_tpu's example also loads the FlightHelmet glTF when it finds it
under $HIKARI_ASSETS (`build_scene(helmet=True)`, which `main` asks for);
the asset is not in the repository, so `build_scene()` is the example's
scene without it: 1,226 triangles (the 2-triangle plane and the
1,224-triangle sphere), above kernel A's and the fused lighting kernel's
768, so kernel 13 traces it and the frame takes the modular lighting
path. `settings()` is the example's settings and EYE / TARGET its camera.

    python -m hikari_tpu_torch.examples.scene --width 1920 --height 1080
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from hikari_tpu_torch.config import HikariSettings, Upscale
from hikari_tpu_torch.examples.common import parse_args, run
from hikari_tpu_torch.models.gltf import load_gltf_scene
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


def helmet_path():
    """$HIKARI_ASSETS/models/FlightHelmet/FlightHelmet.gltf, or None when
    HIKARI_ASSETS is unset."""
    assets = os.environ.get("HIKARI_ASSETS")
    if not assets:
        return None
    return os.path.join(assets, "models/FlightHelmet/FlightHelmet.gltf")


def build_scene(helmet: bool = False) -> Scene:
    """scene.py:26-46; the glTF model (scaled 6x, textures at most 512
    texels a side) only with `helmet` and when the file is there."""
    sc = Scene()
    path = helmet_path() if helmet else None
    if path and os.path.exists(path):
        load_gltf_scene(path, sc, max_texture_side=512)
        scale = 6.0
        for inst in sc.instances:
            inst.transform = make_transform(
                (0, 0, 0), scale=(scale,) * 3) @ inst.transform
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


def main(argv=None):
    """Render the scene (with the glTF model when found) from the command
    line's options; returns (renderer, last image)."""
    args = parse_args("scene: glTF + 4 bounces + FSR1", argv=argv)
    return run(build_scene(helmet=True), dict(eye=EYE, target=TARGET),
               settings(), args, "scene")


if __name__ == "__main__":
    main()
