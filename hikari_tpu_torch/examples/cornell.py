"""The Cornell box with its emissive area light (the port of
examples/cornell.py, reference examples/cornell.rs), loaded from
$HIKARI_ASSETS/models/cornell.glb through the glTF loader; the reference
spawns no sun and clears to black.

    HIKARI_ASSETS=DIR python -m hikari_tpu_torch.examples.cornell

The asset is not in the repository: without HIKARI_ASSETS the directory is
the repository's `assets`, and a missing file raises FileNotFoundError.
tests/torch_glb.py writes a GLB of the procedural box
(tests/cornell_box.py) to stand in for it.
"""

from __future__ import annotations

import dataclasses
import os

from hikari_tpu_torch.config import HikariSettings
from hikari_tpu_torch.examples.common import parse_args, run
from hikari_tpu_torch.models.gltf import load_gltf_scene
from hikari_tpu_torch.models.scene import DirectionalLight, Scene

EYE, TARGET = (0.0, 1.0, 4.0), (0.0, 1.0, 0.0)
_REPO_ASSETS = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "assets")


def asset_path() -> str:
    """$HIKARI_ASSETS/models/cornell.glb, read when called."""
    return os.path.join(os.environ.get("HIKARI_ASSETS", _REPO_ASSETS),
                        "models", "cornell.glb")


def settings() -> HikariSettings:
    """HikariSettings() with a black clear colour (cornell.rs:17 inserts
    ClearColor(Color::BLACK))."""
    return dataclasses.replace(HikariSettings(),
                               clear_color=(0.0, 0.0, 0.0, 1.0))


def build_scene() -> Scene:
    path = asset_path()
    if not os.path.exists(path):
        raise FileNotFoundError(f"the Cornell box's asset {path} is missing "
                                "(set HIKARI_ASSETS)")
    sc = Scene()
    load_gltf_scene(path, sc)
    # cornell.rs spawns no sun: the emissive quad and ambient only
    sc.directional_light = DirectionalLight(illuminance=0.0)
    return sc


def main(argv=None):
    """Render the box from the command line's options; returns (renderer,
    last image)."""
    args = parse_args("cornell: emissive box via alias-table NEE", argv=argv)
    return run(build_scene(), dict(eye=EYE, target=TARGET), settings(),
               args, "cornell")


if __name__ == "__main__":
    main()
