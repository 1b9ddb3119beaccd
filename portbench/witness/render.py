"""The witness: a cell's first frames rendered at a small size on the CPU
by a renderer package with the benchmark's public API (Scene, Mesh,
StandardMaterial, DirectionalLight, Camera, HikariSettings, Renderer),
from the cell's own scene, settings and traffic, written to
portbench/witness/<cell>.npz (with --still, the camera held at its first
pose and the scene moving as the traffic moves it: <cell>.still.npz). The committed files were rendered by
hikari_tpu, the JAX renderer the port was written from, whose code
shares nothing with the port's or the frozen reference's; the benchmark
never runs this module, and nothing in it imports a renderer by name
(the package comes from the command line). From the root of a checkout
that holds hikari_tpu:

    HIKARI_NO_COMPILE_CACHE=1 JAX_PLATFORMS=cpu python3 \\
        portbench/witness/render.py --package hikari_tpu --cell city-orbit \
        [--still]

portbench/tests/test_bench_witness.py renders the same frames with the
frozen reference (portbench/reference/hk) and holds them to these."""

from __future__ import annotations

import argparse
import importlib
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

WITNESS_DIR = os.path.dirname(os.path.abspath(__file__))
# 48 x 256 output: a 24 x 128 render size at SMAA's ratio 2, whole
# 128-wide groups for hikari_tpu's banded warps
SIZE = dict(width=256, height=48)
FRAMES = 6          # both parities, both validation frames (3 and 5)
SEED = 2 ** 31 + 5


def images(api, cell_name: str, device=None, still=False, settings=None,
           size=SIZE, frames=FRAMES, seed=SEED) -> np.ndarray:
    """[frames, H, W, 4] float32: frames 0 .. frames - 1 of the cell at
    `size` rendered by `api` (device: the Renderer's device argument, None
    for a package that takes none; still: the camera held at its first
    pose; settings: overrides over the configuration's)."""
    from portbench.harness.frames import Frames, to_numpy
    from portbench.harness.spec import load_cell
    from portbench.harness.traffic import Traffic

    cell = load_cell(cell_name)
    config = dict(cell.config, **size)
    config["settings"] = dict(config.get("settings", {}), **(settings or {}))
    desc = cell.scene.build()
    traffic = dict(cell.traffic)
    if still:
        traffic["camera"] = dict(traffic["camera"], degrees_per_frame=0.0)
    fr = Frames(api, config, desc, Traffic(traffic, seed, desc), device)
    return np.stack([to_numpy(fr.frame(f)) for f in range(frames)])


def path_of(cell_name: str, still=False) -> str:
    return os.path.join(WITNESS_DIR,
                        f"{cell_name}{'.still' if still else ''}.npz")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--package", required=True)
    ap.add_argument("--cell", required=True)
    ap.add_argument("--still", action="store_true")
    args = ap.parse_args(argv)
    api = importlib.import_module(args.package)
    imgs = images(api, args.cell, still=args.still)
    np.savez_compressed(path_of(args.cell, args.still), images=imgs,
                        package=args.package, seed=SEED, still=args.still,
                        size=[SIZE["height"], SIZE["width"]])
    print(args.cell, imgs.shape, float(np.abs(imgs).mean()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
