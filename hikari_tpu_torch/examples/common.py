"""The shared command-line entry point of the examples (the port of
examples/common.py, the analog of the reference's example binaries,
examples/*.rs): the options, the settings they override, and a run that
times the first and the steady frames, writes the last image as a PNG and
optionally the per-pass dissection.

The port adds `--device`: the examples render on CUDA (and raise when
there is none) unless given `--device cpu`, where the kernels' plain
PyTorch versions run."""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time

import torch

from hikari_tpu_torch.camera import Camera
from hikari_tpu_torch.config import HikariSettings, Taa, Upscale
from hikari_tpu_torch.renderer import Renderer


def parse_args(description: str, width=1280, height=720, argv=None):
    """The examples' options, parsed from `argv` (sys.argv when None)."""
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--width", type=int, default=width)
    p.add_argument("--height", type=int, default=height)
    p.add_argument("--frames", type=int, default=8)
    p.add_argument("--out", type=str, default=None,
                   help="PNG of the last frame (default: <name>.png in the "
                   "temporary directory)")
    p.add_argument("--denoise", action=argparse.BooleanOptionalAction,
                   default=None)
    p.add_argument("--taa", choices=["jasmine", "none"], default=None)
    p.add_argument("--upscale", choices=["smaa2", "smaa1", "fsr", "none"],
                   default=None)
    p.add_argument("--bounces", type=int, default=None)
    p.add_argument("--temporal-reuse", action=argparse.BooleanOptionalAction,
                   default=None)
    p.add_argument("--dump-passes", type=str, default=None,
                   help="directory to dump per-pass dissection images")
    p.add_argument("--device", type=str, default=None,
                   help="torch device to render on (default: CUDA; 'cpu' "
                   "runs the kernels' plain versions)")
    return p.parse_args(argv)


def apply_overrides(settings: HikariSettings, args) -> HikariSettings:
    """`settings` with the options the command line set."""
    kw = {}
    if args.denoise is not None:
        kw["denoise"] = args.denoise
    if args.taa is not None:
        kw["taa"] = Taa.JASMINE if args.taa == "jasmine" else Taa.NONE
    if args.upscale is not None:
        kw["upscale"] = {
            "smaa2": Upscale.smaa_tu4x(2.0),
            "smaa1": Upscale.smaa_tu4x(1.0),
            "fsr": Upscale.fsr1(2.0),
            "none": Upscale.none(),
        }[args.upscale]
    if args.bounces is not None:
        kw["indirect_bounces"] = args.bounces
    if args.temporal_reuse is not None:
        kw["temporal_reuse"] = args.temporal_reuse
    return dataclasses.replace(settings, **kw)


def synchronize(device: torch.device):
    """Wait for the work queued on `device` (nothing to wait for on the
    CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def default_out(name: str) -> str:
    """Where an example writes its image without --out."""
    return os.path.join(tempfile.gettempdir(), f"{name}.png")


def run(scene, camera_kwargs, settings, args, name: str):
    """Render `scene` from Camera.from_look_at(**camera_kwargs) at the
    options' size and settings for args.frames frames, print the first
    frame's and the steady frames' times, write the last image and, with
    --dump-passes, one dissection frame. Returns (renderer, last image)."""
    cam = Camera.from_look_at(width=args.width, height=args.height,
                              **camera_kwargs)
    settings = apply_overrides(settings, args)
    r = Renderer(scene, cam, settings, device=args.device)

    t0 = time.perf_counter()
    img = r.render_frame()
    synchronize(r.device)
    first_s = time.perf_counter() - t0
    print(f"[{name}] first frame (kernel builds + run): {first_s:.1f}s")

    t0 = time.perf_counter()
    for _ in range(max(args.frames - 1, 0)):
        img = r.render_frame()
    synchronize(r.device)
    n = max(args.frames - 1, 1)
    dt = (time.perf_counter() - t0) / n
    print(f"[{name}] steady-state: {dt * 1e3:.2f} ms/frame "
          f"({args.width}x{args.height}, {n} frames)")

    out = args.out or default_out(name)
    r.save_png(out, img)
    print(f"[{name}] saved {out}")

    if args.dump_passes:
        r.render_dissection(args.dump_passes)
        print(f"[{name}] per-pass dissection dumped to {args.dump_passes}")
    return r, img
