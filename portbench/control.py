"""The control of the check that decides `correct`: the reference put in
the port's place with its image-space passes in bfloat16
(reference/compare.py `bf16_image_planes`), compared with the float32
reference on the frames a run of the cell compares, at the cell's own
size. The benchmark's runs never
run it. One JSON line per seed:

    python3 portbench/control.py --workload city-orbit --seeds 11 12 13

The control has to come out as not correct under the configuration's
limits (PERF.md gives its readings)."""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def control_numbers(cell, seed: int, device: str, limits=None) -> dict:
    """The control's numbers on one seed: the worst over the compared
    frames of the bfloat16 reference against the float32 reference."""
    from portbench.harness.traffic import Traffic
    from portbench.reference import compare

    desc = cell.scene.build()
    warm = warmup_frames(cell, desc, seed, device)
    frames = Traffic(cell.traffic, seed, desc).compared(warm)
    ref = compare.reference_images(cell.config, desc,
                                   Traffic(cell.traffic, seed, desc),
                                   frames, device)
    low = compare.reference_images(cell.config, desc,
                                   Traffic(cell.traffic, seed, desc),
                                   frames, device, control=True)
    correct, numbers, _, worst = compare.judge(
        low, ref, cell.config["limits"] if limits is None else limits)
    return {"seed": seed, "frames": frames, "correct": correct,
            "numbers": worst,
            "all": {f: compare.differences(low[f], ref[f]) for f in frames}}


def warmup_frames(cell, desc, seed, device) -> int:
    """The warm-up frame count a run of the cell takes (its frame keys)."""
    from portbench.harness.frames import Frames
    from portbench.harness.traffic import Traffic
    from portbench.reference import hk

    return Frames(hk, cell.config, desc, Traffic(cell.traffic, seed, desc),
                  device).warmup_frames()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from portbench.harness.spec import load_cell

    cell = load_cell(args.workload)
    for seed in args.seeds:
        t = time.perf_counter()
        out = control_numbers(cell, seed, args.device)
        out["seconds"] = time.perf_counter() - t
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
