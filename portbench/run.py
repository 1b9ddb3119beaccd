"""Runs one cell of the benchmark once and prints its result as the last
line of standard output (one JSON object), from the root of a checkout:

    python3 portbench/run.py --workload city-orbit --seed 7 --seconds 20 \
        --trace 0

--trace 0 prints the cell's end-to-end metrics; --trace 1 its per-layer
metrics from a torch.profiler run over the window's first frames.
Each number the check compared is printed beside its limit on standard
error and under "compared", the result's last key. The run exits non-zero
and prints no result without as many CUDA devices as the cell asks for,
and when jax, jaxlib, flax or hikari_tpu is loaded once the window has
closed."""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# compile caches at fixed paths inside the checkout (the port's own nvcc
# builds go to build/hikari_tpu_torch/)
os.environ.setdefault("TRITON_CACHE_DIR",
                      os.path.join(ROOT, "build", "portbench", "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                      os.path.join(ROOT, "build", "portbench", "extensions"))

FORBIDDEN = ("jax", "jaxlib", "flax", "hikari_tpu")


def forbidden_modules(modules=None) -> list:
    """The loaded modules whose top-level name (before the first dot) is
    one of FORBIDDEN, compared whole."""
    modules = sys.modules if modules is None else modules
    return sorted({m for m in modules if m.split(".")[0] in FORBIDDEN})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from portbench.harness import cell as cell_mod
    from portbench.harness.spec import load_cell

    cell = load_cell(args.workload)
    if not torch.cuda.is_available():
        print("portbench: no CUDA device", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"portbench: {cell.name} needs {cell.chips} CUDA devices, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    result = cell_mod.run(cell, args.seed, args.seconds, bool(args.trace),
                          T_START)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    for name, c in result["compared"].items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
