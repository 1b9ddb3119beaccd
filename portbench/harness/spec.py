"""Finds what a cell names, by name: the cell in BENCHMARK.json, its
configuration (portbench/configs/<config>.json, the data, and
<config>.py, the scene), its traffic mix
(portbench/traffic/<traffic>.json) and the per-layer metrics' readers
(portbench/metrics/<metric>.py). A later cell, configuration, traffic or
metric is added as files and BENCHMARK.json entries alone."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def load_module(path: str, name: str):
    """The Python file at `path` as a module named `name` (not entered in
    sys.modules)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    """One workload of BENCHMARK.json with everything it names."""

    name: str
    chips: int
    config: dict        # the configuration's JSON
    traffic: dict       # the traffic mix's JSON
    scene: object       # the configuration's scene module (build())
    end_to_end: list    # the end-to-end metric entries this cell reports
    per_layer: list     # the per-layer metric entries this cell reports
    bench_dir: str

    def reader(self, metric: str):
        """The per-layer metric's reader module (metrics/<metric>.py)."""
        return load_module(
            os.path.join(self.bench_dir, "metrics", f"{metric}.py"),
            f"portbench_metric_{metric.replace('.', '_').replace('-', '_')}")


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: str = ROOT,
              bench_dir: str = BENCH_DIR) -> Cell:
    """The cell `name` of root/BENCHMARK.json, its configuration, traffic
    and metrics, found under bench_dir by their names."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(has {sorted(cells)})")
    w = cells[name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    with open(os.path.join(root, cfg_entry["file"])) as f:
        config = json.load(f)
    with open(os.path.join(bench_dir, "traffic",
                           f"{w['traffic']}.json")) as f:
        traffic = json.load(f)
    scene = load_module(
        os.path.join(bench_dir, "configs", f"{w['config']}.py"),
        f"portbench_config_{w['config'].replace('-', '_')}")
    return Cell(
        name=name, chips=int(w["chips"]), config=config, traffic=traffic,
        scene=scene,
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)],
        bench_dir=bench_dir)
