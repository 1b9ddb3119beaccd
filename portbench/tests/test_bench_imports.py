"""Nothing the benchmark runs imports JAX or hikari_tpu (top-level names
compared whole: hikari_tpu_torch begins with hikari_tpu), nothing of it
reads bench.py, chip_smoke.py or tests/, and the reference imports nothing
of hikari_tpu_torch."""

import ast
import os

from portbench.harness.spec import BENCH_DIR

FORBIDDEN = {"jax", "jaxlib", "flax", "hikari_tpu", "bench", "chip_smoke",
             "tests"}


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _sources(top):
    for d, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_module_of_portbench_imports_jax_or_hikari_tpu():
    for path in _sources(BENCH_DIR):
        bad = FORBIDDEN & set(_imports(path))
        assert not bad, (path, bad)


def test_the_reference_imports_nothing_of_the_port():
    for path in _sources(os.path.join(BENCH_DIR, "reference")):
        assert "hikari_tpu_torch" not in set(_imports(path)), path
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        names = [n.value for n in ast.walk(tree)
                 if isinstance(n, ast.Constant) and isinstance(n.value, str)
                 and n.value.split(".")[0] == "hikari_tpu_torch"]
        assert not names, (path, names)     # no import by a module name


def test_the_run_checks_whole_top_level_names():
    from portbench.run import forbidden_modules

    assert forbidden_modules({"hikari_tpu_torch": 1,
                              "hikari_tpu_torch.ops": 1,
                              "jaxtyping": 1}) == []
    assert forbidden_modules({"hikari_tpu.ops": 1, "jax": 1,
                              "jaxlib.xla": 1, "flax": 1}) == [
        "flax", "hikari_tpu.ops", "jax", "jaxlib.xla"]


def test_a_run_of_the_port_loads_no_forbidden_module():
    import subprocess
    import sys

    code = ("import sys; sys.path.insert(0, %r); import portbench.run as r;"
            " import hikari_tpu_torch, portbench.harness.cell,"
            " portbench.reference.hk; print(r.forbidden_modules())"
            % os.path.dirname(BENCH_DIR))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout
    assert out.strip().splitlines()[-1] == "[]"
