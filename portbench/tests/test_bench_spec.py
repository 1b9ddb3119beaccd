"""The harness finds a cell's configuration, traffic and metrics by name:
a new cell is files and BENCHMARK.json entries alone, its settings, post
passes and readback included."""

import json
import os

import numpy as np
import pytest

from portbench.harness.spec import ROOT, load_cell


def _write(path, text):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(text)


def test_added_config_traffic_and_metric_are_found_by_name(tmp_path):
    bench = tmp_path / "newbench"
    _write(str(bench / "configs" / "tiny.json"),
           json.dumps({"name": "tiny", "width": 8, "height": 4,
                       "limits": {}}))
    _write(str(bench / "configs" / "tiny.py"),
           "from portbench.harness.scenes import SceneDesc, cube\n"
           "def build():\n"
           "    import numpy as np\n"
           "    return SceneDesc([cube()], [{}], [(0, 0, np.eye(4))],\n"
           "                     sun=dict(euler=(0, 0, 0), illuminance=1.0))\n")
    _write(str(bench / "traffic" / "spin.json"),
           json.dumps({"camera": {"target": [0, 0, 0], "radius": 1.0,
                                  "height": 0.5, "degrees_per_frame": 2.0},
                       "motions": [], "update_scene": False,
                       "in_flight": 2, "compare": {"first": 2, "count": 1}}))
    _write(str(bench / "metrics" / "frames_seen.py"),
           "def read(ctx):\n    return float(len(ctx.frames))\n")
    spec = {
        "command": ["python3", "newbench/run.py"], "paths": ["newbench"],
        "run_seconds": 10,
        "configs": [{"name": "tiny", "source": "https://example.org/tiny",
                     "file": "newbench/configs/tiny.json", "reduced": [],
                     "why": "a test"}],
        "workloads": [{"name": "tiny-spin", "config": "tiny",
                       "traffic": "spin", "chips": 1, "why": "a test"}],
        "end_to_end": [{"name": "fps", "unit": "frames/s",
                        "better": "higher", "bound": 0.1,
                        "source": "device_trace"}],
        "per_layer": [{"name": "frames_seen", "unit": "frames",
                       "better": "higher", "source": "program_counter",
                       "layer": "device", "moves": "fps",
                       "workloads": ["tiny-spin"]},
                      {"name": "elsewhere", "unit": "ms", "better": "lower",
                       "source": "device_trace", "layer": "device",
                       "moves": "fps", "workloads": ["other"]}],
    }
    _write(str(tmp_path / "BENCHMARK.json"), json.dumps(spec))
    cell = load_cell("tiny-spin", root=str(tmp_path), bench_dir=str(bench))
    assert cell.config["width"] == 8
    assert cell.traffic["camera"]["degrees_per_frame"] == 2.0
    assert cell.scene.build().num_triangles == 12
    assert [m["name"] for m in cell.per_layer] == ["frames_seen"]
    assert [m["name"] for m in cell.end_to_end] == ["fps"]

    class Ctx:
        frames = [5, 6, 7]

    assert cell.reader("frames_seen").read(Ctx) == 3.0


def test_benchmark_json_names_every_file_it_needs():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for w in bench["workloads"]:
        cell = load_cell(w["name"])
        assert cell.end_to_end and cell.per_layer
        for m in cell.per_layer:
            assert hasattr(cell.reader(m["name"]), "read")
    for c in bench["configs"]:
        assert os.path.exists(os.path.join(ROOT, c["file"]))


def test_a_configuration_sets_the_renderers_settings_and_post():
    from portbench.harness.frames import Frames
    from portbench.harness.scenes import SceneDesc, cube
    from portbench.harness.traffic import Traffic
    from portbench.reference import hk

    config = {"width": 16, "height": 8, "hdr": False,
              "settings": {"direct_validate_interval": 4,
                           "indirect_bounces": 2, "taa": "NONE",
                           "upscale": {"mode": "FSR1", "ratio": 1.5},
                           "clear_color": [0, 0, 0, 1]},
              "post": {"bloom": {"intensity": 0.1}, "fxaa": True}}
    traffic = {"camera": {"target": [0, 0, 0], "radius": 3.0,
                          "height": 1.0, "degrees_per_frame": 1.0},
               "motions": [], "update_scene": False, "in_flight": 1,
               "readback": True, "compare": {"first": 1, "count": 1}}
    desc = SceneDesc([cube()], [{}], [(0, 0, np.eye(4))],
                     sun=dict(euler=(-0.7, 0.7, 0), illuminance=1e4))
    fr = Frames(hk, config, desc, Traffic(traffic, 3, desc), "cpu")
    s = fr.renderer.settings
    assert s.direct_validate_interval == 4 and s.indirect_bounces == 2
    assert s.taa is hk.config.Taa.NONE
    assert s.upscale.mode is hk.config.UpscaleMode.FSR1
    assert s.upscale.ratio == 1.5 and s.upscale.sharpness == 0.0
    assert s.clear_color == (0.0, 0.0, 0.0, 1.0)
    assert s.emissive_validate_interval == 5       # not overridden
    assert fr.renderer.bloom_settings.intensity == 0.1
    assert fr.renderer.bloom_settings.threshold == 1.0
    assert fr.renderer.fxaa
    # parity x validation every 4th and 5th frame: the keys of 20 frames
    assert fr.warmup_frames() == max(
        {fr.renderer.frame_key(n): n for n in reversed(range(20))}.values()
    ) + 1
    img = fr.frame(0)
    assert np.array_equal(fr._host[0].numpy(), img.numpy())   # read back


def test_an_unknown_setting_is_refused():
    from portbench.harness.frames import settings_of
    from portbench.reference import hk

    with pytest.raises(KeyError):
        settings_of(hk, {"settings": {"no_such_field": 1}})
    with pytest.raises(KeyError):
        settings_of(hk, {"settings": {"upscale": {"no_such_field": 1}}})
