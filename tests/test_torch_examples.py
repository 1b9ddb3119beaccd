"""The port's examples (hikari_tpu_torch/examples) against hikari_tpu's
(examples/): parse_args + apply_overrides give the same settings for the
same command lines; the minimal and cornell scenes (cornell read from a
GLB of the procedural box under tmp_path, through both glTF loaders)
compile to the same arrays word for word; and each port `main` (minimal,
cornell, simple, scene, city) renders 2 frames at 64x48 with --device cpu
and writes its PNG. Without --device they render on CUDA, and without a
CUDA device they raise (no fallback to the CPU)."""

from __future__ import annotations

import dataclasses
import enum
import sys

import numpy as np
import pytest
import torch

import hikari_tpu as hj
from examples import common as common_ref
from examples import cornell as cornell_ref
from examples import minimal as minimal_ref
from hikari_tpu_torch.examples import (city, common, cornell, minimal, scene,
                                       simple)
from tests import torch_glb
from tests.test_torch_city_scene import NOT_PORTED, _bits_equal
from tests.torch_threads import one_torch_thread  # noqa: F401

ARGVS = [
    [],
    ["--width", "320", "--height", "200", "--frames", "3"],
    ["--no-denoise", "--taa", "none", "--upscale", "none"],
    ["--denoise", "--taa", "jasmine", "--upscale", "smaa1", "--bounces",
     "3"],
    ["--upscale", "fsr", "--no-temporal-reuse"],
    ["--upscale", "smaa2", "--temporal-reuse", "--out", "x.png",
     "--dump-passes", "d"],
]


def _plain(settings):
    """A settings dataclass as nested tuples of plain values."""
    out = []
    for f in dataclasses.fields(settings):
        v = getattr(settings, f.name)
        if dataclasses.is_dataclass(v):
            v = _plain(v)
        elif isinstance(v, enum.Enum):
            v = v.value
        out.append((f.name, v))
    return tuple(out)


@pytest.mark.parametrize("argv", ARGVS, ids=range(len(ARGVS)))
def test_options_give_reference_settings(monkeypatch, argv):
    monkeypatch.setattr(sys, "argv", ["example"] + argv)
    ref_args = common_ref.parse_args("x")
    args = common.parse_args("x", argv=argv)
    assert {k: v for k, v in vars(args).items() if k != "device"} \
        == vars(ref_args)
    assert args.device is None
    for base in (lambda pkg: pkg.HikariSettings(),
                 lambda pkg: dataclasses.replace(
                     pkg.HikariSettings(), indirect_bounces=4,
                     upscale=pkg.Upscale.fsr1(2.0))):
        import hikari_tpu_torch as ht

        got = common.apply_overrides(base(ht), args)
        ref = common_ref.apply_overrides(base(hj), ref_args)
        assert _plain(got) == _plain(ref)


def _assert_compiled_equal(got, ref):
    assert set(ref.arrays) - set(got.arrays) <= NOT_PORTED
    for k, v in got.arrays.items():
        assert _bits_equal(v, ref.arrays[k]), k
    for k in ("num_triangles", "num_nodes", "num_instances",
              "num_emissives", "num_textures"):
        assert getattr(got, k) == getattr(ref, k), k


def test_minimal_scene_matches_reference():
    got = minimal.build_scene().compile()
    _assert_compiled_equal(got, minimal_ref.build_scene().compile())
    assert got.num_triangles == 14 and got.has_sun
    assert got.num_emissives == 0


@pytest.fixture
def assets(tmp_path, monkeypatch):
    """HIKARI_ASSETS with models/cornell.glb: the procedural box as a GLB;
    hikari_tpu's example reads the same file."""
    path = torch_glb.write_cornell_glb(
        str(tmp_path / "assets" / "models" / "cornell.glb"))
    monkeypatch.setenv("HIKARI_ASSETS", str(tmp_path / "assets"))
    monkeypatch.setattr(cornell_ref, "ASSET", path)
    return path


def test_cornell_scene_matches_reference(assets):
    assert cornell.asset_path() == assets
    got = cornell.build_scene().compile()
    _assert_compiled_equal(got, cornell_ref.build_scene().compile())
    assert got.num_triangles == 36 and not got.has_sun
    assert cornell.settings().clear_color == (0.0, 0.0, 0.0, 1.0)


def test_cornell_without_its_asset_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("HIKARI_ASSETS", str(tmp_path))
    with pytest.raises(FileNotFoundError):
        cornell.build_scene()


MAINS = {"minimal": minimal, "cornell": cornell, "simple": simple,
         "scene": scene, "city": city}


@pytest.mark.parametrize("name", list(MAINS))
def test_main_renders_on_the_cpu(assets, tmp_path, name):
    from PIL import Image

    out = str(tmp_path / f"{name}.png")
    r, img = MAINS[name].main(["--width", "64", "--height", "48",
                               "--frames", "2", "--device", "cpu",
                               "--out", out])
    assert r.device == torch.device("cpu") and r._frame_index == 2
    assert tuple(img.shape) == (48, 64, 4)
    assert torch.isfinite(img).all() and float(img[..., :3].mean()) > 0.0
    png = np.asarray(Image.open(out))
    assert png.shape == (48, 64, 3)


def test_main_dumps_passes(assets, tmp_path):
    out = str(tmp_path / "passes")
    minimal.main(["--width", "64", "--height", "48", "--frames", "1",
                  "--device", "cpu", "--out", str(tmp_path / "m.png"),
                  "--dump-passes", out])
    import os

    assert "final.png" in os.listdir(out) and len(os.listdir(out)) == 16


@pytest.mark.skipif(torch.cuda.is_available(), reason="a CUDA device is "
                    "present: the default device renders")
def test_main_needs_cuda_by_default(tmp_path):
    with pytest.raises(RuntimeError, match="CUDA"):
        minimal.main(["--width", "16", "--height", "16", "--frames", "1",
                      "--out", str(tmp_path / "m.png")])
