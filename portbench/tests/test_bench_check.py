"""The check that decides `correct`, driven through a whole run of a cell
at a small size on the CPU (the harness's look for a card skipped): a
sound run is correct, and each fault a cell of this benchmark can have,
planted in the timed path, and the control (the reference in bfloat16)
come out as not correct under the configurations' limits."""

import time
import types

import numpy as np
import pytest
import torch

from portbench.harness import cell as cell_mod
from portbench.harness.spec import load_cell
from portbench.harness.traffic import Traffic
from portbench.reference import compare

SMALL = dict(width=64, height=32)
SEED = 2 ** 31 + 77


def _cell(name="minimal-orbit"):
    cell = load_cell(name)
    cell.config = dict(cell.config, **SMALL)
    return cell


def _api(renderer_cls):
    import hikari_tpu_torch as ht

    api = types.SimpleNamespace(**{k: getattr(ht, k) for k in ht.__all__})
    api.Renderer = renderer_cls
    return api


def _run(cell, api=None, seconds=25.0):
    return cell_mod.run(cell, SEED, seconds, False, time.perf_counter(),
                        device="cpu", api=api)


@pytest.fixture(scope="module")
def port():
    import hikari_tpu_torch as ht

    return ht


CELLS = ["minimal-orbit", "city-orbit"]


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(name):
    out = _run(_cell(name))
    assert out["correct"], out["compared"]
    assert out["differences"]["mean_abs_diff"] == 0.0


@pytest.mark.parametrize("name", CELLS)
def test_a_frame_that_leaves_its_carry_unchanged_is_not_correct(port, name):
    class Stale(port.Renderer):
        def _frame_program(self, view, frame, commit):
            return super()._frame_program(view, frame, False)

    assert not _run(_cell(name), _api(Stale))["correct"]


@pytest.mark.parametrize("name", CELLS)
def test_half_the_image_left_out_is_not_correct(port, name):
    class Half(port.Renderer):
        def render_frame(self):
            img = super().render_frame()
            h = img.shape[0] // 2
            img[h:] = img[:h].mean(dim=(0, 1))
            return img

    assert not _run(_cell(name), _api(Half))["correct"]


@pytest.mark.parametrize("name", CELLS)
def test_an_image_altered_where_it_is_produced_is_not_correct(port, name):
    class Altered(port.Renderer):
        def render_frame(self):
            img = super().render_frame()
            img[: max(1, img.shape[0] // 10)] = 0.0
            return img

    assert not _run(_cell(name), _api(Altered))["correct"]


@pytest.mark.parametrize("name", CELLS)
def test_a_wrong_column_is_not_correct(port, name):
    class Column(port.Renderer):
        def render_frame(self):
            img = super().render_frame()
            img[:, img.shape[1] // 2, :3] += 0.05
            return img

    out = _run(_cell(name), _api(Column))
    assert not out["correct"]
    assert out["compared"]["p999_abs_diff"]["value"] > 0.04


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(name):
    cell = _cell(name)
    desc = cell.scene.build()
    frames = Traffic(cell.traffic, SEED, desc).compared(
        16 if name == "city-orbit" else 4)[:1]
    ref = compare.reference_images(cell.config, desc,
                                   Traffic(cell.traffic, SEED, desc),
                                   frames, "cpu")
    low = compare.reference_images(cell.config, desc,
                                   Traffic(cell.traffic, SEED, desc),
                                   frames, "cpu", control=True)
    correct, compared, _, _ = compare.judge(low, ref,
                                            cell.config["limits"])
    assert not correct, compared
    p999 = compared["p999_abs_diff"]
    assert p999["value"] > p999["limit"], compared


def test_the_control_rounds_the_image_passes_and_restores_them():
    from portbench.reference.hk import frame
    from portbench.reference.hk.ops import post

    before = (frame.denoise_channels, frame.tone_mapping, post.smaa_tu4x,
              post.taa_jasmine)
    with compare.bf16_image_planes():
        assert frame.tone_mapping is not before[1]
    assert (frame.denoise_channels, frame.tone_mapping, post.smaa_tu4x,
            post.taa_jasmine) == before
    x = {"a": torch.tensor([1.0 + 2.0 ** -12]), "b": torch.tensor([3])}
    y = compare._round(x)
    assert y["a"].item() == 1.0 and y["b"].dtype == torch.int64


@pytest.mark.chip
def test_the_control_fails_at_the_cells_own_size(cuda):
    from portbench.control import control_numbers

    for name in ("minimal-orbit", "city-orbit"):
        out = control_numbers(load_cell(name), SEED, "cuda")
        assert not out["correct"], out["numbers"]


@pytest.mark.chip
def test_a_run_on_the_card_is_correct(cuda):
    import json
    import os
    import subprocess
    import sys

    from portbench.harness.spec import ROOT

    for name in ("minimal-orbit", "city-orbit"):
        proc = subprocess.run(
            [sys.executable, os.path.join(ROOT, "portbench", "run.py"),
             "--workload", name, "--seed", str(SEED), "--seconds", "5",
             "--trace", "0"], capture_output=True, text=True, cwd=ROOT)
        assert proc.returncode == 0, proc.stderr[-2000:]
        assert json.loads(proc.stdout.strip().splitlines()[-1])["correct"]


def test_differences_count_nonfinite_values():
    a = np.zeros((4, 4, 4), np.float32)
    b = a.copy()
    b[0, 0, 0] = np.nan
    d = compare.differences(b, a)
    assert d["nonfinite_share"] > 0 and d["p999_abs_diff"] > 1.0


@pytest.mark.parametrize("name", CELLS)
def test_a_wrong_1080p_row_fails_the_9999th_percentile(name):
    """One row of 1920 pixels off by 0.05 is 0.09% of a 1080p image: under
    the 99.9th percentile, over the 99.99th."""
    limits = load_cell(name).config["limits"]
    ref = np.zeros((1080, 1920, 4), np.float32)
    got = ref.copy()
    got[540, :, :3] = 0.05
    correct, compared, _, _ = compare.judge({0: got}, {0: ref}, limits)
    assert not correct
    assert compared["p999_abs_diff"]["value"] == 0.0
    assert compared["p9999_abs_diff"]["value"] > limits["p9999_abs_diff"]
