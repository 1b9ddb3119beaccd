"""utils/image.py and utils/profiling.py of the port against hikari_tpu's:
srgb_encode, ssim and psnr within 1e-6 (the same numpy expressions: in
practice equal), a save_png / load_png round trip (8-bit PNG: within half
a step of 1/255 of the sRGB values), pass_scope's names in a CPU
torch.profiler trace (and device_trace's Chrome trace), time_fn and
FrameTimer."""

from __future__ import annotations

import json
import os
import time

import numpy as np
import pytest
import torch

from hikari_tpu.utils import image as image_ref
from hikari_tpu_torch.utils import image, profiling
from tests.torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-6


def _images(seed, shape=(32, 48, 3)):
    g = np.random.default_rng(seed)
    a = g.uniform(-0.2, 1.3, shape).astype(np.float32)
    b = np.clip(a + g.normal(0.0, 0.05, shape), -0.1, 1.2).astype(np.float32)
    return a, b


@pytest.mark.parametrize("seed", [0, 1])
def test_srgb_encode_matches_reference(seed):
    a, _ = _images(seed)
    got, ref = image.srgb_encode(a), image_ref.srgb_encode(a)
    assert got.dtype == ref.dtype
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL)


@pytest.mark.parametrize("shape", [(32, 48, 3), (24, 40), (20, 30, 4)])
def test_ssim_and_psnr_match_reference(shape):
    a, b = _images(3, shape)
    assert abs(image.ssim(a, b) - image_ref.ssim(a, b)) <= TOL
    assert abs(image.psnr(a, b) - image_ref.psnr(a, b)) <= TOL
    assert image.ssim(a, a) == pytest.approx(1.0, abs=TOL)
    assert image.psnr(a, a) == float("inf")


def test_png_round_trip(tmp_path):
    a, _ = _images(5, (16, 24, 4))
    path = str(tmp_path / "img.png")
    image.save_png(path, a)
    back = image.load_png(path)
    assert back.shape == (16, 24, 3) and back.dtype == np.float32
    np.testing.assert_allclose(back, image.srgb_encode(a[..., :3]),
                               rtol=0, atol=0.5 / 255 + TOL)
    # the reference reads the same file the same way
    np.testing.assert_array_equal(back, image_ref.load_png(path))
    raw = str(tmp_path / "raw.png")
    image.save_png(raw, a, encode_srgb=False)
    np.testing.assert_allclose(image.load_png(raw),
                               np.clip(a[..., :3], 0, 1),
                               rtol=0, atol=0.5 / 255 + TOL)


def test_pass_scope_names_in_profiler_trace(tmp_path):
    x = torch.randn(64, 64)
    with profiling.device_trace(str(tmp_path)) as prof:
        with profiling.pass_scope("hk_lighting"):
            y = x @ x
        with profiling.pass_scope("hk_denoise"):
            y = torch.relu(y)
    names = {e.name for e in prof.events()}
    assert {"hk_lighting", "hk_denoise"} <= names
    with open(os.path.join(tmp_path, "trace.json")) as f:
        trace = json.load(f)
    assert {"hk_lighting", "hk_denoise"} <= {
        e.get("name") for e in trace["traceEvents"]}


def test_time_fn_and_frame_timer():
    calls = []

    def fn(x):
        calls.append(1)
        return {"y": x + 1, "z": [x * 2]}

    ms = profiling.time_fn(fn, torch.ones(4), iters=3, warmup=2)
    assert len(calls) == 5 and ms >= 0.0
    timer = profiling.FrameTimer(window=2)
    assert timer.ms == 0.0
    for _ in range(4):
        timer.tick()
        time.sleep(0.002)
    assert len(timer.samples) == 2
    assert timer.ms >= 2.0
