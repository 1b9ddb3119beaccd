"""Kernel 4's plain version (hikari_tpu_torch.ops.light_fused with
temporal=True) against hikari_tpu's fused Pallas lighting with temporal
reuse, in interpret mode, fed the identical G-buffer, blue noise and
previous reservoirs.

The previous reservoirs are hikari_tpu's own carry: its temporal lighting
runs frames 1-4 from an empty carry on a static camera (the reprojection
gather is then the identity), and the port and hikari_tpu then each light
frame 5 (emissive validation), 6 (direct validation) and 7 (no validation)
from the same carry. hikari_tpu runs with the tracking outputs on; the port
runs with them on and off (they only add outputs).

The box and the sun-only scene are here; the scene with both a sun and an
emitter is in test_torch_light_temporal_mixed.py (each scene compiles its
own reference kernel, ~40 s on one CPU process)."""

from __future__ import annotations

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hikari_tpu import Camera, HikariSettings
from hikari_tpu.config import Taa, UpscaleMode, make_frame_uniform
from hikari_tpu.ops.light_fused import fused_lighting as lighting_ref
from hikari_tpu.ops.noise import noise_constant, sample_blue_noise
from hikari_tpu.ops.prepass import prepass
from hikari_tpu.ops.trace import make_tracer
from hikari_tpu_torch import scene_from_arrays
from hikari_tpu_torch.camera import view_to_device
from hikari_tpu_torch.config import frame_uniform_from_jax
from hikari_tpu_torch.ops.light_fused import fused_lighting
from hikari_tpu_torch.ops.reservoir import unpack_fields
from tests.test_light_fused import _assert_close
from tests.test_torch_light import CASES, SIZE
from tests.torch_threads import one_torch_thread  # noqa: F401

TEST_FRAMES = (5, 6, 7)


def _torch(x):
    return torch.from_numpy(np.array(x))


@functools.lru_cache(maxsize=None)
def _run_reference(case):
    """hikari_tpu's temporal lighting over frames 1..7 of `case`. Returns
    (compiled scene, view, lighting flags, {frame number: (frame uniform,
    G-buffer, noise, previous reservoirs, outputs)})."""
    build, eye, target, _ = CASES[case]
    gpu = build().compile()
    scene = {k: jnp.asarray(v) for k, v in gpu.arrays.items()}
    cam = Camera.from_look_at(eye, target, width=SIZE[1], height=SIZE[0])
    view_np = cam.view_uniform()
    view = {k: jnp.asarray(v) for k, v in view_np.items()}
    settings = dataclasses.replace(
        HikariSettings(), temporal_reuse=True, emissive_spatial_reuse=False,
        indirect_spatial_reuse=False, indirect_bounces=1)
    kw = dict(has_sun=gpu.has_sun, num_emissives=gpu.num_emissives,
              bounces=1, render_size=SIZE)
    n_chan = int(gpu.has_sun) + int(gpu.num_emissives > 0) + 1
    prev = [jnp.zeros((SIZE[0], 16, SIZE[1]), jnp.float32)] * n_chan
    tracer = make_tracer(gpu.num_triangles)
    frames = {}
    for number in range(1, TEST_FRAMES[-1] + 1):
        frame = make_frame_uniform(settings, number)
        g = prepass(scene, tracer, view, view, frame["number"], SIZE,
                    Taa.NONE, UpscaleMode.NONE)
        rand = sample_blue_noise(noise_constant(), frame["number"], SIZE)
        out = lighting_ref(scene, g, view, frame, rand, interpret=True,
                           temporal=True, prev_planes=prev, track_de=True,
                           track_ind=True, **kw)
        frames[number] = (frame, g, rand, prev,
                          {k: np.asarray(v) for k, v in out.items()})
        prev = [out[f"{c}_packed"] for c, on in
                (("d", gpu.has_sun), ("e", gpu.num_emissives > 0),
                 ("i", True)) if on]
    return gpu, view_np, kw, frames


def _assert_planes_close(name, got, ref):
    """Each unpacked reservoir field within rtol 1e-2 / atol 1e-3 (one
    bf16 step is 0.4-0.8%) on >= 99% of pixels."""
    fg = unpack_fields(torch.from_numpy(got))
    fr = unpack_fields(_torch(ref))
    for k in fr:
        a, b = fg[k].numpy(), fr[k].numpy()
        ok = np.isclose(a, b, rtol=1e-2, atol=1e-3)
        assert ok.mean() >= 0.99, (name, k, ok.mean())


def check_case(case, number, track):
    """The port's frame `number` of `case` against hikari_tpu's."""
    gpu, view_np, kw, frames = _run_reference(case)
    frame, g, rand, prev, ref = frames[number]
    got = fused_lighting(
        scene_from_arrays(gpu.arrays, "cpu"),
        {k: _torch(v) for k, v in g.items()},
        view_to_device(view_np, "cpu"), frame_uniform_from_jax(frame),
        _torch(rand), temporal=True, prev_planes=[_torch(p) for p in prev],
        track_de=track, track_ind=track, **kw)
    want = {k for k in ref
            if track or not k.endswith(("_flags", "_scatter"))}
    assert set(got) == want
    for k in sorted(want):
        g_ = got[k].numpy()
        if k.endswith(("_packed", "_scatter")):
            _assert_planes_close(k, g_, ref[k])
        elif k.endswith("_flags"):
            assert (g_ == ref[k]).mean() >= 0.99, k
        else:
            _assert_close(k, g_, ref[k])


@pytest.mark.parametrize("track", [False, True])
@pytest.mark.parametrize("number", TEST_FRAMES)
@pytest.mark.parametrize("case", ["emissive_no_sun", "sun_only"])
def test_temporal_lighting_matches_pallas(case, number, track):
    check_case(case, number, track)
