"""Kernel B's plain version (hikari_tpu_torch.ops.light_fused) against
hikari_tpu's fused Pallas lighting (temporal=False) in interpret mode, fed
the identical G-buffer and blue noise."""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from examples.minimal import build_scene as minimal_scene
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
from tests.cornell_box import EYE, TARGET, build_cornell_box
from tests.test_light_fused import _assert_close
from tests.test_trace import emissive_scene
from tests.torch_threads import one_torch_thread  # noqa: F401

SIZE = (48, 64)

CASES = {
    # scene, eye, target, frame number
    "sun_only": (minimal_scene, (-2.0, 2.5, 5.0), (0, 0, 0), 7),
    "emissive_no_sun": (lambda: build_cornell_box("hikari_tpu"), EYE,
                        TARGET, 3),
    "emissive_and_sun": (emissive_scene, (3.0, 2.5, 3.0), (0, 0.5, 0), 3),
}


@pytest.mark.parametrize("bounces", [1, 2])
@pytest.mark.parametrize("case", sorted(CASES))
def test_lighting_matches_pallas(case, bounces):
    build, eye, target, number = CASES[case]
    gpu = build().compile()
    scene = {k: jnp.asarray(v) for k, v in gpu.arrays.items()}
    cam = Camera.from_look_at(eye, target, width=SIZE[1], height=SIZE[0])
    view_np = cam.view_uniform()
    view = {k: jnp.asarray(v) for k, v in view_np.items()}
    settings = dataclasses.replace(
        HikariSettings(), temporal_reuse=False, emissive_spatial_reuse=False,
        indirect_spatial_reuse=False, indirect_bounces=bounces)
    frame = make_frame_uniform(settings, number)
    g = prepass(scene, make_tracer(gpu.num_triangles), view, view,
                frame["number"], SIZE, Taa.NONE, UpscaleMode.NONE)
    rand = sample_blue_noise(noise_constant(), frame["number"], SIZE)
    kw = dict(has_sun=gpu.has_sun, num_emissives=gpu.num_emissives,
              bounces=bounces, render_size=SIZE)
    ref = lighting_ref(scene, g, view, frame, rand, interpret=True, **kw)

    got = fused_lighting(
        scene_from_arrays(gpu.arrays, "cpu"),
        {k: torch.from_numpy(np.array(v)) for k, v in g.items()},
        view_to_device(view_np, "cpu"), frame_uniform_from_jax(frame),
        torch.from_numpy(np.array(rand)), **kw)
    assert set(got) == set(ref)
    for k in ref:
        _assert_close(k, got[k].numpy(), ref[k])
