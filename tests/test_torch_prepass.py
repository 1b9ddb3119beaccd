"""Kernel A's plain version (hikari_tpu_torch.ops.prepass_fused) against
hikari_tpu's fused Pallas prepass in interpret mode, on the same compiled
scene and views."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hikari_tpu import Camera
from hikari_tpu.config import Taa, UpscaleMode
from hikari_tpu.ops.prepass import frame_jitter
from hikari_tpu.ops.prepass_fused import prepass_fused as prepass_ref
from hikari_tpu_torch import Taa as PortTaa
from hikari_tpu_torch import UpscaleMode as PortUpscaleMode
from hikari_tpu_torch import scene_from_arrays
from hikari_tpu_torch.camera import view_to_device
from hikari_tpu_torch.ops import prepass as port_prepass
from hikari_tpu_torch.ops.prepass_fused import prepass_fused
from tests.cornell_box import EYE, TARGET, build_cornell_box
from tests.test_trace import emissive_scene
from tests.torch_threads import one_torch_thread  # noqa: F401

SIZE = (48, 64)

CASES = {
    # scene, eye, target; the previous view is offset to exercise velocity
    "emissive": (emissive_scene, (3.0, 2.5, 3.0), (0, 0.5, 0)),
    "cornell_box": (lambda: build_cornell_box("hikari_tpu"), EYE, TARGET),
}


def assert_gbuffer_close(got, ref):
    """ids equal on >= 99.5% of pixels; float planes within
    1e-4 * max(|ref|, 1) on >= 99% of values (isolated knife-edge hits may
    pick another triangle)."""
    for k in ref:
        a = got[k].numpy()
        b = np.asarray(ref[k])
        assert a.shape == b.shape, k
        if k == "instance_material":
            frac = (a == b).all(-1).mean()
            assert frac >= 0.995, (k, frac)
            continue
        ok = np.abs(a - b) <= 1e-4 * np.maximum(np.abs(b), 1.0)
        assert ok.mean() >= 0.99, (k, ok.mean(), np.abs(a - b).max())


@pytest.mark.parametrize("frame_number", [0, 5])
@pytest.mark.parametrize("case", sorted(CASES))
def test_prepass_matches_pallas(case, frame_number):
    build, eye, target = CASES[case]
    gpu = build().compile()
    scene_j = {k: jnp.asarray(v) for k, v in gpu.arrays.items()}
    cam = Camera.from_look_at(eye, target, width=SIZE[1], height=SIZE[0])
    cam2 = Camera.from_look_at(np.add(eye, (0.1, 0.1, -0.1)), target,
                               width=SIZE[1], height=SIZE[0])
    view_np, prev_np = cam.view_uniform(), cam2.view_uniform()
    jit = frame_jitter(jnp.uint32(frame_number), Taa.JASMINE,
                       UpscaleMode.NONE)
    ref, ref_albedo = prepass_ref(
        scene_j, {k: jnp.asarray(v) for k, v in view_np.items()},
        {k: jnp.asarray(v) for k, v in prev_np.items()}, jit, SIZE,
        interpret=True)

    jit_port = port_prepass.frame_jitter(frame_number, PortTaa.JASMINE,
                                         PortUpscaleMode.NONE)
    np.testing.assert_array_equal(np.asarray(jit_port, np.float32),
                                  np.asarray(jit))
    got, got_albedo = prepass_fused(
        scene_from_arrays(gpu.arrays, "cpu"), view_to_device(view_np, "cpu"),
        view_to_device(prev_np, "cpu"), jit_port, SIZE)
    assert_gbuffer_close(got, ref)
    da = np.abs(got_albedo.numpy() - np.asarray(ref_albedo))
    assert (da <= 1e-4).mean() >= 0.99, da.max()


def test_camera_rays_are_unit_and_centered():
    """camera_rays (the plain version's ray generator): unit directions,
    and the centre pixel of an odd-sized frame looks at the target."""
    size = (5, 7)
    cam = Camera.from_look_at((0.0, 1.0, 3.0), (0.0, 1.0, 0.0),
                              width=size[1], height=size[0])
    view = view_to_device(cam.view_uniform(), "cpu")
    o, d = port_prepass.camera_rays(view, size, (0.0, 0.0))
    assert o.shape == d.shape == (5, 7, 3)
    torch.testing.assert_close(d.norm(dim=-1), torch.ones(size))
    torch.testing.assert_close(d[2, 3], torch.tensor([0.0, 0.0, -1.0]),
                               atol=1e-6, rtol=0)


def test_prepass_words_with_xlas_rsqrt():
    """Kernel A's plain version word for word against hikari_tpu's kernel A
    (jitted, interpret mode) on the box's first panned frame of
    tests/torch_pan_witness.py (48x166, a jittered ray grid), with the
    port's torch.rsqrt replaced by XLA's (lax.rsqrt on the same values):
    the ids and the normals (the winner's interpolated row and _rsqrt_n)
    equal in every word. The other planes still part where XLA's CPU
    compiler contracts the kernel's multiply-adds into FMAs (PERF.md
    section 7)."""
    from tests import torch_pan_witness as witness

    words = witness.gbuffer_words("fsr1_1.3", 48, refs=("jit",),
                                  ports=("xla_rsqrt",))
    shares = words[("xla_rsqrt", "jit")]
    assert shares["instance_material"] == 0.0, shares
    assert shares["normal"] == 0.0, shares
