"""The port's sharded reference-default frame (hikari_tpu_torch.parallel.
shard_frame over 4 gloo ranks) against hikari_tpu's shard_frame over
make_mesh(4) on the CPU, as tests/test_parallel.py runs it (hikari_tpu's
CPU tracer: the non-fused prepass and the modular lighting path, which
the port takes with its tracer's kind changed), over 3 frames.

The output is 48x256 (lighting at 24x128): hikari_tpu's banded warps are
exact only on whole 128-wide groups (tests/test_torch_frame_post.py); at
test_parallel.py's 32x64 its TAA history leaves the band from frame 2 on,
in the single-device frame too."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import hikari_tpu as hj
import hikari_tpu.ops.reproj_gather as reproj_ref
from hikari_tpu.config import make_frame_uniform
from hikari_tpu.frame import (_post_size, build_render_frame, init_carry,
                              scaled_size, spatial_fused_active)
from hikari_tpu.ops import reservoir as ref_rsv
from hikari_tpu.ops.noise import noise_constant
from hikari_tpu.ops.trace import make_tracer
from hikari_tpu.parallel.mesh import make_mesh, pixel_sharding, shard_frame
from hikari_tpu_torch.ops import reservoir as port_rsv
from tests import torch_dist
from tests.test_torch_frame import assert_frames_close, exact_gather
from tests.torch_threads import one_torch_thread  # noqa: F401

RANKS = 4
SIZE = (48, 256)
FRAMES = 3
RESERVOIRS = ("direct_temporal", "emissive_temporal", "indirect_temporal",
              "spatial_indirect")


def reference_frames(monkeypatch):
    """hikari_tpu's reference-default frames of the minimal scene through
    its shard_frame over 4 of the CPU devices, with the exact gather (see
    tests/test_torch_frame.py:exact_gather). Returns [(image, carry)] as
    numpy."""
    from examples.minimal import build_scene

    monkeypatch.setattr(reproj_ref, "reproj_gather", exact_gather)
    settings = dataclasses.replace(
        hj.HikariSettings(), temporal_reuse=True, emissive_spatial_reuse=True,
        indirect_spatial_reuse=True, denoise=True, taa=hj.Taa.JASMINE,
        upscale=hj.Upscale.smaa_tu4x(2.0), checkerboard_lighting=False)
    h, w = SIZE
    gpu = build_scene().compile()
    cam = hj.Camera.from_look_at(torch_dist.SCENE_EYE,
                                 torch_dist.SCENE_TARGET, width=w, height=h)
    tracer = make_tracer(gpu.num_triangles)
    fn = build_render_frame(settings, SIZE, tracer, no_texture=True,
                            num_emissives=gpu.num_emissives,
                            has_sun=gpu.has_sun)
    scene = gpu.as_pytree()
    view = {k: jnp.asarray(v) for k, v in cam.view_uniform().items()}
    carry = init_carry(SIZE, settings, spatial_planes=spatial_fused_active(
        scene, settings, tracer, True, gpu.num_emissives, gpu.has_sun, SIZE))
    # the first frame's previous view is the current one, as the port's
    carry["prev_view_proj"] = view["view_proj"]
    carry["prev_inverse_view_proj"] = view["inverse_view_proj"]
    mesh = make_mesh(RANKS)
    render = scaled_size(SIZE, settings.upscale_ratio)
    rows = {h, render[0], _post_size(settings, render)[0]}
    jfn, (scene, view, _, noise, carry) = shard_frame(
        fn, mesh, scene, view, make_frame_uniform(settings, 1),
        noise_constant(), carry, rows)
    shardings = pixel_sharding(mesh, carry, rows)
    out = []
    for i in range(1, FRAMES + 1):
        carry = jax.tree.map(jax.device_put, carry, shardings)
        image, _, carry = jfn(scene, view, make_frame_uniform(settings, i),
                              noise, carry)
        out.append((np.asarray(image), jax.tree.map(np.asarray, carry)))
    return out


def _fields(planes, ref):
    """The unpacked fields of a reservoir carry as float32 numpy: the
    port's [h,16,w] planes, or hikari_tpu's planes or [h,w,16] rows."""
    if ref:
        a = jnp.asarray(planes)
        f = (ref_rsv.unpack_reservoir_planes(a) if a.shape[1] == 16
             else ref_rsv.unpack_reservoir(a))
    else:
        f = port_rsv.unpack_reservoir_planes(planes)
    return {k: np.asarray(v, np.float32) for k, v in f.items()}


@pytest.mark.skipif(len(jax.devices()) < RANKS, reason="needs 4 devices")
def test_sharded_reference_default_matches_reference(monkeypatch, tmp_path):
    """Every frame within the frame bar (SSIM >= 0.98, mean abs diff <
    1e-3) of hikari_tpu's sharded frame, and every unpacked field of the
    reservoir carries within 1e-3, but the sample position: a bounce hit
    the packed reservoir rounds to bfloat16, where a last-bit difference
    of the port's bounce ray (ROADMAP section 3: XLA's CPU code fuses the
    reference's multiply-adds) moves a word by one bfloat16 step, up to
    0.043 on ~7% of the pixels; it is held within rtol 1e-2 (one step is
    0.4-0.8%) and atol 1e-3 at every pixel."""
    started = torch_dist.start_ranks(
        "frames", RANKS, tmp_path, [("default", SIZE, FRAMES, True)])
    ref = reference_frames(monkeypatch)
    got = torch_dist.join_ranks(started)[0][("default", SIZE, True)]
    for i, ((want_image, want_carry), (image, _, carry)) in enumerate(
            zip(ref, got)):
        assert_frames_close(image.numpy(), want_image, size=SIZE)
        for k in RESERVOIRS:
            fg, fr = _fields(carry[k], False), _fields(want_carry[k], True)
            for f in fr:
                a, b = fg[f], fr[f]
                assert a.shape == b.shape, (i, k, f)
                if f == "sample_position":
                    ok = np.isclose(a, b, rtol=1e-2, atol=1e-3)
                    assert ok.all(), (i, k, f, 1.0 - ok.mean())
                else:
                    d = np.abs(a - b).max()
                    assert d <= 1e-3, f"frame {i + 1} {k}.{f} ({d})"
