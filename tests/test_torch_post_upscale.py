"""The post chain at upscale ratios other than SMAA's 2: FSR 1.0 (EASU +
RCAS after TAA at the render size) and SMAA TU4X at ratios 1 and 1.5
(reading the G-buffer through its direct parity context), each with TAA
on and off, against hikari_tpu's post_chain (its Pallas warps in
interpret mode) on the box's G-buffers, with the camera moving.

The sizes keep hikari_tpu's warps in band: TAA's and SMAA's fetches on
whole 128-wide groups (kernel 11's contract). Tolerance:
tests/test_torch_post.py's, <= 1e-4 abs on >= 99.9% of values.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import hikari_tpu as hj
import hikari_tpu_torch as ht
from hikari_tpu.ops import post as post_ref
from hikari_tpu_torch.camera import view_to_device
from hikari_tpu_torch.frame import post_carry_shapes, scaled_size
from hikari_tpu_torch.ops import post, smaa
from hikari_tpu_torch.ops import prepass_fused as pf
from hikari_tpu_torch.ops.prepass import frame_jitter
from tests.cornell_box import EYE, TARGET, build_cornell_box
from tests.test_torch_post import _assert_close, _frames, _np, _tone
from tests.torch_threads import one_torch_thread  # noqa: F401


def _views(full, i):
    # the camera moves sideways about half a pixel per frame at the box
    step = 0.5 * 2.0 * 3.2 * np.tan(np.pi / 8.0) / full[0]
    d = (step * i, 0.0, 0.0)
    cam = ht.Camera.from_look_at(tuple(np.add(EYE, d)),
                                 tuple(np.add(TARGET, d)),
                                 width=full[1], height=full[0])
    return view_to_device(cam.view_uniform(), "cpu")


_SCENE = {}


def _gbuffers(full, mode):
    """The port's full-size G-buffers of frames 1 and 2 of the box (kernel
    A's plain version, no decimated call), jittered for TAA and `mode`."""
    if "scene" not in _SCENE:
        _SCENE["scene"] = (build_cornell_box("hikari_tpu_torch").compile()
                           .as_pytree("cpu"))
    out = []
    for i in (1, 2):
        jit = frame_jitter(i, ht.Taa.JASMINE, mode)
        gbuf, _ = pf.prepass_fused(_SCENE["scene"], _views(full, i),
                                   _views(full, i - 1), jit, full)
        out.append(gbuf)
    return out


# (upscale, ratio, output size): every warp on whole 128-wide groups
# (FSR at ratio 2 is path F's, held whole in tests/test_torch_frame_scene.py)
POST_CASES = [
    ("fsr1", 1.5, (48, 192)),          # TAA at 32x128
    ("smaa_tu4x", 1.0, (32, 128)),     # SMAA and TAA at 64x256
    ("smaa_tu4x", 1.5, (48, 192)),     # SMAA and TAA at 64x256
]


@pytest.mark.parametrize("taa", ["NONE", "JASMINE"])
@pytest.mark.parametrize("upscale,ratio,full", POST_CASES,
                         ids=[f"{u}_{r}" for u, r, _ in POST_CASES])
def test_post_chain_matches_reference(upscale, ratio, full, taa):
    """The image and the history the next frame reads (prev_tone with
    SMAA, prev_taa with TAA, at the shapes the frame's carry holds)."""
    settings = {pkg: dataclasses.replace(
        pkg.HikariSettings(), taa=getattr(pkg.Taa, taa),
        upscale=getattr(pkg.Upscale, upscale)(ratio)) for pkg in (ht, hj)}
    if upscale == "fsr1":
        settings = {pkg: dataclasses.replace(
            s, upscale=dataclasses.replace(s.upscale, sharpness=0.2))
            for pkg, s in settings.items()}
    render = scaled_size(full, ratio)
    prev, gbuf = _gbuffers(full, settings[ht].upscale.mode)
    rng = np.random.default_rng(int(ratio * 10) + (taa == "JASMINE"))
    shapes = post_carry_shapes(full, settings[ht])
    carry = {"prev_gbuffer": {k: prev[k] for k in
                              shapes.get("prev_gbuffer", {})}}
    for k in ("prev_tone", "prev_taa"):
        if k in shapes:
            carry[k] = _tone(rng, shapes[k][:2])
    tone = _tone(rng, render)
    fp, fr = _frames(2, settings[ht].upscale_ratio)
    ctx = (smaa.parity_context(gbuf, render) if upscale == "smaa_tu4x"
           else None)
    image, pc = post.post_chain(gbuf, carry, tone, fp, settings[ht], full,
                                render, ctx)
    ref_carry = {"prev_gbuffer": carry["prev_gbuffer"],
                 "prev_tone": carry.get("prev_tone"),
                 "prev_taa": carry.get("prev_taa"),
                 "prev_upscale": torch.zeros(full + (4,))}
    ref_image, ref_pc = post_ref.post_chain(
        _np(gbuf), _np(ref_carry), _np(tone), fr, settings[hj], full,
        render)
    _assert_close("image", image, ref_image)
    assert set(pc) == set(shapes) - {"prev_gbuffer"}
    for k, v in pc.items():
        assert tuple(v.shape) == shapes[k]
        _assert_close(k, v, ref_pc[k])
