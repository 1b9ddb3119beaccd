"""The post chain of hikari_tpu_torch (ops/taa.py, ops/smaa.py, ops/post.py)
and the ratio-2 denoiser against hikari_tpu's, with its Pallas warps in
interpret mode, on the box's G-buffers under a moving camera and seeded
tone images.

Tolerance: <= 1e-4 abs on >= 99.9% of values. The clip decisions (depth
ratio, velocity distance, the variance box) are knife edges where the two
stacks' last-bit differences (velocity, the luminance dot) can flip a
pixel; the observed share is in the assertion message.

The widths are multiples of 128 at every warp (output 256, render 128):
hikari_tpu's banded warp edge-pads the coords of a partial 128-wide
group, which drags the group's mean offset, so a partial group is out of
band and its pixels are not the filter's (tests/test_torch_warp.py).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hikari_tpu.ops import post as post_ref
from hikari_tpu.ops.denoise import denoise_channels as denoise_ref
from hikari_tpu.ops.smaa import smaa_tu4x as smaa_ref
from hikari_tpu.ops.taa import taa_jasmine as taa_ref
import hikari_tpu as hj
import hikari_tpu_torch as ht
from hikari_tpu_torch.camera import view_to_device
from hikari_tpu_torch.ops import post
from hikari_tpu_torch.ops import prepass_fused as pf
from hikari_tpu_torch.ops.denoise import denoise_channels
from hikari_tpu_torch.ops.prepass import frame_jitter
from hikari_tpu_torch.ops.smaa import smaa_tu4x
from hikari_tpu_torch.ops.taa import taa_jasmine
from tests.cornell_box import EYE, TARGET, build_cornell_box
from tests.torch_threads import one_torch_thread  # noqa: F401

FULL = (48, 256)
RENDER = (24, 128)
CLEAR = (0.4, 0.4, 0.4, 1.0)
# sideways camera motion per frame (about half a pixel at the box)
STEP = 0.5 * 2.0 * 3.2 * np.tan(np.pi / 8.0) / FULL[0]
ABS_TOL, SHARE = 1e-4, 0.999


def _views(i):
    d = (STEP * i, 0.0, 0.0)
    cam = ht.Camera.from_look_at(tuple(np.add(EYE, d)),
                                 tuple(np.add(TARGET, d)),
                                 width=FULL[1], height=FULL[0])
    return view_to_device(cam.view_uniform(), "cpu")


@pytest.fixture(scope="module")
def frames():
    """The port's G-buffers (and SMAA quads) of frames 0..2 of the box
    with the camera moving, as SMAA + TAA jitter them."""
    scene = build_cornell_box("hikari_tpu_torch").compile().as_pytree("cpu")
    out = []
    for i in range(3):
        jit = frame_jitter(i, ht.Taa.JASMINE, ht.UpscaleMode.SMAA_TU4X)
        view, prev = _views(i), _views(max(i - 1, 0))
        gbuf, albedo, g, albedo_r = pf.prepass_fused(
            scene, view, prev, jit, FULL, dec_parity=i & 1)
        quads = pf.prepass_fused_quads(gbuf)
        out.append(dict(gbuf=gbuf, albedo=albedo, g=g, albedo_r=albedo_r,
                        quads=quads))
    return out


def _zeros_like_gbuf(gbuf):
    return {k: torch.zeros_like(v) for k, v in gbuf.items()}


def _frames(number, ratio):
    port = {"number": number, "upscale_ratio": float(np.float32(ratio)),
            "clear_color": CLEAR}
    ref = {"number": jnp.uint32(number), "upscale_ratio": np.float32(ratio),
           "clear_color": jnp.asarray(CLEAR, jnp.float32)}
    return port, ref


def _np(tree):
    return jax.tree.map(lambda t: jnp.asarray(t.numpy()), tree)


def _tone(rng, size):
    rgb = rng.uniform(0.0, 1.0, size + (3,)).astype(np.float32)
    return torch.from_numpy(np.concatenate(
        [rgb, np.ones(size + (1,), np.float32)], -1))


def _assert_close(what, got, ref):
    got = got.numpy() if torch.is_tensor(got) else got
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    assert np.isfinite(got).all(), what
    share = (np.abs(got - ref) <= ABS_TOL).mean()
    assert share >= SHARE, (what, share)


@pytest.mark.parametrize("number,history", [(0, False), (2, True)],
                         ids=["frame0", "history"])
def test_taa_matches_reference(frames, number, history):
    """TAA Jasmine at the output size (ratio 1); frame 0 has no history:
    zero previous G-buffer and output, so pmax = 0."""
    rng = np.random.default_rng(number)
    gbuf = frames[number]["gbuf"]
    prev_gbuf = (frames[number - 1]["gbuf"] if history
                 else _zeros_like_gbuf(gbuf))
    prev_taa = _tone(rng, FULL) if history else torch.zeros(FULL + (4,))
    cur = _tone(rng, FULL)
    fp, fr = _frames(number, 1.0)
    got = taa_jasmine(gbuf, prev_gbuf, prev_taa, cur, fp, CLEAR, FULL)
    ref = taa_ref(_np(gbuf), _np(prev_gbuf), _np(prev_taa), _np(cur), fr,
                  fr["clear_color"], FULL)
    _assert_close("taa", got, ref)


@pytest.mark.parametrize("number,history", [(0, False), (1, True),
                                            (2, True)],
                         ids=["frame0", "odd", "even"])
def test_smaa_matches_reference(frames, number, history):
    """SMAA TU4X at ratio 2 on kernel 8's quads (the reference decimates
    its G-buffer), both frame parities, and frame 0 with no history."""
    rng = np.random.default_rng(10 + number)
    f = frames[number]
    prev_gbuf = (frames[number - 1]["gbuf"] if history
                 else _zeros_like_gbuf(f["gbuf"]))
    prev_tone = _tone(rng, RENDER) if history else torch.zeros(RENDER + (4,))
    tone = _tone(rng, RENDER)
    fp, fr = _frames(number, 2.0)
    got = smaa_tu4x(f["quads"], prev_gbuf, prev_tone, tone, fp, RENDER)
    ref = smaa_ref(_np(f["gbuf"]), _np(prev_gbuf), _np(prev_tone), _np(tone),
                   fr, RENDER)
    _assert_close("smaa", got, ref)


@pytest.mark.parametrize("taa", ["NONE", "JASMINE"])
@pytest.mark.parametrize("upscale", ["none", "smaa_tu4x"])
def test_post_chain_matches_reference(frames, taa, upscale):
    """The routing of the four supported (taa, upscale) pairs: the image
    and the history the next frame reads."""
    rng = np.random.default_rng(20)
    smaa = upscale == "smaa_tu4x"
    render = RENDER if smaa else FULL
    settings = {}
    for pkg in (ht, hj):
        settings[pkg] = dataclasses.replace(
            pkg.HikariSettings(), taa=getattr(pkg.Taa, taa),
            upscale=getattr(pkg.Upscale, upscale)())
    f = frames[2]
    carry = {"prev_gbuffer": {k: f["gbuf"][k] for k in
                              ("position", "normal", "instance_material",
                               "velocity_uv")},
             "prev_tone": _tone(rng, RENDER), "prev_taa": _tone(rng, FULL),
             "prev_upscale": torch.zeros(FULL + (4,))}
    carry["prev_gbuffer"] = {k: v.roll(1, 1) for k, v in
                             carry["prev_gbuffer"].items()}
    tone = _tone(rng, render)
    fp, fr = _frames(2, settings[ht].upscale_ratio)
    image, pc = post.post_chain(f["gbuf"], carry, tone, fp, settings[ht],
                                FULL, render, f["quads"] if smaa else None)
    ref_image, ref_pc = post_ref.post_chain(
        _np(f["gbuf"]), _np(carry), _np(tone), fr, settings[hj], FULL,
        render)
    _assert_close("image", image, ref_image)
    assert set(pc) == ({"prev_tone"} if smaa else set()) | (
        {"prev_taa"} if taa == "JASMINE" else set())
    for k, v in pc.items():
        _assert_close(k, v, ref_pc[k])


def test_post_chain_resizes_to_the_output():
    """Without SMAA at ratio 2 the chain resamples the render-size image
    to the output bilinearly (hikari_tpu's resize_bilinear)."""
    rng = np.random.default_rng(21)
    tone = _tone(rng, RENDER)
    s = dataclasses.replace(ht.HikariSettings(), taa=ht.Taa.NONE,
                            upscale=ht.Upscale(ht.UpscaleMode.NONE, 2.0))
    sj = dataclasses.replace(hj.HikariSettings(), taa=hj.Taa.NONE,
                             upscale=hj.Upscale(hj.UpscaleMode.NONE, 2.0))
    image, pc = post.post_chain({}, {}, tone, _frames(0, 2.0)[0], s, FULL,
                                RENDER, None)
    ref, _ = post_ref.post_chain({}, {"prev_gbuffer": {}, "prev_taa": None},
                                 _np(tone), _frames(0, 2.0)[1], sj, FULL,
                                 RENDER)
    assert pc == {}
    _assert_close("resize", image, ref)


def test_denoise_at_ratio_2_matches_reference(frames):
    """denoise_channels on the decimated G-buffer with the decimated albedo
    (albedo_r), two channels with seeded variance; the a-trous levels run
    in bf16 (kernel C's bar: max abs < 0.05, mean < 1e-3)."""
    rng = np.random.default_rng(22)
    f = frames[1]
    chans = [(torch.from_numpy(rng.uniform(0.0, 3.0, RENDER + (4,))
                               .astype(np.float32)),
              torch.from_numpy(rng.uniform(0.0, 0.5, RENDER)
                               .astype(np.float32)), ff)
             for ff in (False, True)]
    got = denoise_channels(f["g"], f["albedo"], chans, {"number": 1}, RENDER,
                           2.0, albedo_r=f["albedo_r"])
    ref = denoise_ref(_np(f["g"]), _np(f["albedo"]),
                      [(_np(r), _np(v), ff) for r, v, ff in chans],
                      {"number": jnp.uint32(1)}, RENDER, 2.0,
                      albedo_r=_np(f["albedo_r"]))
    for a, b in zip(got, ref):
        diff = np.abs(a.numpy() - np.asarray(b))
        assert np.isfinite(a.numpy()).all()
        assert diff.max() < 0.05 and diff.mean() < 1e-3, (diff.max(),
                                                           diff.mean())
