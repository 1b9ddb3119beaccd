"""The box's whole frame at the upscale settings beyond SMAA 2.0:
hikari_tpu_torch.Renderer on the CPU (the plain versions of its kernels)
against hikari_tpu.Renderer with its fused Pallas kernels in interpret mode
and an exact gather (tests/test_torch_frame_post.py:reference_renderer),
the flagship + TAA Jasmine with one of

* FSR 1.0 at ratio 1.3 (here: kernel A's full-only call, the generic
  resample to 37x128, TAA at the render size, EASU + RCAS to 48x166);
* SMAA TU4X at ratio 1 (its supersampling: output and TAA at 96x256 over
  a 48x128 frame, then the bilinear resize; tests/test_torch_frame_smaa1.py);
* SMAA TU4X at ratio 2 at the odd size 47x255 (render 24x128: neither
  kernel A's decimated call nor kernel 8's quads; the generic resample
  and SMAA's generic parity sampler; tests/test_torch_frame_odd.py);
* checkerboard lighting with SMAA TU4X at ratio 2 (kernel B over the
  compressed 24x64 domain of the decimated G-buffer, with kernel 8's
  quads; tests/test_torch_frame_ckb_half.py);
* checkerboard lighting with FSR 1.0 at ratio 1.5 (kernel B over the
  compressed 32x64 domain of the generic resample's 32x128 G-buffer, TAA
  at 32x128, EASU + RCAS to 48x192; tests/test_torch_frame_ckb_fsr.py),

one file each (each case compiles its own reference frame). Four frames
with the camera panning one pixel of TAA's grid per frame: the image (SSIM
>= 0.98, mean abs diff < 1e-3), the post history (the same bar), and the
carries through carry_from_jax bit for bit. The exact check (`check_case`
with exact=True, the checkerboard + FSR case) pans one output pixel a
frame, feeds the port hikari_tpu's G-buffer (`reference_gbuffer`) and
runs hikari_tpu's generic resample and post chain as written
(`resample_as_written`, `post_op_by_op`); the image must then also agree
within 1e-5 mean abs diff. The sizes keep every warp on
whole 128-wide groups (hikari_tpu's banded warp is exact only there).

Why a pixel of TAA's grid: under camera motion the two stacks part at
knife edges, none of them in the upscale path. tests/torch_pan_witness.py
takes the FSR 1.3 case apart (last frame's mean abs diff): 8.0e-5 with
the camera still, 2.0e-3 (SSIM 0.981) panning one output pixel a frame,
1.3e-3 with the port fed hikari_tpu's own G-buffer, and 1.3e-7 when,
besides, hikari_tpu's generic resample index map and its post chain run
as written. Inside the jitted frame XLA's CPU compiler fuses
`(i + 0.5) * ratio - 0.25` (restir.py:117-119) and TAA's history
coordinate `ys - velocity * h - 0.5` (taa.py:97-98) into single FMAs,
which move an index by a pixel where the product lands on an integer;
the port and hikari_tpu's eager ops round the product first. With the
port's own G-buffer and that exact reference the pan still gives 1.8e-3:
kernel A's plain version differs from hikari_tpu's kernel A (compiled or
op by op) in the last bits of ~8% of the G-buffer's words, within
tests/test_torch_prepass.py's 1e-4, and under motion those bits reach the
image at a few columns of edges (0.5% of the pixels off by more than 0.1,
in 6 columns), sharpened by RCAS. A pan of one pixel of TAA's grid meets the bar on the last
frame (9.2e-4), not on frames 1-2 (1.2e-3, 1.7e-3). Path P's test pans
one pixel of its TAA grid too (its output size).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hikari_tpu as hj
import hikari_tpu.ops.denoise as denoise_ref
import hikari_tpu.ops.post as post_ref
import hikari_tpu.ops.prepass_fused as pf_ref
import hikari_tpu.ops.reproj_gather as reproj_ref
import hikari_tpu.ops.restir as restir_ref
import hikari_tpu_torch as ht
from hikari_tpu_torch.ops import prepass_fused as pf
from tests.cornell_box import EYE, TARGET, build_cornell_box
from tests.test_torch_frame import assert_frames_close, exact_gather, flagship
from tests.torch_threads import one_torch_thread  # noqa: F401

FRAMES = 4
# (upscale, ratio, checkerboard, output size)
CASES = {
    "fsr1_1.3": ("fsr1", 1.3, False, (48, 166)),
    "smaa_1.0": ("smaa_tu4x", 1.0, False, (48, 128)),
    "smaa_2.0_odd": ("smaa_tu4x", 2.0, False, (47, 255)),
    "ckb_smaa_2.0": ("smaa_tu4x", 2.0, True, (48, 256)),
    "ckb_fsr1_1.5": ("fsr1", 1.5, True, (48, 192)),
}
# the exact check's bar on the mean abs diff
EXACT_MEAN_ABS = 1e-5

_RESAMPLE = restir_ref.resample_deferred
_POST = post_ref.post_chain


def case_settings(pkg, case):
    upscale, ratio, ckb, _ = CASES[case]
    return dataclasses.replace(
        flagship(pkg), taa=pkg.Taa.JASMINE,
        upscale=getattr(pkg.Upscale, upscale)(ratio),
        checkerboard_lighting=ckb)


def taa_rows(case):
    """The rows of TAA's grid (the post size) of `case`."""
    return ht.frame.post_carry_shapes(CASES[case][3], case_settings(
        ht, case))["prev_taa"][0]


def camera(pkg, case, i, rows=None):
    """The box's camera moved sideways 1/rows of the frame's height per
    frame at the box's depth (still for rows = 0); by default one pixel of
    TAA's grid."""
    size = CASES[case][3]
    rows = taa_rows(case) if rows is None else rows
    step = 2.0 * 3.2 * np.tan(np.pi / 8.0) / rows if rows else 0.0
    d = (step * i, 0.0, 0.0)
    return pkg.Camera.from_look_at(tuple(np.add(EYE, d)),
                                   tuple(np.add(TARGET, d)),
                                   width=size[1], height=size[0])


def resample_as_written(img, render_size, frame_number, ratio):
    """hikari_tpu's resample_deferred with its generic index map computed
    by numpy, rounding after the product as restir.py:117-119 is written
    (inside a jitted frame XLA's CPU compiler fuses the multiply-add)."""
    h, w = render_size
    H, W = img.shape[:2]
    if ((ratio == 1.0 and (H, W) == (h, w))
            or (ratio == 2.0 and H >= 2 * h and W >= 2 * w)):
        return _RESAMPLE(img, render_size, frame_number, ratio)

    def index(n, n_full, sign):
        i = np.arange(n, dtype=np.float32)
        x = (i + np.float32(0.5)) * np.float32(ratio) + np.float32(sign)
        return np.clip(x.astype(np.int32), 0, n_full - 1)

    even = (frame_number & 1) == 0
    ys = jnp.where(even, index(h, H, -0.25), index(h, H, 0.25))
    xs = jnp.where(even, index(w, W, -0.25), index(w, W, 0.25))
    return jnp.take(jnp.take(img, ys, axis=0), xs, axis=1)


def post_op_by_op(gbuf, carry, tone, frame, settings, full_size,
                  render_size, smaa_quads=None):
    """hikari_tpu's post_chain run eagerly on the host from inside the
    jitted frame, so that none of its multiply-adds fuse (TAA's history
    coordinate, taa.py:97-98)."""
    leaves, tree = jax.tree.flatten((gbuf, carry, tone, frame, smaa_quads))
    is_array = [hasattr(leaf, "shape") for leaf in leaves]

    def call(*arrays):
        it = iter(arrays)
        g, c, t, f, q = jax.tree.unflatten(
            tree, [next(it) if a else leaf
                   for leaf, a in zip(leaves, is_array)])
        return _POST(g, c, t, f, settings, full_size, render_size,
                     smaa_quads=q)

    arrays = [leaf for leaf, a in zip(leaves, is_array) if a]

    def host(*values):
        return jax.tree.map(np.asarray,
                            call(*[jnp.asarray(v) for v in values]))

    return jax.pure_callback(host, jax.eval_shape(call, *arrays), *arrays)


def reference_gbuffer(ref_r):
    """A stand-in for the port's prepass_fused (kernel A's full-only call):
    hikari_tpu's kernel A, jitted, on the port's views and ref_r's
    scene."""
    call = jax.jit(pf_ref.prepass_fused, static_argnums=(4,))

    def prepass(scene, view, prev_view, jitter, size, dec_parity=None,
                mesh=None):
        assert dec_parity is None and mesh is None
        g, a = call(ref_r.scene_dev,
                    {k: jnp.asarray(v.numpy()) for k, v in view.items()},
                    {k: jnp.asarray(v.numpy()) for k, v in prev_view.items()},
                    jnp.asarray(np.float32(jitter)), tuple(size))
        return ({k: torch.from_numpy(np.array(v)) for k, v in g.items()},
                torch.from_numpy(np.array(a)))
    return prepass


def reference_renderer(monkeypatch, case, exact=False):
    """hikari_tpu's Renderer for `case`, reset, with its fused Pallas
    kernels (interpret mode) and the exact gather; with `exact`, its
    resample and post chain as written (resample_as_written,
    post_op_by_op)."""
    monkeypatch.setattr(reproj_ref, "reproj_gather", exact_gather)
    if exact:
        monkeypatch.setattr(restir_ref, "resample_deferred",
                            resample_as_written)
        monkeypatch.setattr(denoise_ref, "resample_deferred",
                            resample_as_written)
        monkeypatch.setattr(post_ref, "post_chain", post_op_by_op)
    ref_r = hj.Renderer(build_cornell_box("hikari_tpu"), camera(hj, case, 0),
                        case_settings(hj, case))
    monkeypatch.setattr(ref_r.tracer, "kind", "brute_force_pallas",
                        raising=False)
    ref_r.reset()
    return ref_r


def render_both(monkeypatch, case, frames, exact=False, rows=None,
                own_gbuffer=False):
    """`frames` frames of the panning camera (`camera`'s rows) through both
    renderers; with `exact`, the reference's as reference_renderer sets it
    up and, unless `own_gbuffer`, the port fed its G-buffer
    (reference_gbuffer). Returns (port renderer, reference renderer, port
    image, reference image) after the last."""
    ref_r = reference_renderer(monkeypatch, case, exact)
    if exact and not own_gbuffer:
        monkeypatch.setattr(pf, "prepass_fused", reference_gbuffer(ref_r))
    port_r = ht.Renderer(build_cornell_box("hikari_tpu_torch"),
                         camera(ht, case, 0, rows), case_settings(ht, case),
                         device="cpu")
    for i in range(frames):
        ref_r.camera = camera(hj, case, i, rows)
        port_r.camera = camera(ht, case, i, rows)
        ref = np.asarray(ref_r.render_frame())
        got = port_r.render_frame().numpy()
    return port_r, ref_r, got, ref


def check_case(monkeypatch, case, exact=False):
    """Four frames of `case`: the image, the post history at its shapes,
    and the carry converted from the reference's bit for bit. By default
    the whole port pans one pixel of TAA's grid a frame; with `exact` it
    pans one output pixel a frame with the G-buffer and the reference of
    render_both's exact set-up, and the image must also agree within
    EXACT_MEAN_ABS."""
    rows = CASES[case][3][0] if exact else None
    port_r, ref_r, got, ref = render_both(monkeypatch, case, FRAMES, exact,
                                          rows)
    size = CASES[case][3]
    assert_frames_close(got, ref, size=size)
    if exact:
        assert np.abs(got - ref).mean() < EXACT_MEAN_ABS
    shapes = ht.frame.post_carry_shapes(size, port_r.settings)
    assert set(port_r.carry) == {"prev_view_proj", "prev_inverse_view_proj",
                                 *shapes}
    for k in ("prev_taa", "prev_tone"):
        if k in shapes:
            v = port_r.carry[k].numpy()
            assert v.shape == shapes[k]
            assert_frames_close(v, np.asarray(ref_r.carry[k]),
                                size=shapes[k][:2])
    carry = jax.tree.map(np.asarray, ref_r.carry)
    conv = ht.frame.carry_from_jax(carry, port_r.settings, "cpu",
                                   full_size=size)
    assert set(conv) == set(port_r.carry)
    for k in shapes:
        for p, v in (conv[k].items() if isinstance(conv[k], dict)
                     else [(None, conv[k])]):
            want = carry[k] if p is None else carry[k][p]
            np.testing.assert_array_equal(v.numpy().view(np.uint32),
                                          want.view(np.uint32))
    return port_r


def test_fsr_frame_matches_reference(monkeypatch):
    """FSR 1.0 at ratio 1.3: TAA's history at the render size."""
    port_r = check_case(monkeypatch, "fsr1_1.3")
    assert port_r.carry["prev_taa"].shape == (37, 128, 4)


@pytest.mark.xfail(strict=True, reason=(
    "kernel A's plain version differs from hikari_tpu's kernel A in the "
    "last bits of its G-buffer words: XLA's CPU rsqrt (the rsqrtps "
    "estimate and two Newton steps) and its FMA contraction of the kernel "
    "body have no IEEE form in PyTorch (PERF.md section 7)"))
def test_fsr_frame_one_output_pixel_pan_on_the_ports_gbuffer(monkeypatch):
    """FSR 1.0 at ratio 1.3, the camera panning one output pixel a frame:
    the port on its own G-buffer (kernel A's plain version) against the
    exact reference (hikari_tpu's resample and post chain as written),
    under the frame bar."""
    size = CASES["fsr1_1.3"][3]
    _, _, got, ref = render_both(monkeypatch, "fsr1_1.3", FRAMES, exact=True,
                                 rows=size[0], own_gbuffer=True)
    assert_frames_close(got, ref, size=size)
