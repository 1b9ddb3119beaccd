"""Path KR, checkerboard lighting with temporal reuse (bench.py's
frame_ms_ckb_reuse): hikari_tpu_torch.Renderer on the CPU (the plain
versions of its kernels) against hikari_tpu.Renderer on its modular
lighting path, whose tracer is hikari_tpu's Pallas engine with kernels 5,
6 and 7 in interpret mode (tests/test_torch_modular.py:PallasTracer; on the
CPU make_tracer would pick the XLA engine), over frames with the camera
panning one pixel per frame: the images and the full-size temporal
reservoir planes."""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import torch

import hikari_tpu as hj
import hikari_tpu.ops.reproj_gather as reproj_ref
import hikari_tpu.renderer as renderer_ref
import hikari_tpu_torch as ht
from hikari_tpu_torch.ops.reservoir import unpack_fields
from tests.cornell_box import EYE, TARGET, build_cornell_box
from tests.test_torch_frame import (PAN_PX, SIZE, assert_frames_close,
                                    exact_gather, flagship)
from tests.test_torch_modular import PallasTracer
from tests.torch_threads import one_torch_thread  # noqa: F401

# frames 0-5: frame 0 and frame 5 validate the emissive channel
# (emissive_validate_interval 5)
FRAMES = 6


def settings(pkg):
    """bench.py:155-157: the flagship with temporal reuse and
    checkerboard lighting."""
    return dataclasses.replace(flagship(pkg), temporal_reuse=True,
                               checkerboard_lighting=True)


def camera(pkg, i):
    d = (PAN_PX * i, 0.0, 0.0)
    return pkg.Camera.from_look_at(tuple(np.add(EYE, d)),
                                   tuple(np.add(TARGET, d)),
                                   width=SIZE[1], height=SIZE[0])


_REFERENCE = {}


def reference_renderer(monkeypatch, s):
    """hikari_tpu's Renderer at settings `s` with the Pallas tracer stub
    and the exact gather (tests/test_torch_frame.py:exact_gather), reset;
    one per settings in this process."""
    key = repr(s)
    monkeypatch.setattr(renderer_ref, "make_tracer",
                        lambda n, **kw: PallasTracer())
    monkeypatch.setattr(reproj_ref, "reproj_gather", exact_gather)
    if key not in _REFERENCE:
        _REFERENCE[key] = hj.Renderer(build_cornell_box("hikari_tpu"),
                                      camera(hj, 0), s)
    r = _REFERENCE[key]
    r.reset()
    return r


def port_renderer(**changes):
    return ht.Renderer(build_cornell_box("hikari_tpu_torch"), camera(ht, 0),
                       dataclasses.replace(settings(ht), **changes),
                       device="cpu")


def render_both(monkeypatch, frames=FRAMES, **changes):
    ref_r = reference_renderer(monkeypatch,
                               dataclasses.replace(settings(hj), **changes))
    port_r = port_renderer(**changes)
    for i in range(frames):
        ref_r.camera = camera(hj, i)
        port_r.camera = camera(ht, i)
        ref = np.asarray(ref_r.render_frame())
        got = port_r.render_frame().numpy()
    return port_r, ref_r, got, ref


def assert_planes_close(got, ref, what):
    """Each unpacked reservoir field of [h,16,w] planes within rtol 1e-2 /
    atol 1e-3 (one bf16 step is 0.4-0.8%) on >= 99% of pixels."""
    fg = unpack_fields(got)
    fr = unpack_fields(torch.from_numpy(np.array(ref)))
    for k in fr:
        ok = np.isclose(fg[k].numpy(), fr[k].numpy(), rtol=1e-2, atol=1e-3)
        assert ok.mean() >= 0.99, (what, k, ok.mean())


def test_checkerboard_reuse_frame_matches_reference(monkeypatch):
    """Path KR over 6 frames (two emissive validation frames): the image,
    and the emissive and indirect temporal planes at the full 48x64."""
    port_r, ref_r, got, ref = render_both(monkeypatch)
    assert_frames_close(got, ref)
    for k in ("emissive_temporal", "indirect_temporal"):
        assert port_r.carry[k].shape == (SIZE[0], 16, SIZE[1])
        assert_planes_close(port_r.carry[k], np.asarray(ref_r.carry[k]), k)


def test_checkerboard_spatial_reuse_frame_matches_reference(monkeypatch):
    """Checkerboard + temporal + indirect spatial reuse over 6 frames: the
    modular spatial pass at the full 48x64 on the merged planes. The image,
    the temporal planes and the indirect spatial carry (hikari_tpu's packed
    [h,w,16] rows on this path)."""
    port_r, ref_r, got, ref = render_both(monkeypatch,
                                          indirect_spatial_reuse=True)
    assert_frames_close(got, ref)
    for k in ("emissive_temporal", "indirect_temporal"):
        assert_planes_close(port_r.carry[k], np.asarray(ref_r.carry[k]), k)
    ref_sp = np.asarray(ref_r.carry["spatial_indirect"])
    assert ref_sp.shape == (SIZE[0], SIZE[1], 16)
    assert port_r.carry["spatial_indirect"].shape == (SIZE[0], 16, SIZE[1])
    assert_planes_close(port_r.carry["spatial_indirect"],
                        ref_sp.transpose(0, 2, 1), "spatial_indirect")


def test_carry_from_jax_continues_the_reference(monkeypatch):
    """The port resumes hikari_tpu's path KR from its carry: the carry
    converts bit for bit, and the next frame agrees with the frame bar."""
    _, ref_r, _, _ = render_both(monkeypatch, frames=3)
    carry = jax.tree.map(np.asarray, ref_r.carry)
    resumed = port_renderer()
    resumed.carry = ht.frame.carry_from_jax(carry, resumed.settings, "cpu")
    resumed._frame_index = 3
    resumed._prev_view_initialized = True
    for k, v in resumed.carry.items():
        np.testing.assert_array_equal(v.numpy().view(np.uint32),
                                      carry[k].view(np.uint32), err_msg=k)
    ref_r.camera = camera(hj, 3)
    resumed.camera = camera(ht, 3)
    ref = np.asarray(ref_r.render_frame())
    assert_frames_close(resumed.render_frame().numpy(), ref)


def test_checkerboard_reuse_resumes_bit_exactly(tmp_path):
    """Path KR restored from a saved state (the full-size reservoir planes
    included) renders what the original renders next, bit for bit."""
    a = port_renderer()
    a.render(3)
    path = str(tmp_path / "state.pkl")
    a.save_state(path)
    b = port_renderer()
    b.load_state(path)
    for k, v in a.carry.items():
        assert torch.equal(b.carry[k].view(torch.int32),
                           v.view(torch.int32)), k
    np.testing.assert_array_equal(b.render(2), a.render(2))


def test_unlit_pixels_keep_their_reservoirs():
    """Each frame the lit half of the full-size carry takes the new
    reservoirs and the unlit half keeps the previous frame's words."""
    r = port_renderer()
    r.render(2)
    before = {k: v.clone() for k, v in r.carry.items()}
    r.render_frame()                                  # frame 2: parity 0
    yy, xx = np.mgrid[:SIZE[0], :SIZE[1]]
    unlit = torch.from_numpy((xx + yy) % 2 == 1)
    for k in ("emissive_temporal", "indirect_temporal"):
        same = (r.carry[k].view(torch.int32)
                == before[k].view(torch.int32)).all(1)
        assert bool(same[unlit].all()), k
        assert not bool(same[~unlit].all()), k


def test_update_settings_into_the_modular_path():
    """A static change into KR rebuilds the frame and the carry (the
    full-size [h,16,w] temporal planes) and renders."""
    r = ht.Renderer(build_cornell_box("hikari_tpu_torch"), camera(ht, 0),
                    flagship(ht), device="cpu")
    r.render(1)
    r.update_settings(temporal_reuse=True, checkerboard_lighting=True)
    assert r._frame_index == 0
    assert r.carry["indirect_temporal"].shape == (SIZE[0], 16, SIZE[1])
    img = r.render(2)
    assert img.shape == SIZE + (4,) and np.isfinite(img).all()
