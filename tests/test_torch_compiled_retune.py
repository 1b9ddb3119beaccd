"""A live retune of the settings' dynamic fields on the compiled frame's
route (the graphs themselves are captured and replayed only on CUDA:
chip_smoke.py's compiled check holds replayed retuned frames against eager
ones word for word).

(a) After update_settings of a validation interval the frame's key comes
    from the frame's own intervals: Renderer.frame_key(n) agrees with
    config.validates(n, new interval) and with the validation flags the
    frame hands kernel 4.
(b) The dynamic values are frame words: two frames of one key, before and
    after update_settings of every dynamic field, dispatch the same
    operations with the same shapes and non-tensor arguments (each
    kernel's plain version one opaque call), while the staged words
    change; update_settings keeps the frame index, the carry and the
    frame function.
(c) The port's Renderer and hikari_tpu.Renderer, both retuned by
    update_settings of dynamic fields only on the same frame, stay within
    the frame bars (SSIM >= 0.98, mean abs diff < 1e-3): path D's settings
    and the modular path with checkerboard and temporal reuse (KR).
    hikari_tpu keeps its carry and frame index on such a change too.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import pytest

import hikari_tpu_torch as ht
from hikari_tpu_torch.config import (DYNAMIC_WORDS, make_frame_uniform,
                                     validates)
from hikari_tpu_torch.examples import minimal
from hikari_tpu_torch.frame import W_DYNAMIC
from hikari_tpu_torch.ops import light_fused
from tests.cornell_box import EYE, TARGET, build_cornell_box
from tests.torch_recorder import (Recorder, first_difference, host_reads,
                                  install_opaque)
from tests.torch_threads import one_torch_thread  # noqa: F401

SMALL = (24, 32)

# every dynamic field retuned (hikari_tpu/renderer.py:98-126): both
# validation intervals (so that old and new keys cross), the reuse caps,
# a lifetime of 1 (never expire: the host's branch), the solar angle, the
# indirect clamp and the clear colour
RETUNE = dict(direct_validate_interval=2, emissive_validate_interval=3,
              max_temporal_reuse_count=20, max_spatial_reuse_count=300,
              max_reservoir_lifetime=1.0, solar_angle=0.2,
              max_indirect_luminance=2.0,
              clear_color=(0.1, 0.2, 0.3, 1.0))


def box_camera(i, size=SMALL):
    d = (0.03 * i, 0.0, 0.0)
    return ht.Camera.from_look_at(tuple(np.add(EYE, d)),
                                  tuple(np.add(TARGET, d)),
                                  width=size[1], height=size[0])


def minimal_camera(i, size=SMALL):
    d = (0.03 * i, 0.0, 0.0)
    return ht.Camera.from_look_at(tuple(np.add(minimal.EYE, d)),
                                  tuple(np.add(minimal.TARGET, d)),
                                  width=size[1], height=size[0])


# ---------------------------------------------------------------------------
# (a) the key after a retune of a validation interval
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("channel", ["emissive", "direct"])
def test_frame_key_follows_a_retuned_interval(monkeypatch, channel):
    """The box (its emissive channel, 5 -> 3; path D's settings) and the
    minimal scene (its sun's direct channel, 3 -> 2; the minimal example's
    settings), the interval retuned after frame 1: frames 0-5 have keys
    that agree with validates(n, new interval), and on frames 2-5 kernel 4
    receives that branch's flags."""
    if channel == "emissive":
        r = ht.Renderer(build_cornell_box("hikari_tpu_torch"), box_camera(0),
                        ht.HikariSettings(), device="cpu")
        field, slot, interval = "emissive_validate_interval", 2, 3
    else:
        r = ht.Renderer(minimal.build_scene(), minimal_camera(0),
                        minimal.settings(), device="cpu")
        field, slot, interval = "direct_validate_interval", 1, 2
    flags = {}
    real = light_fused.validation_flags

    def record(frame, has_sun, n_em):
        out = real(frame, has_sun, n_em)
        flags.setdefault(frame["number"], set()).add(bool(out[slot - 1]))
        return out

    monkeypatch.setattr(light_fused, "validation_flags", record)
    r.render_frame()
    r.render_frame()
    assert getattr(r.settings, field) != interval
    r.update_settings(**{field: interval})
    assert [r.frame_key(n)[slot] for n in range(6)] == [
        validates(n, interval) for n in range(6)]
    flags.clear()
    for _ in range(4):
        r.render_frame()
    assert flags == {n: {validates(n, interval)} for n in range(2, 6)}


# ---------------------------------------------------------------------------
# (b) a retune changes words, not operations
# ---------------------------------------------------------------------------

def settings_of(case):
    s = ht.HikariSettings()
    if case == "D":
        return s
    # KR: the modular path (kernels 5-7) with checkerboard, temporal reuse
    # and the indirect spatial pass
    return dataclasses.replace(s, taa=ht.Taa.NONE, upscale=ht.Upscale.none(),
                               checkerboard_lighting=True)


def record_frame(rec, r, number):
    r._frame_index = number
    r.camera = box_camera(number)
    rec.ops = []
    with rec:
        r.render_frame()
    return rec.ops


@pytest.mark.parametrize("case", ["D", "KR"])
def test_a_retune_dispatches_the_same_operations(monkeypatch, case):
    """Frame 10 before and a frame of the same key after update_settings
    of every dynamic field dispatch the same operations; the staged
    dynamic words differ, the carry's tensors, the frame function and the
    frame index stay."""
    rec = Recorder()
    install_opaque(rec, monkeypatch.setattr)
    r = ht.Renderer(build_cornell_box("hikari_tpu_torch"), box_camera(0),
                    settings_of(case), device="cpu")
    for _ in range(3):
        r.render_frame()
    before = record_frame(rec, r, 10)
    key = r.frame_key(10)
    words = r._inputs.host.numpy()[-DYNAMIC_WORDS:].copy()
    fn, carry = r._frame_fn, {k: id(v) for k, v in r.carry.items()}
    r.update_settings(**RETUNE)
    assert r._frame_index == 11 and r._frame_fn is fn
    assert {k: id(v) for k, v in r.carry.items()} == carry
    number = next(n for n in range(11, 60) if r.frame_key(n) == key)
    after = record_frame(rec, r, number)
    assert before == after, first_difference(before, after)
    assert len(before) > 100
    assert not host_reads(before + after)
    staged = r._inputs.host.numpy()[-DYNAMIC_WORDS:]
    want = ht.frame.frame_words(r.settings, make_frame_uniform(
        r.settings, number))[W_DYNAMIC:]
    assert np.array_equal(staged, want)
    assert not np.array_equal(staged, words)


# ---------------------------------------------------------------------------
# (c) both renderers retuned on the same frame
# ---------------------------------------------------------------------------

# frames 0-5, the retune before frame 2: the new intervals validate frames
# 2 (direct), 3 (emissive) and 4 (direct)
FRAMES, RETUNE_AT = 6, 2
# the reference's dynamic fields for the box (no sun: the solar angle has
# no effect there; the lifetime of 4 expires spatial reservoirs in the run)
BOX_RETUNE = dict(RETUNE, max_reservoir_lifetime=4.0)


@contextlib.contextmanager
def retuned_back(ref_r):
    """Restores the dynamic fields of a reference renderer that its test
    module caches for other tests of the process."""
    old = {k: getattr(ref_r.settings, k) for k in BOX_RETUNE}
    try:
        yield
    finally:
        ref_r.update_settings(**old)


def render_retuned(ref_r, port_r, camera):
    """FRAMES frames through both renderers, both retuned by BOX_RETUNE
    before frame RETUNE_AT; returns the last (port, reference) images."""
    import hikari_tpu as hj

    for i in range(FRAMES):
        if i == RETUNE_AT:
            ref_r.update_settings(**BOX_RETUNE)
            port_r.update_settings(**BOX_RETUNE)
        ref_r.camera = camera(hj, i)
        port_r.camera = camera(ht, i)
        ref = np.asarray(ref_r.render_frame())
        got = port_r.render_frame().numpy()
    assert port_r._frame_index == ref_r._frame_index == FRAMES
    return got, ref


def test_retuned_default_frame_matches_reference(monkeypatch):
    """Path D (tests/test_torch_frame_post.py's size and pan) retuned
    before frame 2 on both renderers."""
    from tests.test_torch_frame_post import (SIZE, assert_frames_close,
                                             camera, port_renderer,
                                             reference_renderer)

    ref_r = reference_renderer(monkeypatch, "D")
    with retuned_back(ref_r):
        got, ref = render_retuned(ref_r, port_renderer("D"), camera)
    assert_frames_close(got, ref, size=SIZE)


def test_retuned_modular_frame_matches_reference(monkeypatch):
    """Path KR (tests/test_torch_frame_ckb_reuse.py) retuned before frame
    2 on both renderers."""
    from tests.test_torch_frame_ckb_reuse import (camera, port_renderer,
                                                  reference_renderer,
                                                  settings)
    from tests.test_torch_frame import assert_frames_close
    import hikari_tpu as hj

    ref_r = reference_renderer(monkeypatch, settings(hj))
    with retuned_back(ref_r):
        got, ref = render_retuned(ref_r, port_renderer(), camera)
    assert_frames_close(got, ref)
