"""The compiled frame's contract on the CPU (the graphs themselves are
captured and replayed only on CUDA: chip_smoke.py holds the replayed
frames against the eager ones word for word).

(a) The frame fed through Renderer's static buffers (the view uniform and
    frame.frame_words, rewritten in place each frame) gives the words of
    the frame fed fresh inputs, over frames that cover every key of the
    path and rotate the spiral at every frame, and stays within the frame
    bars against hikari_tpu's Renderer on the same frames.
(b) Two frames of one key dispatch the same operations, with the same
    shapes, dtypes and non-tensor arguments (each kernel wrapper's plain
    version recorded as one opaque call), so a replay bakes in nothing of
    a frame; frames of two keys differ; the glue reads nothing back to
    the host.
(c) update_scene(fast=True), by the device refit and by the host refit
    above 8 emissives, keeps every scene tensor's address and writes the
    values the refits give.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import hikari_tpu_torch as ht
from hikari_tpu_torch.camera import view_to_device
from hikari_tpu_torch.config import make_frame_uniform
from hikari_tpu_torch.examples import city
from hikari_tpu_torch.models.refit_device import DeviceRefitter
from hikari_tpu_torch.models.scene import upload
from tests.cornell_box import EYE, TARGET, build_cornell_box
from tests.test_torch_frame import (PAN_PX, PATHS, REUSE_FRAMES, SIZE,
                                    assert_frames_close, port_renderer,
                                    reference_renderer)
from tests.torch_recorder import (Recorder, first_difference, host_reads,
                                  install_opaque)
from tests.torch_threads import one_torch_thread  # noqa: F401

SMALL = (24, 32)


def leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, f"{prefix}{k}/")
    else:
        yield prefix[:-1], tree


def words(t):
    return t.detach().contiguous().view(torch.int32)


def assert_words_equal(got, want, what):
    assert got.shape == want.shape, what
    assert torch.equal(words(got), words(want)), what


def box_camera(i, size):
    d = (0.03 * i, 0.0, 0.0)
    return ht.Camera.from_look_at(tuple(np.add(EYE, d)),
                                  tuple(np.add(TARGET, d)),
                                  width=size[1], height=size[0])


def settings_of(case):
    s = ht.HikariSettings()
    if case == "D":
        return s
    if case == "ckb_reuse":
        return dataclasses.replace(
            s, taa=ht.Taa.NONE, upscale=ht.Upscale.none(),
            checkerboard_lighting=True, indirect_spatial_reuse=False)
    if case == "scramble":
        return dataclasses.replace(s, spatial_tap_scramble=True,
                                   emissive_spatial_reuse=True)
    return s


def keys_covered(r, numbers):
    return {r.frame_key(n) for n in numbers}


def static_against_fresh(r, cam_of, frames, reference=None):
    """Renders `frames` frames through Renderer (the static buffers) and,
    beside it, through its frame function on fresh inputs (new view
    tensors, a frame dict without device words, the carry replaced),
    comparing the image and every carry leaf word for word; with
    `reference` ((hikari_tpu's Renderer, its camera of frame i)) the same
    frames through it, and the last image against its with the frame bar
    (as tests/test_torch_frame.py holds it). Returns the static buffers'
    addresses of each frame."""
    fresh_carry = ht.frame.init_carry(r.full_size, r.settings, "cpu")
    addresses = []
    for i in range(frames):
        cam = cam_of(i)
        r.camera = cam
        got = r.render_frame()
        view = view_to_device(cam.view_uniform(), "cpu")
        if i == 0:
            fresh_carry["prev_view_proj"] = view["view_proj"].clone()
            fresh_carry["prev_inverse_view_proj"] = (
                view["inverse_view_proj"].clone())
        image, albedo, fresh_carry = r._frame_fn(
            r.scene_dev, view, make_frame_uniform(r.settings, i), r.noise,
            fresh_carry)
        want = r._post_overlay(image, albedo)
        assert_words_equal(got, want, f"frame {i}: image")
        fresh = dict(leaves(fresh_carry))
        for k, v in leaves(r.carry):
            assert_words_equal(v, fresh[k], f"frame {i}: carry {k}")
        addresses.append((r._inputs.dev.data_ptr(),
                          {k: v.data_ptr() for k, v in leaves(r.carry)}))
        if reference is not None:
            ref_r, ref_camera = reference
            ref_r.camera = ref_camera(i)
            ref = np.asarray(ref_r.render_frame())
    if reference is not None:
        assert_frames_close(got.numpy(), ref, size=got.shape[:2])
    return addresses


def s_camera(pkg, i):
    d = (PAN_PX * i, 0.0, 0.0)
    return pkg.Camera.from_look_at(tuple(np.add(EYE, d)),
                                   tuple(np.add(TARGET, d)),
                                   width=SIZE[1], height=SIZE[0])


def test_static_inputs_equal_fresh_inputs_against_the_reference(
        monkeypatch):
    """Path S (temporal reuse and both spatial channels: kernels A, 9, 4,
    10 twice, C) at 48x64 over frames 0-3 with the camera panning: both
    keys (the emissive validation), four spiral rotations. The static
    frame equals the fresh one word for word, its buffers keep their
    addresses, and the image stays within the frame bar against
    hikari_tpu's Renderer on the same frames."""
    import hikari_tpu as hj

    r = port_renderer(**PATHS["S"])
    frames = REUSE_FRAMES
    assert keys_covered(r, range(frames)) == {(None, None, True),
                                              (None, None, False)}
    ref = reference_renderer(monkeypatch, **PATHS["S"])
    addresses = static_against_fresh(r, lambda i: s_camera(ht, i), frames,
                                     reference=(ref,
                                                lambda i: s_camera(hj, i)))
    assert all(a == addresses[0] for a in addresses)


@pytest.mark.parametrize("case", ["D", "ckb_reuse", "scramble"])
def test_static_inputs_equal_fresh_inputs(case):
    """Path D (HikariSettings(): kernels A, 8, 9, 4, 10, C, 11, 12), and
    the modular path (kernels 5-7) with the checkerboard and temporal
    reuse, and with the spatial tap scramble (its taps gathers at the
    frame's device offsets), at 24x32 over frames 0-5, which cover their
    four keys (the parity and the emissive validation)."""
    r = ht.Renderer(build_cornell_box("hikari_tpu_torch"),
                    box_camera(0, SMALL), settings_of(case), device="cpu")
    frames = 6
    assert keys_covered(r, range(frames)) == {
        (p, None, v) for p in (0, 1) for v in (False, True)}
    addresses = static_against_fresh(r, lambda i: box_camera(i, SMALL),
                                     frames)
    assert all(a == addresses[0] for a in addresses)


# ---------------------------------------------------------------------------
# (b) one key, one trace
# ---------------------------------------------------------------------------

@pytest.fixture
def recorder(monkeypatch):
    rec = Recorder()
    install_opaque(rec, monkeypatch.setattr)
    return rec


def record(rec, r, number, cam, step=None):
    """The operations of frame `number` (its update first, if any)."""
    r._frame_index = number
    r.camera = cam
    if step is not None:
        step()
    rec.ops = []
    with rec:
        r.render_frame()
    return rec.ops


def assert_one_trace(rec, r, same, other, cam_of, step_of=None):
    step_of = step_of or (lambda n: None)
    assert r.frame_key(same[0]) == r.frame_key(same[1])
    assert r.frame_key(other) != r.frame_key(same[0])
    for n in range(3):                  # the first frames, unrecorded
        r.camera = cam_of(n)
        r.render_frame()
    a = record(rec, r, same[0], cam_of(same[0]), step_of(same[0]))
    b = record(rec, r, same[1], cam_of(same[1]), step_of(same[1]))
    assert a == b, first_difference(a, b)
    assert len(a) > 100
    c = record(rec, r, other, cam_of(other), step_of(other))
    assert a != c
    host = host_reads(a + c)
    assert not host, host[:5]


def test_one_key_one_trace_on_path_d(recorder):
    """Path D: frames 10 and 20 (key (0, None, True), another jitter,
    another spiral, the camera moved) dispatch the same operations;
    frame 11 (key (1, None, False)) others."""
    r = ht.Renderer(build_cornell_box("hikari_tpu_torch"),
                    box_camera(0, SMALL), ht.HikariSettings(), device="cpu")
    assert_one_trace(recorder, r, (10, 20), 11,
                     lambda n: box_camera(n, SMALL))


def test_one_key_one_trace_on_the_scramble(recorder):
    """The modular spatial pass with the tap scramble (kernels 5-7, the
    taps' gathers at device offsets, emissive and indirect)."""
    r = ht.Renderer(build_cornell_box("hikari_tpu_torch"),
                    box_camera(0, SMALL), settings_of("scramble"),
                    device="cpu")
    assert_one_trace(recorder, r, (10, 20), 11,
                     lambda n: box_camera(n, SMALL))


def city_camera(n, size):
    return ht.Camera.from_look_at((0.05 * n, 2.5, 20.0), (0.05 * n, 0.0, 0.0),
                                  width=size[1], height=size[0], hdr=True)


def test_one_key_one_trace_on_the_city(recorder):
    """The city (the non-fused prepass, kernel 13, the modular path with
    indirect spatial reuse, SMAA and TAA, the HDR tail), its sphere turned
    by the device refit before each frame: frames 7 and 13 (key (1,
    False, False)) dispatch the same operations, frame 9 (a direct
    validation frame) others."""
    sc = city.build_scene(1)
    r = ht.Renderer(sc, city_camera(0, SMALL), ht.HikariSettings(),
                    device="cpu")

    def step_of(n):
        return lambda: r.update_scene(city.rotate_sphere(sc, 0.01 * n),
                                      fast=True)

    assert_one_trace(recorder, r, (7, 13), 9,
                     lambda n: city_camera(n, SMALL), step_of)


# ---------------------------------------------------------------------------
# (c) fast updates in place
# ---------------------------------------------------------------------------

def emitters_scene(t):
    """A cube moving along x over a plane, lit by nine small emissive
    spheres (above renderer.SMALL_EMISSIVE_MAX: the host refit)."""
    from hikari_tpu_torch.models import material, mesh
    from hikari_tpu_torch.models import scene as scene_mod

    T, Mat = scene_mod.make_transform, material.StandardMaterial
    sc = scene_mod.Scene()
    cube = sc.add_mesh(mesh.cube(1.0))
    plane = sc.add_mesh(mesh.plane(8.0))
    sphere = sc.add_mesh(mesh.uv_sphere(0.2, 8, 6))
    m0 = sc.add_material(Mat.from_color(0.8, 0.2, 0.2))
    m1 = sc.add_material(Mat.from_color(0.3, 0.5, 0.3))
    me = sc.add_material(Mat(emissive=(4.0, 3.0, 2.0, 1.0)))
    sc.spawn(cube, m0, T((t, 0.5, 0.0)), prev_transform=T((t - 0.1, 0.5,
                                                           0.0)))
    sc.spawn(plane, m1)
    for i in range(9):
        sc.spawn(sphere, me, T((-2.0 + 0.5 * i, 2.0, -1.0)))
    return sc


def addresses(r):
    return {k: v.data_ptr() for k, v in r.scene_dev.items()}


def assert_scene_is(r, want):
    for k, v in want.items():
        assert k in r.scene_dev, k
        got = r.scene_dev[k]
        assert got.numel() == v.numel(), k
        assert torch.equal(words(got.reshape(v.shape)), words(v)), k


def test_device_refit_writes_in_place():
    """The city's sphere turned by update_scene(fast=True) (the device
    refit): every scene tensor keeps its address and holds the words of
    DeviceRefitter.update on the same transforms."""
    sc = city.build_scene(1)
    r = ht.Renderer(sc, city_camera(0, SMALL), ht.HikariSettings(),
                    device="cpu")
    before = addresses(r)
    refitter = DeviceRefitter(r.gpu_scene, "cpu")
    r.render_frame()
    for angle in (0.1, 0.3):
        moved = city.rotate_sphere(sc, angle)
        r.update_scene(moved, fast=True)
        assert addresses(r) == before
        visible = [i for i in moved.instances if i.visible]
        mats = torch.from_numpy(np.stack(
            [np.asarray(i.transform, np.float32) for i in visible]
            + [np.asarray(i.transform if i.prev_transform is None
                          else i.prev_transform, np.float32)
               for i in visible]))
        n = len(visible)
        assert_scene_is(r, refitter.update(mats[:n], mats[n:]))
        r.render_frame()


def test_host_refit_writes_in_place():
    """A scene of nine emissives moved by update_scene(fast=True) (the host
    refit, GpuScene.update_transforms): every scene tensor keeps its
    address and holds the arrays the refit gives, kernel 13's tables
    included."""
    sc = emitters_scene(0.0)
    r = ht.Renderer(sc, box_camera(0, SMALL), ht.HikariSettings(),
                    device="cpu")
    assert r.gpu_scene.num_emissives > ht.renderer.SMALL_EMISSIVE_MAX
    before = addresses(r)
    r.render_frame()
    for t in (0.2, 0.5):
        r.update_scene(emitters_scene(t), fast=True)
        assert addresses(r) == before
        gpu = r.gpu_scene
        assert_scene_is(r, upload({**gpu.arrays, **gpu.kernel_tables()},
                                  "cpu"))
        r.render_frame()
