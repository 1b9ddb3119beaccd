"""Path CL, the city with 16 street lamps (tests/city_lamps.py: 154
instances, 3,002 triangles, 17 emissives): the port's Renderer on the CPU
against hikari_tpu's Renderer on the CPU at HikariSettings() with SMAA 2.0,
an HDR camera and BloomSettings(), 48x256 output (24x128 render: whole
128-wide groups for the reference's banded warp). Four frames with
update_scene(rotate_sphere, fast=True) between them: above 8 emissives
both renderers take the host refit (GpuScene.update_transforms) and walk
the emissive BVH that the refit rebuilt. The images are held to the frame
bars (SSIM >= 0.98, mean abs diff < 1e-3), as the city's.

As in tests/test_torch_frame_city.py the reference takes an exact
reprojection gather and the nearest-occluder BVH walk (ROADMAP section 3,
reference items 4, 5 and 8). The reference Renderer is built once per
module: its frame and post programs take most of this file's time to
compile.

The same fixture counts hikari_tpu's tracer calls in each frame as they
run (a host callback in its frame program, so a call in a branch the frame
does not take counts nothing) and holds them to chip_smoke.py's
cl_launches, the kernel 13 launches path CL must make per frame number on
the card."""

from __future__ import annotations

import collections
import importlib.util
import os

import jax
import numpy as np
import pytest

import hikari_tpu as hj
import hikari_tpu.renderer as ref_renderer
import hikari_tpu.ops.reproj_gather as reproj_ref
import hikari_tpu.ops.trace as trace_ref
import hikari_tpu_torch as ht
from hikari_tpu.ops.bloom import BloomSettings as RefBloom
from hikari_tpu_torch.ops.bloom import BloomSettings
from tests.city_lamps import build_city_lamps, city_module
from tests.test_torch_frame import assert_frames_close, exact_gather
from tests.test_torch_frame_city import angle, camera, nearest_walk
from tests.torch_threads import one_torch_thread  # noqa: F401

SIZE = (48, 256)
FRAMES = 4


class CountingTracer:
    """hikari_tpu's tracer with each trace call counted when it runs: the
    attribute calls with_info and probe_info (kernel 13 full in the port)
    and the tracer called itself, which on the CPU (kind "bvh", no
    `shadow` attribute) traces the shadow rays (kernel 13 shadow)."""

    MODES = {"with_info": "full", "probe_info": "full"}

    def __init__(self, inner):
        self._inner = inner
        self.counts = collections.Counter()

    def _count(self, mode, ro):
        jax.debug.callback(lambda _: self.counts.update([mode]), ro[0, 0])

    def __call__(self, scene, ro, *a, **k):
        self._count("shadow", ro)
        return self._inner(scene, ro, *a, **k)

    def __getattr__(self, name):
        attr = getattr(self._inner, name)
        if name not in self.MODES:
            return attr

        def counted(scene, ro, *a, **k):
            self._count(self.MODES[name], ro)
            return attr(scene, ro, *a, **k)

        return counted


def cl_launches():
    """chip_smoke.py's cl_launches, loaded by path."""
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke_cl", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    first = mod.COUNTERS.index("bvh_full")
    return lambda settings, n: mod.cl_launches(settings, n)[first:first + 2]


@pytest.fixture(scope="module")
def frames():
    """FRAMES frames of path CL through both renderers, the sphere turning
    between them. Returns (port renderer, reference renderer, images)."""
    mp = pytest.MonkeyPatch()
    mp.setattr(reproj_ref, "reproj_gather", exact_gather)
    mp.setattr(trace_ref, "traverse_bvh", nearest_walk)
    make_tracer = ref_renderer.make_tracer
    mp.setattr(ref_renderer, "make_tracer",
               lambda *a, **k: CountingTracer(make_tracer(*a, **k)))
    ref_sc = build_city_lamps("hikari_tpu")
    ref_r = hj.Renderer(ref_sc, camera(hj), hj.HikariSettings(),
                        bloom_settings=RefBloom())
    assert ref_r.tracer.kind == "bvh"
    sc = build_city_lamps("hikari_tpu_torch")
    port_r = ht.Renderer(sc, camera(ht), ht.HikariSettings(), device="cpu",
                         bloom_settings=BloomSettings())
    ref_city = city_module("hikari_tpu")
    city = city_module("hikari_tpu_torch")
    images, calls = [], []
    for f in range(FRAMES):
        if f:
            ref_r.update_scene(ref_city.rotate_sphere(ref_sc, angle(f)),
                               fast=True)
            port_r.update_scene(city.rotate_sphere(sc, angle(f)), fast=True)
        ref_r.tracer.counts.clear()
        ref = np.asarray(ref_r.render_frame())
        jax.effects_barrier()
        calls.append((ref_r.tracer.counts["full"],
                      ref_r.tracer.counts["shadow"]))
        got = port_r.render_frame().numpy()
        images.append((got, ref))
    yield port_r, ref_r, images, calls
    mp.undo()


def test_lamp_city_is_the_many_emissive_scene(frames):
    """154 instances, 3,002 triangles, 17 emissives and a 33-node emissive
    BVH on both sides; after the host refits the port's scene arrays equal
    the reference's word for word."""
    port_r, ref_r = frames[:2]
    gpu, ref = port_r.gpu_scene, ref_r.gpu_scene
    assert (gpu.num_instances, gpu.num_triangles, gpu.num_emissives) == (
        154, 3002, 17)
    assert gpu.arrays["em_bvh_packed"].shape == (33, 9)
    assert port_r.tracer.kind == "cull"
    for k in ("tri_pos_flat", "tri_attr", "bvh_packed", "inst_motion",
              "em_packed", "em_bvh_packed", "em_leaf_order"):
        np.testing.assert_array_equal(gpu.arrays[k].view(np.int32),
                                      ref.arrays[k].view(np.int32),
                                      err_msg=k)
    for k, v in gpu.tables.items():
        np.testing.assert_array_equal(port_r.scene_dev[k].numpy(), v,
                                      err_msg=k)


@pytest.mark.parametrize("f", range(FRAMES))
def test_lamp_city_frames_match_reference(frames, f):
    got, ref = frames[2][f]
    assert float(got[..., :3].mean()) > 0.01
    assert_frames_close(got, ref, SIZE)


def test_lamp_city_launches_follow_the_reference_tracer(frames):
    """chip_smoke.py's cl_launches per frame number (kernel 13 full,
    shadow) equal hikari_tpu's tracer calls in the same frames: frame 0
    validates both direct channels, frame 3 the direct one."""
    port_r, calls = frames[0], frames[3]
    launches = cl_launches()
    assert calls == [tuple(launches(port_r.settings, n))
                     for n in range(FRAMES)]
    assert calls[0] != calls[1]


def test_lamp_city_streets_see_several_lamps():
    """The lamps' boxes overlap along the streets: the emissive walk's
    streaming count exceeds 1 at street points, so the pick is a real
    reservoir choice among several emitters."""
    import torch

    from hikari_tpu_torch.ops.sampling import walk_emissive_bvh

    gpu = build_city_lamps("hikari_tpu_torch").compile()
    scene = {k: torch.from_numpy(gpu.arrays[k])
             for k in ("em_packed", "em_bvh_packed", "em_leaf_order")}
    xs = torch.linspace(-14.0, 14.0, 57)
    pos = torch.stack([xs, torch.full_like(xs, 0.01),
                       torch.full_like(xs, 4.0)], -1)
    n = pos.shape[0]
    picked, count = walk_emissive_bvh(scene, pos, torch.full((n,), 0.5),
                                      torch.full((n,), -1, dtype=torch.int32))
    assert (count >= 2).all() and (picked >= 0).all()
    assert int(count.max()) >= 3
