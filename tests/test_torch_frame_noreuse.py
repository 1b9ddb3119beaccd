"""The flagship frame (bench.py's settings, no reuse) on the scenes that
take the modular lighting path: hikari_tpu_torch.Renderer on the CPU (the
plain versions of its kernels) against hikari_tpu.Renderer, three frames
at 32x128, static camera:

* the box plus a uv_sphere (1,260 triangles, above the fused kernels'
  768): the non-fused prepass and hikari_tpu's no-reuse specializations
  of direct_lit / indirect_lit_ambient over kernel 13's plain walk;
  hikari_tpu takes its CPU walk without the any-hit early exit
  (tests/test_torch_frame_city.py nearest_walk);
* the box with a seeded texture on its red wall (the fused kernels fetch
  no textures): the same branches over kernels 5, 6 and 7's plain
  versions and kernel 14's; hikari_tpu takes its Pallas engine in
  interpret mode (tests/test_torch_modular.py PallasTracer) and its
  compiled arrays without the bf16 atlas layouts
  (tests/test_torch_texture.py reference_arrays).

Bars: each frame SSIM >= 0.98 and mean abs diff < 1e-3."""

from __future__ import annotations

import functools

import numpy as np
import pytest

import hikari_tpu as hj
import hikari_tpu.ops.trace as trace_ref
import hikari_tpu.renderer as renderer_ref
import hikari_tpu_torch as ht
from tests.cornell_box import EYE, TARGET
from tests.test_torch_frame import assert_frames_close, flagship
from tests.test_torch_frame_city import nearest_walk
from tests.test_torch_modular import PallasTracer
from tests.test_torch_modular_noreuse import textured
from tests.test_torch_texture import reference_arrays
from tests.torch_threads import one_torch_thread  # noqa: F401

SIZE = (32, 128)
FRAMES = 3


def box_sphere(pkg):
    """The box plus a default uv_sphere (tests/test_torch_boundary.py
    _with_sphere), as a Scene of `pkg`."""
    import importlib

    from tests.cornell_box import build_cornell_box

    shapes = importlib.import_module(f"{pkg}.models.mesh")
    scene = importlib.import_module(f"{pkg}.models.scene")
    sc = build_cornell_box(pkg)
    sc.spawn(sc.add_mesh(shapes.uv_sphere()), 0,
             scene.make_transform((0.0, 0.3, 0.0), scale=(0.2, 0.2, 0.2)))
    return sc


# scene builder, the port's tracer kind (which picks the reference's)
CASES = {
    "box_sphere": (box_sphere, "cull"),
    "textured_box": (functools.partial(textured, sun=False),
                     "brute_force_pallas"),
}


def camera(pkg):
    return pkg.Camera.from_look_at(EYE, TARGET, width=SIZE[1],
                                   height=SIZE[0])


@pytest.fixture(scope="module", params=sorted(CASES))
def frames(request):
    """FRAMES frames of one case through both renderers. Returns (case,
    port renderer, images)."""
    build, kind = CASES[request.param]
    mp = pytest.MonkeyPatch()
    if kind == "cull":
        mp.setattr(trace_ref, "traverse_bvh", nearest_walk)
    else:
        mp.setattr(renderer_ref, "make_tracer",
                   lambda n, **kw: PallasTracer())
    try:
        ref = build("hikari_tpu").compile()
        ref.arrays = reference_arrays(ref)
        ref_r = hj.Renderer(ref, camera(hj), flagship(hj))
        port_r = ht.Renderer(build("hikari_tpu_torch"), camera(ht),
                             flagship(ht), device="cpu")
        assert port_r.tracer.kind == kind
        images = [(port_r.render_frame().numpy(),
                   np.asarray(ref_r.render_frame())) for _ in range(FRAMES)]
    finally:
        mp.undo()
    return request.param, port_r, images


def test_modular_path_without_reuse_is_taken(frames):
    """Neither fused lighting kernel serves these scenes (their gates):
    the frame takes the modular path, and carries no reservoirs."""
    from hikari_tpu_torch import frame

    _, port_r, _ = frames
    g = port_r.gpu_scene
    assert not frame.fused_eligible(
        port_r.scene_dev, no_texture=g.num_textures == 0,
        num_emissives=g.num_emissives, temporal_reuse=False, track_de=False,
        track_ind=False, tracer_kind=port_r.tracer.kind, has_sun=g.has_sun,
        bounces=1, ckb=False)
    assert set(port_r.carry) == {"prev_view_proj", "prev_inverse_view_proj"}


@pytest.mark.parametrize("f", range(FRAMES))
def test_noreuse_frames_match_reference(frames, f):
    case, _, images = frames
    got, ref = images[f]
    assert float(got[..., :3].mean()) > 0.01, case
    assert_frames_close(got, ref, SIZE)
