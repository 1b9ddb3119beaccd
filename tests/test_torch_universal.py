"""HikariUniversalSettings and the tracer's brute_force_max in the port,
against hikari_tpu:

* compile_scene(universal=...) gives hikari_tpu's arrays word for word,
  for the box and a city of one wave, with and without the mesh
  acceleration structure (a single-leaf BVH over triangle 0 without it),
  and kernel 13's tables build for each;
* make_tracer's engine at several brute_force_max (brute force up to it,
  kernel 13 above), and the probe's rule (kernel 6 over an emissive table
  of at most brute_force_max rows, else the engine's with_info);
* kernels 5, 6 and 7's plain versions over a 992-row table (above the 768
  rows a block stages at once: the box and a 952-triangle UV sphere)
  against hikari_tpu's Pallas brute force in interpret mode, with
  test_torch_trace.py's rays and bars (ids equal on >= 99.9% of random
  rays, differing only near an edge; floats within 1e-5 * max(|ref|, 1));
* whole frames (SSIM >= 0.98, mean abs diff < 1e-3): the box at
  HikariSettings() with brute_force_max=0 (kernel 13 and the non-fused
  prepass; the reference's CPU walk, kind "bvh", given the nearest-hit
  walk as tests/test_torch_frame_city.py does, and the exact gather), and
  path F's scene compiled without the mesh acceleration structure (1,226
  triangles) with brute_force_max=2048 (kernels 5-7 over the whole table;
  the reference's XLA brute force, kind "brute_force") at the flagship
  settings.
"""

from __future__ import annotations


import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hikari_tpu as hj
import hikari_tpu.ops.reproj_gather as reproj_ref
import hikari_tpu.ops.trace as trace_ref
import hikari_tpu_torch as ht
from examples import city as city_ref
from examples import scene as scene_ref
from hikari_tpu.models import mesh as shapes_ref
from hikari_tpu.models.scene import make_transform
from hikari_tpu.ops import trace_pallas as tp_ref
from hikari_tpu_torch.examples import city, scene
from hikari_tpu_torch.ops import trace as trace_port
from hikari_tpu_torch.ops import trace_pallas as tp
from tests.cornell_box import EYE, TARGET, build_cornell_box
from tests.test_torch_city_scene import NOT_PORTED, _bits_equal
from tests.test_torch_frame import assert_frames_close, exact_gather, flagship
from tests.test_torch_frame_city import nearest_walk
from tests.test_torch_trace import check, near_edge, rays
from tests.torch_threads import one_torch_thread  # noqa: F401

OFF = dict(build_mesh_acceleration_structure=False)


def _scene(name, pkg):
    if name == "box":
        return build_cornell_box(pkg.__name__)
    return (city if pkg is ht else city_ref).build_scene(1)


@pytest.mark.parametrize("bvh", [True, False], ids=["bvh", "no_bvh"])
@pytest.mark.parametrize("name", ["box", "city1"])
def test_compile_universal_matches_reference(name, bvh):
    uni = dict(build_mesh_acceleration_structure=bvh)
    got = _scene(name, ht).compile(ht.HikariUniversalSettings(**uni))
    ref = _scene(name, hj).compile(hj.HikariUniversalSettings(**uni))
    assert set(ref.arrays) - set(got.arrays) <= NOT_PORTED
    assert set(got.arrays) <= set(ref.arrays)
    for k, v in got.arrays.items():
        assert _bits_equal(v, ref.arrays[k]), k
    for k in ("num_triangles", "num_nodes", "num_instances",
              "num_emissives"):
        assert getattr(got, k) == getattr(ref, k), k
    if not bvh:
        assert got.num_nodes == 1
        assert got.arrays["bvh_packed"][0, 6] == 1.0     # one leaf
    tables = got.kernel_tables()
    assert tables["bvh_nodes"].shape == (got.num_nodes, 8)
    assert len(tables["bvh_sub_root"]) == got.num_instances
    # hikari_tpu's compiled arrays carry across with the same tables
    carried = ht.scene_from_arrays(ref.arrays, "cpu")
    for k, v in tables.items():
        assert _bits_equal(carried[k].numpy(), v), k


@pytest.mark.parametrize("n, bfm, kind", [
    (36, None, "brute_force_pallas"), (36, 36, "brute_force_pallas"),
    (36, 35, "cull"), (36, 0, "cull"), (768, None, "brute_force_pallas"),
    (769, None, "cull"), (2618, None, "cull"),
    (2618, 4096, "brute_force_pallas")])
def test_make_tracer_kind(n, bfm, kind):
    kw = {} if bfm is None else dict(brute_force_max=bfm)
    tracer = trace_port.make_tracer(n, **kw)
    assert tracer.kind == kind
    assert tracer.brute_force_max == (768 if bfm is None else bfm)


@pytest.mark.parametrize("bfm, kernel6", [(8, True), (7, False),
                                          (0, False), (768, True)])
def test_probe_rule(monkeypatch, bfm, kernel6):
    """The box's emissive table has 8 rows (2 padded to 8): kernel 6 over
    it at brute_force_max >= 8, else the engine's with_info."""
    r = ht.Renderer(build_cornell_box("hikari_tpu_torch"),
                    ht.Camera.from_look_at(EYE, TARGET, width=8, height=8),
                    brute_force_max=bfm, device="cpu")
    assert r.scene_dev["em_tri_pos_flat"].shape[0] == 8
    calls = []
    monkeypatch.setattr(trace_port, "probe_emissive_table",
                        lambda *a: calls.append("kernel6") or {})
    monkeypatch.setattr(type(r.tracer), "with_info",
                        lambda self, *a: calls.append("with_info") or {})
    n = 4
    ro = torch.zeros((n, 3))
    rd = torch.tensor([[0.0, 1.0, 0.0]]).repeat(n, 1)
    r.tracer.probe_info(r.scene_dev, ro, rd, torch.full((n,), 10.0))
    assert calls == (["kernel6"] if kernel6 else ["with_info"])


def big_table():
    """The box and a 952-triangle UV sphere inside it: 988 triangles in a
    992-row table (hikari_tpu's compile; the port's is the same, above)."""
    sc = build_cornell_box("hikari_tpu")
    sc.spawn(sc.add_mesh(shapes_ref.uv_sphere(0.3, sectors=34, stacks=15)),
             sc.add_material(hj.StandardMaterial.from_color(0.2, 0.4, 0.9)),
             make_transform((0.0, 1.0, -0.3)))
    return sc.compile().arrays


@pytest.fixture(scope="module")
def table():
    arrays = big_table()
    assert arrays["tri_pos_flat"].shape[0] == 992 > tp.CHUNK_ROWS
    return arrays, rays(arrays, "box", 7)


@pytest.mark.parametrize("kind", ["closest", "full", "shadow"])
def test_kernels_plain_match_reference_above_one_chunk(table, kind):
    arrays, (ro, rd, max_t, excl, incl) = table
    tri = arrays["tri_pos_flat"]
    j = [jnp.asarray(x) for x in (ro, rd, max_t, excl, incl)]
    t = [torch.from_numpy(x) for x in (ro, rd, max_t, excl, incl)]
    tri_t = torch.from_numpy(tri)
    if kind == "closest":
        ref = tp_ref.pallas_brute_force(jnp.asarray(tri), *j, interpret=True)
        got = tp.brute_force(tri_t, *t)
        ids, floats = ("prim", "instance"), ("t", "u", "v")
    elif kind == "full":
        ref = tp_ref.pallas_brute_force_full(
            jnp.asarray(tri), jnp.asarray(arrays["tri_attr"]), *j,
            interpret=True)
        got = tp.brute_force_full(tri_t, torch.from_numpy(arrays["tri_attr"]),
                                  *t)
        ids, floats = (("prim", "instance", "material"),
                       ("t", "position", "normal", "uv"))
    else:
        ref = tp_ref.pallas_shadow(jnp.asarray(tri), *j, interpret=True)
        got = tp.shadow(tri_t, *t)
        ids, floats = ("instance",), ("t",)
    got = {k: v.numpy() for k, v in got.items()}
    ref = {k: np.asarray(v) for k, v in ref.items()}
    # the sphere's triangles (past the first chunk) are hit
    sphere = got["instance"] == 8
    assert sphere.mean() > 0.02
    check(got, ref, ids, floats, near_edge(arrays, ro, rd))


# --- whole frames -----------------------------------------------------------

BOX_SIZE = (48, 256)
BOX_FRAMES = 3
F_SIZE = (32, 64)
F_FRAMES = 2


def test_box_with_brute_force_max_zero_matches_reference(monkeypatch):
    """The box at HikariSettings() with brute_force_max=0: the port takes
    kernel 13 (kind "cull"), the non-fused prepass and the modular path,
    and its frames agree with the reference's."""
    from hikari_tpu_torch import frame

    monkeypatch.setattr(reproj_ref, "reproj_gather", exact_gather)
    monkeypatch.setattr(trace_ref, "traverse_bvh", nearest_walk)

    def cam(pkg):
        return pkg.Camera.from_look_at(EYE, TARGET, width=BOX_SIZE[1],
                                       height=BOX_SIZE[0])

    ref_r = hj.Renderer(build_cornell_box("hikari_tpu"), cam(hj),
                        hj.HikariSettings(), brute_force_max=0)
    assert ref_r.tracer.kind == "bvh"
    port_r = ht.Renderer(build_cornell_box("hikari_tpu_torch"), cam(ht),
                         ht.HikariSettings(), brute_force_max=0,
                         device="cpu")
    kind = port_r.tracer.kind
    assert kind == "cull"
    assert not frame.prepass_fused_eligible(port_r.scene_dev,
                                            no_texture=True, tracer_kind=kind)
    assert not frame.fused_eligible(
        port_r.scene_dev, no_texture=True, num_emissives=1,
        temporal_reuse=True, track_de=False, track_ind=False,
        tracer_kind=kind, has_sun=False, bounces=1, ckb=False)
    for _ in range(BOX_FRAMES):
        ref = np.asarray(ref_r.render_frame())
        got = port_r.render_frame().numpy()
        assert float(got[..., :3].mean()) > 0.01
        assert_frames_close(got, ref, BOX_SIZE)


def test_universal_off_scene_with_brute_force_matches_reference():
    """Path F's scene (1,226 triangles) compiled without the mesh
    acceleration structure and rendered with brute_force_max=2048 at the
    flagship settings: both engines brute force over the whole table (the
    single-leaf BVH is never walked), and the frames agree."""
    uni = dict(build_mesh_acceleration_structure=False)

    def cam(pkg):
        return pkg.Camera.from_look_at(scene.EYE, scene.TARGET,
                                       width=F_SIZE[1], height=F_SIZE[0])

    ref_gpu = scene_ref.build_scene().compile(
        hj.HikariUniversalSettings(**uni))
    port_gpu = scene.build_scene().compile(ht.HikariUniversalSettings(**uni))
    assert port_gpu.num_triangles == 1226 and port_gpu.num_nodes == 1
    ref_r = hj.Renderer(ref_gpu, cam(hj), flagship(hj), brute_force_max=2048)
    assert ref_r.tracer.kind == "brute_force"
    port_r = ht.Renderer(port_gpu, cam(ht), flagship(ht),
                         brute_force_max=2048, device="cpu")
    assert port_r.tracer.kind == "brute_force_pallas"
    for _ in range(F_FRAMES):
        ref = np.asarray(ref_r.render_frame())
        got = port_r.render_frame().numpy()
        assert float(got[..., :3].mean()) > 0.01
        assert_frames_close(got, ref, F_SIZE)
