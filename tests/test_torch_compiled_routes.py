"""The compiled routes beside Renderer's frame, on the CPU (their graphs
are captured and replayed only on CUDA: chip_smoke.py's compiled check
holds the replayed sharded frame and the replayed dissection against
their eager runs word for word).

(a) The sharded frame (parallel/mesh.py ShardedFrame, over 4 gloo ranks
    through tests/torch_dist.py): fed through its static inputs (the
    frame's words staged, the static carry written in place) it equals
    the frame function fed fresh inputs word for word on every rank, with
    the dynamic fields retuned mid-run; two frames of one key, a retune
    between them, dispatch the same operations, collectives included,
    with the same shapes and no read back to the host.
(b) The dissection (Renderer.render_dissection: the debug frame fed
    through the static words, as its graph is captured on CUDA) equals
    the debug frame function called on fresh inputs, planes and carry
    word for word, with a retune between dissections.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import hikari_tpu_torch as ht
from hikari_tpu_torch.camera import view_to_device
from hikari_tpu_torch.config import make_frame_uniform
from hikari_tpu_torch.frame import init_carry
from tests import torch_dist
from tests.cornell_box import EYE, TARGET, build_cornell_box
from tests.torch_threads import one_torch_thread  # noqa: F401

RANKS = 4
# (config, size, frames, modular): the reference default on the modular
# path and on the fused kernels (path M's kernels), 5 frames each
RUNS = (("default", (32, 64), 5, True), ("default", (32, 64), 5, False))
IDS = ["modular", "fused"]


@pytest.fixture(scope="module")
def static_runs(tmp_path_factory):
    return torch_dist.run_ranks("static_against_fresh", RANKS,
                                tmp_path_factory.mktemp("static"), RUNS)


@pytest.mark.parametrize("run", RUNS, ids=IDS)
def test_sharded_static_inputs_equal_fresh_inputs(static_runs, run):
    cfg, size, frames, modular = run
    for r, res in enumerate(static_runs):
        diffs = res[(cfg, size, modular)]
        assert len(diffs) == frames
        for i, bad in enumerate(diffs):
            assert not bad, f"rank {r}, frame {i + 1}: {bad} differ"


@pytest.mark.parametrize("modular", [True, False], ids=IDS)
def test_sharded_one_key_one_trace(tmp_path, modular):
    ranks = torch_dist.run_ranks("sharded_trace", RANKS, tmp_path,
                                 "default", (32, 64), modular)
    for r, res in enumerate(ranks):
        keys = res["keys"]
        assert keys[0] == keys[1] != keys[2], keys
        assert res["same"], (r, res["difference"])
        assert res["other_differs"]
        assert len(res["ops"]) > 100
        assert any(op.startswith("c10d.") for op in res["ops"]), r
        assert not res["host_reads"], (r, res["host_reads"][:5])
    # every rank makes the same all-gathers (the first and last ranks send
    # and receive fewer halo rows)
    gathers = [[op for op in res["ops"] if "allgather" in op]
               for res in ranks]
    assert gathers[0] and all(g == gathers[0] for g in gathers)


def box_camera(i, size):
    d = (0.03 * i, 0.0, 0.0)
    return ht.Camera.from_look_at(tuple(np.add(EYE, d)),
                                  tuple(np.add(TARGET, d)),
                                  width=size[1], height=size[0])


def leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, f"{prefix}{k}/")
    else:
        yield prefix[:-1], tree


def words(t):
    return torch.as_tensor(t).contiguous().view(torch.int32)


def test_dissection_static_words_equal_fresh_inputs():
    """Three dissections of the box at HikariSettings() (frames 0-2, the
    camera panning; the emissive interval retuned to 3 and the clear
    colour changed before the third) through render_dissection against
    the debug frame function on fresh inputs: every plane, the final
    image and every carry leaf word for word."""
    size = (24, 32)
    r = ht.Renderer(build_cornell_box("hikari_tpu_torch"), box_camera(0, size),
                    ht.HikariSettings(), device="cpu")
    settings = r.settings
    carry = init_carry(r.full_size, settings, "cpu")
    for i in range(3):
        if i == 2:
            r.update_settings(emissive_validate_interval=3,
                              clear_color=(0.1, 0.2, 0.3, 1.0),
                              max_indirect_luminance=2.0)
            settings = r.settings
        r.camera = box_camera(i, size)
        got = r.render_dissection()
        view = view_to_device(r.camera.view_uniform(), "cpu")
        if i == 0:
            carry["prev_view_proj"] = view["view_proj"].clone()
            carry["prev_inverse_view_proj"] = (
                view["inverse_view_proj"].clone())
        image, albedo, carry, dbg = r._debug_fn(
            r.scene_dev, view, make_frame_uniform(settings, i), r.noise,
            carry)
        want = {**{k: v.numpy() for k, v in dbg.items()},
                "final": r._post_overlay(image, albedo).numpy()}
        assert set(got) == set(want)
        for k in want:
            assert torch.equal(words(got[k]), words(want[k])), (i, k)
        fresh = dict(leaves(carry))
        for k, v in leaves(r.carry):
            assert torch.equal(words(v), words(fresh[k])), (i, k)
    assert r._frame_index == 3
