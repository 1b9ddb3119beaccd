"""Kernel 10's plain version (hikari_tpu_torch.ops.spatial_fused) against
hikari_tpu's fused spatial Pallas kernel in interpret mode, for the
emissive and the indirect channel, on the inputs of
tests/test_spatial_fused.py: this frame's temporal reservoirs from the
modular channel, and a previous spatial buffer that is those reservoirs
shifted by a few pixels, or empty (the first frame).

The lifetime gate: "off" disables the expiry (max_reservoir_lifetime 1);
"on" gives the temporal reservoirs seeded lifetimes 0..4 against a limit
of 2, so the start reservoir is the previous spatial one on some pixels
and the temporal one on others."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hikari_tpu.ops import reservoir as rsv_ref
from hikari_tpu.ops.spatial_fused import spatial_fused as spatial_ref
from hikari_tpu_torch import scene_from_arrays
from hikari_tpu_torch.camera import view_to_device
from hikari_tpu_torch.config import frame_uniform_from_jax
from hikari_tpu_torch.ops import reservoir as rsv
from hikari_tpu_torch.ops.spatial_fused import spatial_fused, tap_offsets
from hikari_tpu.utils.math import random_float as random_float_ref
from hikari_tpu_torch.utils.math import random_float
from tests.test_light_fused import _assert_close
from tests.test_spatial_fused import (SIZE, _ctx, _prev_spatial,
                                      _temporal_reservoir)
from tests.torch_threads import one_torch_thread  # noqa: F401


def _inputs(emissive_lit, prev_kind, gate):
    gpu, scene, tracer, view, frame, g, rand = _ctx()
    temporal_r, reproj = _temporal_reservoir(gpu, scene, tracer, view, frame,
                                             g, rand, emissive_lit)
    temporal = torch.from_numpy(np.array(
        rsv_ref.pack_reservoir_planes(temporal_r)))
    frame = dict(frame)
    if gate:
        f = rsv.unpack_fields(temporal)
        rng = np.random.default_rng(11)
        f["life"] = torch.from_numpy(
            rng.integers(0, 5, size=SIZE).astype(np.float32))
        temporal = rsv.pack_fields(f)
        frame["max_reservoir_lifetime"] = jnp.float32(2.0)
    else:
        frame["max_reservoir_lifetime"] = jnp.float32(1.0)
    if prev_kind == "empty":
        prev = torch.zeros((SIZE[0], 16, SIZE[1]))
    else:
        packed = _prev_spatial(temporal_r, (3, 5))
        gathered = rsv_ref.gather_reservoir_packed(
            packed, reproj["piy"], reproj["pix"], reproj["in_strict"])
        prev = torch.from_numpy(np.array(
            rsv_ref.pack_reservoir_planes(gathered)))
    return gpu, scene, view, frame, g, temporal, prev


@pytest.mark.parametrize("gate", [False, True], ids=["gate_off", "gate_on"])
@pytest.mark.parametrize("prev_kind", ["shifted", "empty"])
@pytest.mark.parametrize("emissive_lit", [True, False],
                         ids=["emissive", "indirect"])
def test_spatial_matches_pallas(emissive_lit, prev_kind, gate):
    gpu, scene, view, frame, g, temporal, prev = _inputs(
        emissive_lit, prev_kind, gate)
    ref = spatial_ref(scene, g, view, frame, jnp.asarray(temporal.numpy()),
                      jnp.asarray(prev.numpy()), emissive_lit=emissive_lit,
                      render_size=SIZE, interpret=True)
    view_t = view_to_device({k: np.asarray(v) for k, v in view.items()},
                            "cpu")
    got = spatial_fused(
        scene_from_arrays(gpu.arrays, "cpu"),
        {k: torch.from_numpy(np.array(v)) for k, v in g.items()}, view_t,
        frame_uniform_from_jax(frame), temporal, prev,
        emissive_lit=emissive_lit, render_size=SIZE)
    _assert_close("render", got["render"].numpy(), np.asarray(ref["render"]))
    # variance: NaN exactly where hikari_tpu's is, close elsewhere
    gv, rv = got["variance"].numpy(), np.asarray(ref["variance"])
    assert (np.isnan(gv) == np.isnan(rv)).mean() >= 0.99
    both = ~np.isnan(gv) & ~np.isnan(rv)
    _assert_close("variance", gv[both], rv[both])
    # carry: each unpacked field within rtol 1e-2 / atol 1e-3 (one bf16
    # step is 0.4-0.8%) on >= 99% of pixels
    fg = rsv.unpack_fields(got["spatial_planes"])
    fr = rsv.unpack_fields(torch.from_numpy(np.array(
        ref["spatial_planes"])))
    for k in fr:
        ok = np.isclose(fg[k].numpy(), fr[k].numpy(), rtol=1e-2, atol=1e-3)
        assert ok.mean() >= 0.99, (k, ok.mean())


def test_tap_offsets_follow_the_frame_rotation():
    """The host's spiral rotation is hikari_tpu's random_float, and every
    tap offset lies within the channel's range."""
    for n in (0, 1, 5, 123456):
        assert random_float(n) == np.asarray(
            random_float_ref(jnp.asarray([n], jnp.uint32)))[0]
    for taps, rng_ in ((8, 10), (16, 20)):
        for oy, ox, steps in tap_offsets(taps, rng_, 7):
            assert oy * oy + ox * ox <= (rng_ + 1) ** 2
            for toy, tox, frac in steps:
                assert abs(toy) <= abs(oy) + 1 and abs(tox) <= abs(ox) + 1
                assert 0.0 < frac < 1.0
