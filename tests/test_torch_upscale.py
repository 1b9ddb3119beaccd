"""Upscaling at every ratio in [1, 2]: the port's index maps, its
jittered-deferred resample (ops/restir.py) and SMAA's parity samplers
(ops/smaa.py) against hikari_tpu's, bit for bit (the post chains at these
ratios: tests/test_torch_post_upscale.py).

hikari_tpu computes three index maps with a Python float, which JAX's
weak typing rounds to float32: resample_deferred's (truncated toward
zero, restir.py:117-119), _parity_sample_generic's (floored,
smaa.py:90-97) and EASU's (fsr.py:33-40). An index one off moves whole
pixels, so the maps are compared bit for bit, both as the reference's
expressions (copied below from those lines) and through the reference's
functions on images whose values encode their own coordinates.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hikari_tpu.ops import restir as restir_ref
from hikari_tpu.ops import smaa as smaa_ref
from hikari_tpu_torch.frame import scaled_size
from hikari_tpu_torch.ops import fsr, restir, smaa
from tests.torch_threads import one_torch_thread  # noqa: F401

RATIOS = [1.0, 1.3, 1.5, 1.7, 2.0]
# an even size, an odd one, and one whose halves are not whole
SIZES = [(48, 64), (45, 77), (31, 130)]


def _ref_deferred_index(n, n_full, number, ratio):
    """restir.py:116-119, one axis."""
    sign = jnp.where((jnp.uint32(number) & 1) == 0, -0.25, 0.25)
    return np.asarray(jnp.clip((((jnp.arange(n) + 0.5) * ratio) + sign)
                               .astype(jnp.int32), 0, n_full - 1))


def _ref_generic_index(n, n_full, j, k):
    """smaa.py:90-97, one axis (h = n, H = n_full, oh = 2n)."""
    return np.asarray(jnp.clip(jnp.floor(
        (2.0 * jnp.arange(n) + j + k + 0.5) * (n_full / (2 * n))
    ).astype(jnp.int32), 0, n_full - 1))


def _ref_easu_coords(n_out, n_in):
    """fsr.py:31-40, one axis."""
    u = jnp.arange(n_out, dtype=jnp.float32)
    pp = (u + 0.5) * (n_in / n_out) - 0.5
    fp = jnp.floor(pp)
    return np.asarray(fp.astype(jnp.int32)), np.asarray(pp - fp)


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("ratio", RATIOS)
def test_index_maps_match_reference_bit_for_bit(ratio, size):
    """The three float32 index maps along both axes: the resample's for
    both frame parities, SMAA's generic one for both parities and every
    tap offset SMAA reads (-3..3), EASU's index and fraction."""
    render = scaled_size(size, ratio)
    for n, n_full in zip(render, size):
        for number in (0, 1):
            np.testing.assert_array_equal(
                restir.deferred_index(n, n_full, number, ratio).numpy(),
                _ref_deferred_index(n, n_full, number, ratio))
        for j in (0, 1):
            for k in range(-3, 4):
                np.testing.assert_array_equal(
                    smaa.generic_index(n, n_full, j, k).numpy(),
                    _ref_generic_index(n, n_full, j, k))
        idx, frac = fsr.easu_coords(n_full, n)
        ref_idx, ref_frac = _ref_easu_coords(n_full, n)
        np.testing.assert_array_equal(idx.numpy(), ref_idx)
        np.testing.assert_array_equal(frac.numpy().view(np.uint32),
                                      ref_frac.view(np.uint32))


def _coords_image(size, extra=0):
    """[H, W, 2 + extra]: y, x (exact in float32), then seeded noise."""
    h, w = size
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    noise = np.random.default_rng(h * w).uniform(-1.0, 1.0, (h, w, extra))
    return np.concatenate([yy[..., None], xx[..., None], noise],
                          -1).astype(np.float32)


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("ratio", RATIOS)
def test_resample_deferred_matches_reference_bit_for_bit(ratio, size):
    """resample_deferred on both frame parities, and resample_gbuffer on a
    G-buffer of three planes (the reference concatenates them)."""
    render = scaled_size(size, ratio)
    img = _coords_image(size, 3)
    for number in (0, 1, 6):
        got = restir.resample_deferred(torch.from_numpy(img), render, number,
                                       ratio).numpy()
        ref = np.asarray(restir_ref.resample_deferred(
            jnp.asarray(img), render, jnp.uint32(number), ratio))
        assert got.shape == tuple(render) + (5,)
        np.testing.assert_array_equal(got.view(np.uint32),
                                      ref.view(np.uint32))
    gbuf = {"a": img[..., :2], "b": img[..., 2:4], "c": img[..., 4:]}
    got = restir.resample_gbuffer({k: torch.from_numpy(v)
                                   for k, v in gbuf.items()}, render, 3,
                                  ratio)
    ref = restir_ref.resample_gbuffer({k: jnp.asarray(v)
                                       for k, v in gbuf.items()}, render,
                                      jnp.uint32(3), ratio)
    for k in gbuf:
        np.testing.assert_array_equal(got[k].numpy().view(np.uint32),
                                      np.asarray(ref[k]).view(np.uint32))


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("ratio", RATIOS)
def test_parity_samplers_match_reference_bit_for_bit(ratio, size):
    """SMAA's reads of the G-buffer at output coords 2c + parity + k:
    _parity_sample (static offsets where the G-buffer is the render size
    or twice it, else _parity_sample_generic) against sample_full, and
    _parity_sample_ctx over _parity_ctx against parity_sample over
    parity_context (quads at an exact half, else direct), for both
    parities and every offset SMAA reads."""
    render = scaled_size(size, ratio)
    img = _coords_image(size, 2)
    gbuf = {"position": img[..., [2, 3, 0, 1]],
            "velocity_uv": img[..., [1, 0, 2, 3]],
            "instance_material": img[..., [0, 1]]}
    ctx = smaa.parity_context({k: torch.from_numpy(v)
                               for k, v in gbuf.items()}, render)
    exact_half = size == (2 * render[0], 2 * render[1])
    assert isinstance(ctx, smaa.Direct) != exact_half
    ref_ctx = smaa_ref._parity_ctx(jnp.asarray(gbuf["position"][..., 3:4]),
                                   render)
    assert ref_ctx[0] == ("quad" if exact_half else "direct")
    for parity in (0, 1):
        for ky, kx in ((0, 0), (1, 1), (-1, 1), (-3, 2), (3, -3), (2, 0)):
            got = smaa.sample_full(torch.from_numpy(img), parity, render,
                                   ky, kx).numpy()
            ref = np.asarray(smaa_ref._parity_sample(
                jnp.asarray(img), jnp.int32(parity), render, ky, kx))
            np.testing.assert_array_equal(got.view(np.uint32),
                                          ref.view(np.uint32))
            got = smaa.parity_sample(ctx, "depth", parity, ky, kx).numpy()
            ref = np.asarray(smaa_ref._parity_sample_ctx(
                ref_ctx, jnp.int32(parity), render, ky, kx))[..., 0]
            np.testing.assert_array_equal(got.view(np.uint32),
                                          ref.view(np.uint32))
    generic = smaa_ref._parity_sample_generic(jnp.asarray(img),
                                              jnp.int32(1), render, 1, -1)
    if size[0] not in (render[0], 2 * render[0]):
        np.testing.assert_array_equal(
            smaa.sample_full(torch.from_numpy(img), 1, render, 1,
                             -1).numpy(), np.asarray(generic))
