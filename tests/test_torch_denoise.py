"""Kernel C's plain version (hikari_tpu_torch.ops.denoise_fused) against
hikari_tpu's fused Pallas a-trous level in interpret mode, on identical
bf16 stacks; and the whole denoise_channels against hikari_tpu's."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from ml_dtypes import bfloat16

from hikari_tpu.ops.denoise import denoise_channels as denoise_ref
from hikari_tpu.ops.denoise_fused import atrous_level as atrous_ref
from hikari_tpu_torch.ops.denoise import denoise_channels
from hikari_tpu_torch.ops.denoise_fused import atrous_level
from tests.torch_threads import one_torch_thread  # noqa: F401

H, W = 32, 128   # the Pallas level takes rows in blocks of 16


def _stacks(nch, seed):
    """bf16 irradiance/geometry stacks and f32 planes, with NaN/inf taps,
    fireflies and several instances."""
    rng = np.random.default_rng(seed)
    irr = rng.uniform(0.0, 3.0, size=(3 * nch, H, W)).astype(np.float32)
    irr[0, 1, 1] = np.nan
    irr[1, 4, 7] = np.inf
    irr[:, 6, 11] = 400.0
    geo = np.concatenate([
        (rng.normal(size=(2, H, W)) * 0.01).astype(np.float32),
        (1.0 / (4.0 * rng.uniform(0.0, 0.5, size=(nch, H, W)) ** 0.25
                + 1e-3)).astype(np.float32)])
    n = rng.normal(size=(3, H, W)).astype(np.float32)
    n /= np.linalg.norm(n, axis=0, keepdims=True)
    f32s = np.concatenate([
        rng.uniform(0.05, 1.0, size=(1, H, W)).astype(np.float32),
        rng.integers(0, 3, size=(1, H, W)).astype(np.float32) + 0.5,
        n]).astype(np.float32)
    return irr.astype(bfloat16), geo.astype(bfloat16), f32s


def _bf16_torch(a):
    return torch.from_numpy(np.array(a).view(np.int16)).view(torch.bfloat16)


def _ulps(a, b):
    """bf16 ulp distance of two bf16 numpy arrays (NaN-free)."""
    def ordered(x):
        bits = x.view(np.int16).astype(np.int32)
        return np.where(bits < 0, -(bits & 0x7FFF), bits)

    return np.abs(ordered(a) - ordered(b))


@pytest.mark.parametrize("nch,ffs", [(1, (True,)), (2, (False, True)),
                                     (3, (True, False, True))])
def test_atrous_levels_match_pallas(nch, ffs):
    """<= 1 bf16 ulp on >= 99.9% of values and max abs < 0.05 at every
    level (exp and division round differently on the two CPU stacks)."""
    irr, geo, f32s = _stacks(nch, seed=nch)
    for step in (8, 4, 2, 1):
        ref = np.asarray(atrous_ref(
            jnp.asarray(irr), jnp.asarray(geo), jnp.asarray(f32s), step=step,
            nch=nch, ffs=ffs, size=(H, W), interpret=True))
        got = atrous_level(_bf16_torch(irr), _bf16_torch(geo),
                           torch.from_numpy(f32s), step=step, nch=nch,
                           ffs=ffs)
        got = got.view(torch.int16).numpy().view(bfloat16)
        assert np.isfinite(got.astype(np.float32)).all()
        ulps = _ulps(got, ref)
        assert (ulps <= 1).mean() >= 0.999, (step, (ulps <= 1).mean())
        diff = np.abs(got.astype(np.float32) - ref.astype(np.float32))
        assert diff.max() < 0.05, (step, diff.max())
        irr = ref


def _denoise_inputs(seed):
    rng = np.random.default_rng(seed)
    h, w = 24, 64
    n = rng.normal(size=(h, w, 3)).astype(np.float32)
    depth = rng.uniform(0.05, 1.0, size=(h, w)).astype(np.float32)
    depth[2, 3] = 0.0
    g = {
        "position": np.concatenate(
            [rng.normal(size=(h, w, 3)), depth[..., None]], -1).astype(
                np.float32),
        "normal": n,
        "depth_gradient": (rng.normal(size=(h, w, 2)) * 0.01).astype(
            np.float32),
        "instance_material": np.stack(
            [rng.integers(0, 4, size=(h, w)) + 0.5, np.zeros((h, w))],
            -1).astype(np.float32),
    }
    albedo = rng.uniform(0.05, 1.0, size=(h, w, 4)).astype(np.float32)
    chans = [(rng.uniform(0.0, 3.0, size=(h, w, 4)).astype(np.float32),
              rng.uniform(0.0, 0.5, size=(h, w)).astype(np.float32), ff)
             for ff in (False, True)]
    return g, albedo, chans, (h, w), rng


def _check_denoise(g, albedo, chans, size):
    h, w = size
    ref = denoise_ref(jax.tree.map(jnp.asarray, g), jnp.asarray(albedo),
                      [(jnp.asarray(r), jnp.asarray(v), f)
                       for r, v, f in chans],
                      {"number": jnp.uint32(3)}, (h, w), 1.0, fused=True)
    got = denoise_channels({k: torch.from_numpy(v) for k, v in g.items()},
                           torch.from_numpy(albedo),
                           [(torch.from_numpy(r), torch.from_numpy(v), f)
                            for r, v, f in chans],
                           {"number": 3}, (h, w), 1.0)
    for a, b in zip(got, ref):
        diff = np.abs(a.numpy() - np.asarray(b))
        assert np.isfinite(a.numpy()).all()
        assert diff.max() < 0.05 and diff.mean() < 1e-3, (diff.max(),
                                                           diff.mean())


def test_denoise_channels_matches_reference():
    """Demodulation + the 4-level cascade + remodulation, two channels."""
    g, albedo, chans, size, _ = _denoise_inputs(5)
    _check_denoise(g, albedo, chans, size)


def test_denoise_channels_with_variance_matches_reference():
    """The same with the variance the reuse paths give the denoiser:
    seeded, non-zero, up to the cap of 10, with NaN and values beyond the
    float32 range (inf), which the 3x3 prefilter must skip (the luminance
    weight of every level reads it)."""
    g, albedo, chans, size, rng = _denoise_inputs(6)
    out = []
    for render, _, ff in chans:
        var = rng.uniform(0.0, 10.0, size=size).astype(np.float32)
        var[rng.uniform(size=size) < 0.05] = np.nan
        var[rng.uniform(size=size) < 0.05] = np.float32(np.inf)
        var[rng.uniform(size=size) < 0.02] = -1.0
        out.append((render, var, ff))
    _check_denoise(g, albedo, out, size)
