"""hikari_tpu_torch/ops/checkerboard.py against hikari_tpu's: the
selections (compress, expand, active_mask, merge_packed_planes)
bit for bit for both parities at odd and even heights, and reconstruct on
seeded fields with depth and normal edges within 1e-6 * max(|ref|, 1)."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hikari_tpu.ops import checkerboard as ref_ops
from hikari_tpu_torch.ops import checkerboard as ckb
from tests.torch_threads import one_torch_thread  # noqa: F401


def words(x):
    return np.ascontiguousarray(np.asarray(x)).view(np.uint32)


@pytest.mark.parametrize("h", [7, 8])
@pytest.mark.parametrize("par", [0, 1])
def test_selections_match_reference_bit_for_bit(par, h):
    rng = np.random.default_rng(10 * h + par)
    w = 12
    x = rng.normal(size=(h, w, 3)).astype(np.float32)
    c = ckb.compress(torch.from_numpy(x), par)
    np.testing.assert_array_equal(
        words(c.numpy()), words(ref_ops.compress(jnp.asarray(x), jnp.int32(par))))
    a = rng.normal(size=(h, w // 2, 5)).astype(np.float32)
    np.testing.assert_array_equal(
        words(ckb.expand(torch.from_numpy(a), par).numpy()),
        words(ref_ops.expand(jnp.asarray(a), jnp.int32(par))))
    np.testing.assert_array_equal(
        ckb.active_mask(par, (h, w)).numpy(),
        np.asarray(ref_ops.active_mask(jnp.int32(par), (h, w))))
    new = rng.normal(size=(h, 16, w // 2)).astype(np.float32)
    old = rng.normal(size=(h, 16, w)).astype(np.float32)
    np.testing.assert_array_equal(
        words(ckb.merge_packed_planes(torch.from_numpy(new),
                                      torch.from_numpy(old), par).numpy()),
        words(ref_ops.merge_packed_planes(jnp.asarray(new), jnp.asarray(old),
                                          jnp.int32(par))))


@pytest.mark.parametrize("par", [0, 1])
def test_compress_planes_is_compress_of_the_channel_planes(par):
    """The frame compresses the gathered [h,16,w] planes before unpacking;
    that selection equals compress on the channel-last layout."""
    x = torch.from_numpy(np.random.default_rng(par).normal(
        size=(9, 16, 10)).astype(np.float32))
    got = ckb.compress_planes(x, par)
    want = ckb.compress(x.permute(0, 2, 1), par).permute(0, 2, 1)
    assert torch.equal(got, want)


def test_compress_refuses_an_odd_width():
    with pytest.raises(ValueError):
        ckb.compress(torch.zeros((4, 5, 2)), 0)


@pytest.mark.parametrize("par", [0, 1])
def test_reconstruct_matches_reference(par):
    """Seeded fields over a depth step and a normal crease (so every gate
    and the 4-neighbour fallback run), zero depth at the sky."""
    rng = np.random.default_rng(3 + par)
    h, w = 11, 14
    full = rng.random((h, w, 5)).astype(np.float32)
    depth = np.where(np.arange(w)[None, :] < 6, 0.5, 0.9)
    depth = (depth * (1 + 0.02 * rng.random((h, w)))).astype(np.float32)
    depth[:2, :3] = 0.0
    nrm = np.zeros((h, w, 3), np.float32)
    nrm[..., 1] = 1.0
    crease = np.arange(h)[:, None] >= 7
    nrm[crease[:, 0]] = (0.0, 0.0, 1.0)
    nrm += rng.normal(0, 0.05, nrm.shape).astype(np.float32)
    mask = ckb.active_mask(par, (h, w))
    got = ckb.reconstruct(torch.from_numpy(full), mask, torch.from_numpy(depth),
                          torch.from_numpy(nrm)).numpy()
    ref = np.asarray(ref_ops.reconstruct(
        jnp.asarray(full), jnp.asarray(mask.numpy()), jnp.asarray(depth),
        jnp.asarray(nrm)))
    assert (np.abs(got - ref) <= 1e-6 * np.maximum(np.abs(ref), 1.0)).all()
    unlit = ~mask.numpy()
    assert not np.array_equal(got[unlit], full[unlit])
