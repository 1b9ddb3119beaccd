"""The port's 64 B reservoir layout (hikari_tpu_torch.ops.reservoir)
against hikari_tpu.ops.reservoir, bit for bit: seeded random reservoirs
with unorm values outside [0, 1], bf16 rounding ties, lifetimes beyond
255, and every unpacked field of arbitrary packed words."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hikari_tpu.ops import reservoir as ref
from hikari_tpu.ops.light_fused import _unpack_take
from hikari_tpu_torch.ops import reservoir as rsv
from tests.torch_threads import one_torch_thread  # noqa: F401

SIZE = (12, 40)


def _ties(rng, shape):
    """float32 values whose low 16 bits are exactly half a bf16 step, with
    both parities of the kept bit (round-to-nearest-even's ties)."""
    hi = rng.integers(0x3C00, 0x4400, size=shape).astype(np.uint32)
    return ((hi << 16) | 0x8000).view(np.float32)


def _random_reservoir(seed):
    rng = np.random.default_rng(seed)
    h, w = SIZE

    def f(*c, lo=-2.0, hi=2.0):
        return rng.uniform(lo, hi, size=(h, w) + c).astype(np.float32)

    r = {
        "radiance": f(4, lo=0.0, hi=50.0),
        "random": f(4, lo=-0.5, hi=1.5),
        "visible_position": f(4, lo=-5.0, hi=5.0),
        "visible_normal": f(3, lo=-1.5, hi=1.5),
        "visible_instance": rng.integers(-1, 20, size=(h, w)).astype(
            np.int32),
        "sample_position": f(4, lo=-5.0, hi=5.0),
        "sample_normal": f(3, lo=-1.5, hi=1.5),
        "count": f(lo=0.0, hi=900.0),
        "lifetime": rng.integers(0, 400, size=(h, w)).astype(np.float32),
        "w": f(lo=0.0, hi=10.0),
        "w_sum": f(lo=0.0, hi=100.0),
        "w2_sum": f(lo=0.0, hi=1e4),
    }
    r["sample_position"][..., 3] = rng.integers(0, 2, size=(h, w))
    # bf16 ties in every bf16 field, and unorm16 ties k + 0.5 steps
    mask = rng.uniform(size=(h, w)) < 0.3
    for k in ("count", "w", "w_sum", "w2_sum"):
        r[k] = np.where(mask, _ties(rng, (h, w)), r[k])
    r["radiance"] = np.where(mask[..., None], _ties(rng, (h, w, 4)),
                             r["radiance"])
    k16 = rng.integers(0, 65535, size=(h, w, 4))
    r["random"] = np.where(
        mask[..., None], ((k16 + 0.5) / 65535.0).astype(np.float32),
        r["random"])
    return r


def _bits(a):
    return np.asarray(a).view(np.uint32) if np.asarray(a).dtype == \
        np.float32 else np.asarray(a)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pack_matches_reference_bit_for_bit(seed):
    r = _random_reservoir(seed)
    want = np.asarray(ref.pack_reservoir_planes(
        {k: jnp.asarray(v) for k, v in r.items()}))
    got = rsv.pack_reservoir_planes(
        {k: torch.from_numpy(v) for k, v in r.items()}).numpy()
    assert got.shape == (SIZE[0], 16, SIZE[1])
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def _random_words(seed):
    """Packed planes of arbitrary words: finite bf16 halves in the bf16
    planes, any u32 in the unorm/snorm planes."""
    rng = np.random.default_rng(seed)
    h, w = SIZE
    t = rng.normal(size=(h, 16, w)).astype(np.float32) * 10.0
    words = rng.integers(0, 2 ** 32, size=(h, 16, w), dtype=np.uint64)
    t.view(np.uint32)[:, 10:14] = words[:, 10:14].astype(np.uint32)
    half = rng.integers(0, 0x7F00, size=(h, 4, w, 2)).astype(np.uint32)
    half |= rng.integers(0, 2, size=half.shape).astype(np.uint32) << 15
    bf = half[..., 0] | (half[..., 1] << 16)
    for i, c in enumerate((8, 9, 14, 15)):
        t.view(np.uint32)[:, c] = bf[:, i]
    return t


@pytest.mark.parametrize("seed", [3, 4])
def test_unpack_matches_reference_bit_for_bit(seed):
    t = _random_words(seed)
    want = ref.unpack_reservoir_planes(jnp.asarray(t))
    got = rsv.unpack_reservoir_planes(torch.from_numpy(t))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(_bits(got[k].numpy()),
                                      _bits(np.asarray(want[k])), err_msg=k)
    # the kernels' flat field form (light_fused._unpack_take)
    want_f = _unpack_take(lambda i: jnp.asarray(t)[:, i, :])
    got_f = rsv.unpack_fields(torch.from_numpy(t))
    assert set(got_f) == set(want_f)
    for k in want_f:
        np.testing.assert_array_equal(_bits(got_f[k].numpy()),
                                      _bits(np.asarray(want_f[k])),
                                      err_msg=k)


def test_round_trip_and_empty():
    """pack(unpack(pack(r))) == pack(r), and the empty reservoir packs as
    hikari_tpu's (visible instance -1, mid-scale snorm8 normals)."""
    r = _random_reservoir(5)
    p = rsv.pack_reservoir_planes({k: torch.from_numpy(v)
                                   for k, v in r.items()})
    again = rsv.pack_reservoir_planes(rsv.unpack_reservoir_planes(p))
    assert torch.equal(again.view(torch.int32), p.view(torch.int32))
    again = rsv.pack_fields(rsv.unpack_fields(p))
    assert torch.equal(again.view(torch.int32), p.view(torch.int32))
    want = np.asarray(ref.pack_reservoir_planes(ref.empty_reservoir(SIZE)))
    got = rsv.pack_reservoir_planes(rsv.empty_reservoir(SIZE)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
