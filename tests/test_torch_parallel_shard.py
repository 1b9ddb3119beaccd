"""The port's row sharding (hikari_tpu_torch/parallel/) on the CPU: four
gloo ranks spawned by tests/torch_dist.py. halo_rows and pad_rows_to
against hikari_tpu's inside a shard_map over make_mesh(4) on the same
arrays, and every kernel's island against the whole call of its plain
version, word for word."""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as P

from hikari_tpu.parallel import shard as jsh
from hikari_tpu.parallel.mesh import make_mesh as jax_mesh
from hikari_tpu_torch.parallel import make_mesh, shard
from tests import torch_dist
from tests.torch_threads import one_torch_thread  # noqa: F401

RANKS = 4


@pytest.mark.skipif(len(jax.devices()) < RANKS, reason="needs 4 devices")
def test_halo_rows_exchanges_neighbor_blocks(tmp_path):
    """The counterpart of hikari_tpu's halo exchange: each rank's block of
    6 rows with 2 rows above and 3 below, zero and replicated edges, on
    axis 0 and axis 1, equals hikari_tpu's halo_rows in a shard_map over
    4 devices; pad_rows_to equals hikari_tpu's edge pad and a constant
    pad of -1 (the gather's)."""
    gen = np.random.default_rng(2)
    x = gen.random((RANKS * 6, 5, 3), np.float32)
    y = gen.random((19, 4), np.float32)
    got = torch_dist.run_ranks("halo_pad", RANKS, tmp_path, x, y, 8)
    mesh = jax_mesh(RANKS)

    def ref(edge, axis):
        spec = P(*([None] * axis + [jsh.AXIS]))
        f = jsh.smap(lambda b: jsh.halo_rows(b, 2, 3, RANKS, axis=axis,
                                             edge=edge),
                     mesh, in_specs=(spec,), out_specs=spec)
        a = x if axis == 0 else x.transpose(1, 0, 2)
        return np.asarray(jax.jit(f)(a))

    for key, edge, axis in (("zero", "zero", 0),
                            ("replicate", "replicate", 0),
                            ("axis1", "zero", 1)):
        whole = np.concatenate([r[key] for r in got], axis)
        np.testing.assert_array_equal(whole, ref(edge, axis), err_msg=key)
    np.testing.assert_array_equal(
        got[0]["edge"], np.asarray(jsh.pad_rows_to(y, 8)[0]))
    np.testing.assert_array_equal(
        got[0]["constant"],
        np.pad(y, ((0, 5), (0, 0)), constant_values=-1.0))
    for r in got[1:]:
        np.testing.assert_array_equal(r["edge"], got[0]["edge"])


def test_make_mesh_needs_a_group_and_a_device(tmp_path):
    """make_mesh raises without an initialised process group, puts rank r
    on cuda:r and raises without CUDA when no device is given (no CPU
    fallback); with device="cpu" it is the CPU mesh."""
    with pytest.raises(RuntimeError, match="process group"):
        make_mesh()
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="CUDA"):
                make_mesh()
        with pytest.raises(ValueError):
            make_mesh(2, device="cpu")
        mesh = make_mesh(1, device="cpu")
        assert (mesh.rank, mesh.n, mesh.device.type, mesh.backend,
                mesh.staged) == (0, 1, "cpu", "gloo", False)
    finally:
        dist.destroy_process_group()


def test_local_rows_and_gather_rows_round_trip(tmp_path):
    """A one-rank mesh: local_rows pads a short block (edge, constant) and
    gather_rows returns mixed dtypes and row axes whole."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        mesh = make_mesh(1, device="cpu")
        x = torch.arange(12.0).reshape(3, 4)
        np.testing.assert_array_equal(
            shard.local_rows(x, mesh, 5, mode="edge")[3:].numpy(),
            np.stack([x[2].numpy()] * 2))
        assert (shard.local_rows(x, mesh, 5, value=-1.0)[3:] == -1).all()
        b = torch.arange(24, dtype=torch.bfloat16).reshape(2, 3, 4)
        i = torch.arange(6, dtype=torch.int32).reshape(3, 2)
        got = shard.gather_rows([b, i], mesh, 2, axes=[1, 0])
        assert torch.equal(got[0], b[:, :2]) and got[0].is_contiguous()
        assert torch.equal(got[1], i[:2])
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def island_results(tmp_path_factory):
    return torch_dist.run_ranks("islands", RANKS,
                                tmp_path_factory.mktemp("islands"),
                                list(torch_dist.ISLANDS))


@pytest.mark.parametrize("case", list(torch_dist.ISLANDS))
def test_island_equals_whole_call(island_results, case):
    """Each kernel's island over 4 ranks against the whole call of the
    same plain version, word for word on every rank: A at both parities
    (its decimated planes and kernel 8's quads), B and 4 (the sun and the
    bounce), C at 42 rows (4 ranks do not divide them) on test_parallel's
    flat geometry, 9 with motion inside the 16-row halo, 11 in TAA's form
    and 12 in SMAA's (2:1 rows) and with a column-offset bilinear
    reduce."""
    assert [r[case] for r in island_results] == [True] * RANKS


def test_islands_pass_each_rank_its_rows(tmp_path):
    """Kernel A's and kernel C's launches on each of 4 ranks, their CUDA
    branches taken with a recording stand-in for the library, at 42x24:
    kernel A traces rank r's block of 12 rows (twice the 6 of the
    half-size planes) from image row 12 r; each kernel C level filters
    rank r's block of 16 rows (2 * 8 at least, single-hop halos) with 16
    halo rows each side, 48 rows from image row 16 r - 16 of 42."""
    from hikari_tpu_torch.ops import prepass_fused

    got = torch_dist.run_ranks("fake_row_launches", RANKS, tmp_path,
                               (42, 24))
    hl = prepass_fused.block_rows(42, RANKS)
    assert hl == 12
    for r, calls in enumerate(got):
        assert calls[0] == ("hk_prepass_fused", hl, 24, r * hl)
        assert calls[1:] == [("hk_atrous_level", 48, 24, 16 * r - 16,
                              42)] * 4
