"""The mesh helpers of the port's models/mesh.py against hikari_tpu's,
bit for bit: icosphere at several radii and subdivisions,
Mesh.from_triangle_strip (odd windows swap their first two vertices) and
Mesh.local_aabb."""

from __future__ import annotations

import numpy as np
import pytest

from hikari_tpu.models import mesh as mesh_ref
from hikari_tpu_torch.models import mesh
from tests.torch_threads import one_torch_thread  # noqa: F401

FIELDS = ("positions", "normals", "uvs", "indices")


def _bits_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return (a.dtype == b.dtype and a.shape == b.shape
            and np.array_equal(a.view(np.uint8), b.view(np.uint8)))


@pytest.mark.parametrize("radius, subdivisions",
                         [(1.0, 0), (1.0, 2), (0.5, 1), (2.5, 3)])
def test_icosphere_matches_reference(radius, subdivisions):
    got = mesh.icosphere(radius, subdivisions)
    ref = mesh_ref.icosphere(radius, subdivisions)
    for k in FIELDS:
        assert _bits_equal(getattr(got, k), getattr(ref, k)), k
    assert got.num_triangles == 20 * 4 ** subdivisions


def _strip(n, seed):
    g = np.random.default_rng(seed)
    return (g.standard_normal((n, 3)).astype(np.float32),
            g.standard_normal((n, 3)).astype(np.float32),
            g.random((n, 2)).astype(np.float32),
            g.permutation(n).astype(np.uint32))


@pytest.mark.parametrize("n", [3, 4, 9])
def test_triangle_strip_matches_reference(n):
    args = _strip(n, n)
    got = mesh.Mesh.from_triangle_strip(*args)
    ref = mesh_ref.Mesh.from_triangle_strip(*args)
    for k in FIELDS:
        assert _bits_equal(getattr(got, k), getattr(ref, k)), k
    idx = args[3]
    assert got.num_triangles == n - 2
    if n > 3:
        # the second window's winding is flipped
        assert list(got.indices[1]) == [idx[2], idx[1], idx[3]]


@pytest.mark.parametrize("make", ["icosphere", "cube", "strip"])
def test_local_aabb_matches_reference(make):
    if make == "strip":
        got = mesh.Mesh.from_triangle_strip(*_strip(7, 1))
        ref = mesh_ref.Mesh.from_triangle_strip(*_strip(7, 1))
    elif make == "cube":
        got, ref = mesh.cube(2.0), mesh_ref.cube(2.0)
    else:
        got, ref = mesh.icosphere(0.75, 2), mesh_ref.icosphere(0.75, 2)
    for a, b in zip(got.local_aabb(), ref.local_aabb()):
        assert _bits_equal(a, b)
    lo, hi = got.local_aabb()
    assert np.all(lo <= got.positions) and np.all(got.positions <= hi)
