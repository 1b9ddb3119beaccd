"""Kernel A's launch path and the arithmetic of its redesign, on the CPU.

* The launch path (csrc/prepass_fused.cu hk_prepass_fused) with a fake
  library standing in for the built one: the argument table, the outputs
  the wrapper allocates, and bad calls raising before a launch.
* The kernel's triangle test in numpy float32, one operation at a time:
  the per-frame constants it stages for rays from the camera (ab, ac,
  ao = o - v0, v = ao x ab, num = ac . v) give the same words as
  mt_terms' order, and its sign skip (num and det of one strict sign,
  |det| >= eps, before the division) never rejects a triangle the full
  test accepts, on random triangles, degenerate rows and the edge values
  of det and num.
"""

from __future__ import annotations

import ctypes

import numpy as np
import pytest
import torch

from hikari_tpu_torch import build
from hikari_tpu_torch.ops import prepass_fused
from hikari_tpu_torch.ops.trace_pallas import mt_terms
from tests.test_torch_boundary import _FakeLibrary
from tests.torch_threads import one_torch_thread  # noqa: F401

F32 = np.float32
EPS = F32(1.1920929e-7)
F32_MAX = F32(3.402823466e38)
SIG = ("params", "tris", "attrs", "n_tris", "motion", "n_inst", "mats",
       "n_mats", "h", "w", "position", "normal", "inst_mat", "vel_uv",
       "albedo", "stream")


@pytest.fixture
def fake(monkeypatch):
    lib = _FakeLibrary()
    monkeypatch.setattr(build, "load_cuda", lambda name: lib)
    monkeypatch.setattr(prepass_fused, "on_cpu", lambda t: False)
    monkeypatch.setattr(prepass_fused, "stream",
                        lambda dev: ctypes.c_void_p(0))
    monkeypatch.setattr(prepass_fused.prepass_kernel, "launches", 0)
    return lib


def _args(n_tris=40, n_inst=3, n_mats=5, size=(6, 10)):
    return (torch.zeros(prepass_fused._P_COUNT), torch.zeros((n_tris, 10)),
            torch.zeros((n_tris, 17)), torch.zeros((n_inst, 16)),
            torch.zeros((n_mats, 15)), size)


@pytest.mark.parametrize("size", [(6, 10), (3, 5)])
def test_call_table_and_outputs(fake, size):
    """Every pointer in its field, the table sizes and the image size, the
    five G-buffer planes allocated contiguous at their shapes, one launch
    counted."""
    a = _args(size=size)
    out = prepass_fused.prepass_kernel(*a)
    name, args = fake.calls[-1], fake.args[-1]
    assert name == "hk_prepass_fused"
    t = dict(zip(SIG, args))
    for key, tensor in zip(("params", "tris", "attrs", "motion", "mats"),
                           (a[0], a[1], a[2], a[3], a[4])):
        assert t[key].value == tensor.data_ptr(), key
    assert (t["n_tris"], t["n_inst"], t["n_mats"], t["h"], t["w"]) == (
        40, 3, 5, *size)
    h, w = size
    assert [tuple(o.shape) for o in out] == [(h, w, c) for c in
                                             (4, 3, 2, 4, 4)]
    for key, o in zip(SIG[10:15], out):
        assert o.is_contiguous() and o.dtype == torch.float32
        assert t[key].value == o.data_ptr(), key
    assert prepass_fused.prepass_kernel.launches == 1


@pytest.mark.parametrize("bad, error, match", [
    ("params", ValueError, "params"),
    ("tris", TypeError, "tris"),
    ("attrs", ValueError, "attrs"),
    ("motion", ValueError, "not contiguous"),
    ("mats", ValueError, "mats"),
])
def test_bad_calls_raise_before_launch(fake, bad, error, match):
    a = list(_args())
    i = ("params", "tris", "attrs", "motion", "mats").index(bad)
    a[i] = {"params": torch.zeros(prepass_fused._P_COUNT + 1),
            "tris": torch.zeros((40, 10), dtype=torch.float64),
            "attrs": torch.zeros((39, 17)),
            "motion": torch.zeros((16, 3)).t(),
            "mats": torch.zeros((5, 11))}[bad]
    with pytest.raises(error, match=match):
        prepass_fused.prepass_kernel(*a)
    assert fake.calls == [] and prepass_fused.prepass_kernel.launches == 0


# ---- the triangle test of csrc/prepass_fused.cu, in numpy float32

def staged_rows(tris, o):
    """stage_tris: per triangle (ab, instance), (ac, num), (ao, 0), (v, 0),
    each expression as mt_terms writes it."""
    r = tris
    abx, aby, abz = r[:, 3] - r[:, 0], r[:, 4] - r[:, 1], r[:, 5] - r[:, 2]
    acx, acy, acz = r[:, 6] - r[:, 0], r[:, 7] - r[:, 1], r[:, 8] - r[:, 2]
    aox, aoy, aoz = o[0] - r[:, 0], o[1] - r[:, 1], o[2] - r[:, 2]
    vx = aoy * abz - aoz * aby
    vy = aoz * abx - aox * abz
    vz = aox * aby - aoy * abx
    num = acx * vx + acy * vy + acz * vz
    return (abx, aby, abz), (acx, acy, acz), (aox, aoy, aoz), (vx, vy, vz), num


def staged_terms(rows, d):
    """tri_test's terms for ray directions d ([N, 3] against [T] rows:
    [N, T] planes): det, uu, vv and the staged num."""
    ab, ac, ao, v, num = (tuple(c[None, :] for c in x) if isinstance(x, tuple)
                          else x[None, :] for x in rows)
    dx, dy, dz = (d[:, i:i + 1] for i in range(3))
    ux = dy * ac[2] - dz * ac[1]
    uy = dz * ac[0] - dx * ac[2]
    uz = dx * ac[1] - dy * ac[0]
    det = ab[0] * ux + ab[1] * uy + ab[2] * uz
    uu = ao[0] * ux + ao[1] * uy + ao[2] * uz
    vv = dx * v[0] + dy * v[1] + dz * v[2]
    return det, uu, vv, np.broadcast_to(num, det.shape)


def full_accept(det, uu, vv, num, t_best):
    """closest_tri's test (maxt = F32_MAX): (accepted, u, v, t)."""
    inv = np.where(np.abs(det) < EPS, F32(0.0), F32(1.0) / det)
    u, v, t = uu * inv, vv * inv, num * inv
    ok = ((np.abs(det) >= EPS) & (u >= 0) & (u <= 1) & (v >= 0)
          & (u + v <= 1) & (t > EPS) & (t < F32_MAX) & (t < t_best))
    return ok, u, v, t


def sign_skip(det, num):
    """tri_test's skip before the division."""
    same = np.where(det > 0, num > 0, (det < 0) & (num < 0))
    return ~(np.abs(det) >= EPS) | ~same


def kernel_accept(det, uu, vv, num, t_best):
    """tri_test: the skip, then the distance, then u and v."""
    skip = sign_skip(det, num)
    inv = F32(1.0) / np.where(skip, F32(1.0), det)
    t = num * inv
    near = ~skip & (t > EPS) & (t < F32_MAX) & (t < t_best)
    u, v = uu * inv, vv * inv
    return near & (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1), u, v, t


def _triangles(rng, n):
    tris = rng.uniform(-3, 3, (n, 10)).astype(F32)
    tris[:, 3:9] = tris[:, 0:6] + rng.normal(0, 0.7, (n, 6)).astype(F32)
    # degenerate rows: a repeated vertex, collinear vertices, a point
    tris[0, 3:6] = tris[0, 0:3]
    tris[1, 6:9] = tris[1, 0:3] + F32(2.0) * (tris[1, 3:6] - tris[1, 0:3])
    tris[2, 3:9] = np.tile(tris[2, 0:3], 2)
    return tris


def _directions(rng, n):
    d = rng.normal(size=(n, 3)).astype(F32)
    return (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(F32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_staged_terms_equal_mt_terms(seed):
    """Random triangles (with degenerate rows) and rays from one origin:
    the staged form's det, uu, vv and num are mt_terms' words, and the
    kernel's test accepts the same triangles with the same u, v, t."""
    rng = np.random.default_rng(seed)
    tris = _triangles(rng, 64)
    o = rng.uniform(-1, 1, 3).astype(F32)
    d = _directions(rng, 512)
    with np.errstate(all="ignore"):
        got = staged_terms(staged_rows(tris, o), d)
        v0 = tuple(tris[None, :, i] for i in range(3))
        ab = tuple(tris[None, :, 3 + i] - tris[None, :, i] for i in range(3))
        ac = tuple(tris[None, :, 6 + i] - tris[None, :, i] for i in range(3))
        want = mt_terms(tuple(np.broadcast_to(o[i], (512, 1)) for i in
                              range(3)),
                        tuple(d[:, i:i + 1] for i in range(3)), v0, ab, ac)
        for g, w in zip(got, want):
            assert g.dtype == np.float32
            assert np.array_equal(np.broadcast_to(g, (512, 64)).view(np.int32),
                                  np.broadcast_to(w, (512, 64)).view(np.int32))
        t_best = np.full(got[0].shape, F32_MAX, F32)
        ok, u, v, t = full_accept(*got, t_best)
        k_ok, k_u, k_v, k_t = kernel_accept(*got, t_best)
    assert ok.any() and (~ok).any()
    assert np.array_equal(ok, k_ok)
    for a, b in ((u, k_u), (v, k_v), (t, k_t)):
        assert np.array_equal(a[ok].view(np.int32), b[ok].view(np.int32))
    assert not (sign_skip(got[0], got[3]) & ok).any()


def _edge_values():
    tiny = np.nextafter(F32(0), F32(1))
    vals = [0.0, -0.0, np.nan, np.inf, -np.inf, EPS, -EPS,
            np.nextafter(EPS, F32(0)), -np.nextafter(EPS, F32(0)),
            np.nextafter(EPS, F32(1)), F32_MAX, -F32_MAX, tiny, -tiny,
            F32(1e-38), F32(-1e-38), F32(1.0), F32(-1.0), F32(3e38),
            F32(0.5), F32(-0.25), F32(2e-7)]
    return np.array(vals, F32)


def test_sign_skip_never_rejects_an_accepted_triangle():
    """Every pair of edge values of det and num (det at +-eps and its
    neighbours, num 0, -0 or NaN, infinities, denormals, the largest
    floats) and random u and v numerators: the skip rejects only what the
    full test rejects, and the kernel's test accepts exactly what the full
    test accepts."""
    rng = np.random.default_rng(7)
    e = _edge_values()
    det, num = (g.reshape(-1) for g in np.meshgrid(e, e, indexing="ij"))
    reps = 64
    det, num = np.repeat(det, reps), np.repeat(num, reps)
    scale = np.abs(np.where(np.isfinite(det), det, F32(1.0)))
    t_best = np.where(rng.uniform(size=det.size) < 0.5, F32_MAX,
                      rng.uniform(0, 4, det.size).astype(F32)).astype(F32)
    with np.errstate(all="ignore"):
        uu, vv = (rng.uniform(-0.2, 1.2, det.size).astype(F32) * scale
                  for _ in range(2))
        uu[::7] = e[rng.integers(0, e.size, uu[::7].size)]
        ok, u, v, t = full_accept(det, uu, vv, num, t_best)
        k_ok, k_u, k_v, k_t = kernel_accept(det, uu, vv, num, t_best)
        skip = sign_skip(det, num)
    assert ok.any() and skip.any()
    assert not (skip & ok).any()
    assert np.array_equal(ok, k_ok)
    for a, b in ((u, k_u), (v, k_v), (t, k_t)):
        assert np.array_equal(a[ok].view(np.int32), b[ok].view(np.int32))
    # the cases the proof names are all skipped
    for bad_num in (F32(0.0), F32(-0.0), F32(np.nan)):
        assert sign_skip(np.array([EPS, -EPS], F32),
                         np.full(2, bad_num, F32)).all()
