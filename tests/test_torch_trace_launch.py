"""Kernels 6 and 7's launch path on the CPU (csrc/trace.cu hk_trace_full,
hk_trace_shadow) with a fake library standing in for the built one: the
packed table the wrappers marshal (TraceCall), the one output allocation
they cut into the plain versions' shapes and dtypes, n = 0 launching
nothing, bad calls raising before a launch; and kernel 7's occluder test
in the form the kernel runs it (|det| and the flipped numerators by
selection) against shadow_accept on special words."""

from __future__ import annotations

import ctypes
import itertools

import numpy as np
import pytest
import torch

from hikari_tpu_torch import build
from hikari_tpu_torch.ops import trace_pallas as tp
from hikari_tpu_torch.utils.math import F32_EPSILON, F32_MAX
from tests.test_torch_boundary import _FakeLibrary

FIELDS = ("tris", "attrs", "ro", "rd", "max_t", "excl", "incl", "out",
          "n_tris", "n")
KERNELS = {"full": ("hk_trace_full", tp.FULL_WORDS),
           "shadow": ("hk_trace_shadow", tp.SHADOW_WORDS)}


@pytest.fixture
def fake(monkeypatch):
    lib = _FakeLibrary()
    monkeypatch.setattr(build, "load_cuda", lambda name: lib)
    monkeypatch.setattr(tp, "on_cpu", lambda t: False)
    monkeypatch.setattr(tp, "stream", lambda dev: ctypes.c_void_p(0))
    monkeypatch.setattr(tp.trace_full, "launches", 0)
    monkeypatch.setattr(tp.trace_shadow, "launches", 0)
    return lib


def _inputs(n, p=5, seed=0):
    g = torch.Generator().manual_seed(seed)
    tris = torch.rand((p, 10), generator=g)
    tris[:, 9] = torch.arange(p, dtype=torch.float32)
    return dict(tris=tris, attrs=torch.rand((p, 17), generator=g),
                ro=torch.rand((n, 3), generator=g),
                rd=torch.rand((n, 3), generator=g),
                max_t=torch.rand(n, generator=g),
                excl=torch.zeros(n, dtype=torch.int32),
                incl=torch.full((n,), -1, dtype=torch.int32))


def _call(kind, a):
    if kind == "full":
        return tp.trace_full(a["tris"], a["attrs"], a["ro"], a["rd"],
                             a["max_t"], a["excl"], a["incl"])
    return tp.trace_shadow(a["tris"], a["ro"], a["rd"], a["max_t"],
                           a["excl"], a["incl"])


def _plain(kind, a):
    if kind == "full":
        return tp.full_plain(a["tris"], a["attrs"], a["ro"], a["rd"],
                             a["max_t"], a["excl"], a["incl"])
    return tp.shadow_plain(a["tris"], a["ro"], a["rd"], a["max_t"],
                           a["excl"], a["incl"])


@pytest.mark.parametrize("n", [1, 33, 257])
@pytest.mark.parametrize("kind", ["full", "shadow"])
def test_call_table_and_outputs(fake, kind, n):
    """One packed table (TraceCall: the inputs' pointers, attrs 0 for
    kernel 7, the output allocation, n_tris, n); the outputs are the plain
    version's keys, shapes and dtypes, each contiguous, all views of one
    allocation of words-a-ray * n floats laid out plane after plane in the
    plain version's key order; one launch counted."""
    name, words = KERNELS[kind]
    a = _inputs(n)
    out = _call(kind, a)
    assert fake.calls == [name]
    table, _ = fake.args[0]
    assert len(table) == tp.TRACE_TABLE.size == 72
    args = dict(zip(FIELDS, tp.TRACE_TABLE.unpack(table)))
    for k in ("tris", "ro", "rd", "max_t", "excl", "incl"):
        assert args[k] == a[k].data_ptr(), k
    assert args["attrs"] == (a["attrs"].data_ptr() if kind == "full" else 0)
    assert (args["n_tris"], args["n"]) == (5, n)

    ref = _plain(kind, a)
    assert list(out) == list(ref)
    base = out["t"].untyped_storage().data_ptr()
    assert args["out"] == base == out["t"].data_ptr()
    at = 0
    for k, r in ref.items():
        o = out[k]
        assert (o.shape, o.dtype) == (r.shape, r.dtype), k
        assert o.is_contiguous() and o.device == r.device, k
        assert o.untyped_storage().data_ptr() == base, k
        assert o.data_ptr() == base + 4 * at, k
        at += o.numel()
    assert at == words * n
    assert out["t"].untyped_storage().nbytes() == 4 * words * n
    launched = tp.trace_full if kind == "full" else tp.trace_shadow
    assert launched.launches == 1


@pytest.mark.parametrize("kind", ["full", "shadow"])
def test_no_rays_launch_nothing(fake, kind):
    """n = 0: empty outputs of the plain version's shapes and dtypes, no
    call into the library and no launch counted."""
    a = _inputs(0)
    out = _call(kind, a)
    ref = _plain(kind, a)
    assert fake.calls == []
    assert tp.trace_full.launches == tp.trace_shadow.launches == 0
    assert {k: (v.shape, v.dtype) for k, v in out.items()} == {
        k: (v.shape, v.dtype) for k, v in ref.items()}


def _bad_calls():
    a = _inputs(9)
    big = torch.zeros((tp.MAX_TRIS + 1, 10))
    return [
        ("float64 ro", dict(a, ro=a["ro"].double()), TypeError, "ro"),
        ("rd of another length", dict(a, rd=a["rd"][:8]), ValueError, "rd"),
        ("int64 excl", dict(a, excl=a["excl"].long()), TypeError, "excl"),
        ("float incl", dict(a, incl=a["incl"].float()), TypeError, "incl"),
        ("strided max_t", dict(a, max_t=torch.zeros(18)[::2]), ValueError,
         "contiguous"),
        ("tris of 11 columns", dict(a, tris=torch.zeros((5, 11))),
         ValueError, "tris"),
        ("769 triangles", dict(a, tris=big, attrs=torch.zeros(
            (tp.MAX_TRIS + 1, 17))), ValueError, "769 triangles"),
    ]


_FULL_ONLY = [("attrs of 16 columns", "attrs", torch.zeros((5, 16)),
               ValueError),
              ("float64 attrs", "attrs", torch.zeros((5, 17),
                                                     dtype=torch.float64),
               TypeError)]


@pytest.mark.parametrize("kind", ["full", "shadow"])
@pytest.mark.parametrize("case", range(len(_bad_calls())),
                         ids=[c[0] for c in _bad_calls()])
def test_bad_calls_raise_before_launch(fake, kind, case):
    _, a, error, match = _bad_calls()[case]
    with pytest.raises(error, match=match):
        _call(kind, a)
    assert fake.calls == []
    assert tp.trace_full.launches == tp.trace_shadow.launches == 0


@pytest.mark.parametrize("case", range(len(_FULL_ONLY)),
                         ids=[c[0] for c in _FULL_ONLY])
def test_bad_attrs_raise_before_launch(fake, case):
    _, key, value, error = _FULL_ONLY[case]
    with pytest.raises(error, match=key):
        _call("full", dict(_inputs(9), **{key: value}))
    assert fake.calls == [] and tp.trace_full.launches == 0


# words of the determinant and of the numerators: signed zeros, the
# smallest denormal and a larger one, |det| around eps, ordinary values,
# infinities and NaN
_DET = [0.0, -0.0, 1e-45, -1e-45, 1e-39, -1e-39, 1.1920929e-7,
        -1.1920929e-7, 1.1920928e-7, 1.0, -1.0, 2.5, -3.0, np.inf, -np.inf,
        np.nan]
_NUM = [0.0, -0.0, 1e-45, -1e-45, 0.25, -0.25, 0.75, -0.75, 1.0, -1.0, 2.0,
        np.inf, -np.inf, np.nan]


def _select_accept(terms, maxt, td_best, ads_best):
    """csrc/trace.cu occluder_test: |det| and the numerators flipped by
    selection where det < 0, then shadow_accept's comparisons."""
    det, uu, vv, dist = terms
    neg = det < 0.0
    ads = torch.abs(det)
    ud = torch.where(neg, -uu, uu)
    vd = torch.where(neg, -vv, vv)
    td = torch.where(neg, -dist, dist)
    ok = ((ads >= F32_EPSILON) & (ud >= 0.0) & (vd >= 0.0)
          & (ud + vd <= ads) & (td > F32_EPSILON * ads)
          & (td < maxt * ads) & (td * ads_best < td_best * ads))
    return ok, td, ads


@pytest.mark.parametrize("best", [(F32_MAX, 1.0), (0.5, 1.0), (1.5, 2.0)])
@pytest.mark.parametrize("maxt", [F32_MAX, 1.5])
def test_abs_det_selection_matches_shadow_accept(maxt, best):
    """The selection form accepts exactly where shadow_accept does, and
    its td and ads words equal shadow_accept's where it accepts (a
    rejected row changes no state), over every combination of special
    det, uu, vv and dist words; among them rows with ud + vd == ads
    exactly, which both accept."""
    grid = torch.tensor(list(itertools.product(_DET, _NUM, _NUM, _NUM)),
                        dtype=torch.float32)
    terms = grid.unbind(-1)
    n = grid.shape[0]
    mt = torch.full((n,), maxt)
    tdb, adb = torch.full((n,), best[0]), torch.full((n,), best[1])
    ok, td, ads = tp.shadow_accept(terms, mt, tdb, adb)
    ok_s, td_s, ads_s = _select_accept(terms, mt, tdb, adb)
    assert torch.equal(ok, ok_s)
    assert int(ok.sum()) > 0
    for got, ref in ((td_s, td), (ads_s, ads)):
        assert torch.equal(got[ok].view(torch.int32),
                           ref[ok].view(torch.int32))
    det, uu, vv, dist = terms
    # |det| = 1, ud = 0.25, vd = 0.75: the edge test's equality
    edge = ((det.abs() == 1.0) & (uu * det == 0.25) & (vv * det == 0.75)
            & (dist * det == 0.25))
    assert int(edge.sum()) == 2
    want = bool(0.25 * best[1] < best[0]) and 0.25 < maxt
    assert bool(ok[edge].all()) == want and torch.equal(ok[edge], ok_s[edge])


def test_one_compare_mask_equals_the_instance_masks():
    """csrc/trace.cu ray_mask / mask_accepts, in numpy float32: for every
    real instance id (>= 0), every exclude and every include (-2, the
    probe's "no pick", -1 and the instances), (inst == key) != ne accepts
    exactly where inst != excl and (incl < 0 or inst == incl)."""
    ids = np.arange(-2, 5, dtype=np.float32)
    inst, excl, incl = np.meshgrid(ids[2:], ids, ids, indexing="ij")
    ne = incl < 0
    key = np.where(ne, excl, np.where(incl == excl, np.float32(-1), incl))
    got = (inst == key) != ne
    want = (inst != excl) & ((incl < 0) | (inst == incl))
    assert np.array_equal(got, want) and got.any() and not got.all()
