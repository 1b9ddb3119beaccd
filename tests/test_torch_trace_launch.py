"""Kernels 5, 6 and 7's launch path on the CPU (csrc/trace.cu
hk_trace_closest, hk_trace_full, hk_trace_shadow) with a fake library
standing in for the built one: the packed table the wrappers marshal
(TraceCall), the one output allocation they cut into the plain versions'
shapes and dtypes, n = 0 launching nothing, bad calls raising before a
launch; kernel 7's occluder test in the form the kernel runs it (|det| and
the flipped numerators by selection) against shadow_accept on special
words; and kernel 5's test and sweep in the form the kernel runs them (one
limit for max_t and the nearest t, the reciprocal for every det, no u <= 1
compare, the winner's u and v computed again after the loop) against
closest_accept and closest_plain."""

from __future__ import annotations

import ctypes
import importlib.util
import itertools
import os

import numpy as np
import pytest
import torch

from hikari_tpu_torch import build
from hikari_tpu_torch.ops import trace_pallas as tp
from hikari_tpu_torch.ops._kernel import div
from hikari_tpu_torch.utils.math import F32_EPSILON, F32_MAX
from tests.cornell_box import build_cornell_box
from tests.test_torch_boundary import _FakeLibrary
from tests.torch_threads import one_torch_thread  # noqa: F401

FIELDS = ("tris", "attrs", "ro", "rd", "max_t", "excl", "incl", "out",
          "n_tris", "n")
KERNELS = {"closest": ("hk_trace_closest", tp.CLOSEST_WORDS),
           "full": ("hk_trace_full", tp.FULL_WORDS),
           "shadow": ("hk_trace_shadow", tp.SHADOW_WORDS)}
WRAPPERS = {"closest": tp.trace_closest, "full": tp.trace_full,
            "shadow": tp.trace_shadow}


@pytest.fixture
def fake(monkeypatch):
    lib = _FakeLibrary()
    monkeypatch.setattr(build, "load_cuda", lambda name: lib)
    monkeypatch.setattr(tp, "on_cpu", lambda t: False)
    monkeypatch.setattr(tp, "stream", lambda dev: ctypes.c_void_p(0))
    for fn in WRAPPERS.values():
        monkeypatch.setattr(fn, "launches", 0)
    return lib


def _launches():
    return [fn.launches for fn in WRAPPERS.values()]


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
    return WRAPPERS[kind](a["tris"], a["ro"], a["rd"], a["max_t"],
                          a["excl"], a["incl"])


def _plain(kind, a):
    if kind == "full":
        return tp.full_plain(a["tris"], a["attrs"], a["ro"], a["rd"],
                             a["max_t"], a["excl"], a["incl"])
    plain = tp.closest_plain if kind == "closest" else tp.shadow_plain
    return plain(a["tris"], a["ro"], a["rd"], a["max_t"], a["excl"],
                 a["incl"])


@pytest.mark.parametrize("n", [1, 33, 257])
@pytest.mark.parametrize("kind", list(KERNELS))
def test_call_table_and_outputs(fake, kind, n):
    """One packed table (TraceCall: the inputs' pointers, attrs 0 for
    kernels 5 and 7, the output allocation, n_tris, n); the outputs are
    the plain version's keys, shapes and dtypes, each contiguous, all views of one
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
    assert _launches() == [int(k == kind) for k in WRAPPERS]


@pytest.mark.parametrize("kind", list(KERNELS))
def test_no_rays_launch_nothing(fake, kind):
    """n = 0: empty outputs of the plain version's shapes and dtypes, no
    call into the library and no launch counted."""
    a = _inputs(0)
    out = _call(kind, a)
    ref = _plain(kind, a)
    assert fake.calls == []
    assert _launches() == [0, 0, 0]
    assert {k: (v.shape, v.dtype) for k, v in out.items()} == {
        k: (v.shape, v.dtype) for k, v in ref.items()}


def _bad_calls():
    a = _inputs(9)
    return [
        ("float64 ro", dict(a, ro=a["ro"].double()), TypeError, "ro"),
        ("rd of another length", dict(a, rd=a["rd"][:8]), ValueError, "rd"),
        ("int64 excl", dict(a, excl=a["excl"].long()), TypeError, "excl"),
        ("float incl", dict(a, incl=a["incl"].float()), TypeError, "incl"),
        ("strided max_t", dict(a, max_t=torch.zeros(18)[::2]), ValueError,
         "contiguous"),
        ("tris of 11 columns", dict(a, tris=torch.zeros((5, 11))),
         ValueError, "tris"),
        ("int32 tris", dict(a, tris=a["tris"].to(torch.int32)), TypeError,
         "tris"),
    ]


_FULL_ONLY = [("attrs of 16 columns", "attrs", torch.zeros((5, 16)),
               ValueError),
              ("float64 attrs", "attrs", torch.zeros((5, 17),
                                                     dtype=torch.float64),
               TypeError)]


@pytest.mark.parametrize("p", [tp.CHUNK_ROWS + 1, 2618])
@pytest.mark.parametrize("kind", list(KERNELS))
def test_tables_above_one_chunk_launch(fake, kind, p):
    """A table of more rows than a block stages at once launches with its
    whole row count (the kernels sweep it chunk by chunk), its outputs the
    plain version's shapes and dtypes."""
    name, _ = KERNELS[kind]
    a = _inputs(9, p=p)
    out = _call(kind, a)
    assert fake.calls == [name]
    args = dict(zip(FIELDS, tp.TRACE_TABLE.unpack(fake.args[0][0])))
    assert (args["n_tris"], args["n"]) == (p, 9)
    ref = _plain(kind, a)
    assert {k: (v.shape, v.dtype) for k, v in out.items()} == {
        k: (v.shape, v.dtype) for k, v in ref.items()}
    assert _launches() == [int(k == kind) for k in WRAPPERS]


@pytest.mark.parametrize("kind", list(KERNELS))
@pytest.mark.parametrize("case", range(len(_bad_calls())),
                         ids=[c[0] for c in _bad_calls()])
def test_bad_calls_raise_before_launch(fake, kind, case):
    _, a, error, match = _bad_calls()[case]
    with pytest.raises(error, match=match):
        _call(kind, a)
    assert fake.calls == []
    assert _launches() == [0, 0, 0]


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


# kernel 5's special words: det at +-eps and its neighbour below, +-0,
# NaN, +-inf, a denormal and a det whose reciprocal is one; numerators at
# +-0, the smallest denormals (times RN(1 / 4) they round to -0 and +0),
# u + v at 1, 1 - 1 ulp and 1 + 1 ulp (0.25 + 0.75, + 0.75's neighbour
# below and + 0.75 + 2^-23; 0.25 + 0.75's neighbour above is a tie that
# rounds to 1), dist at eps and its neighbour above, at max_t (1.5) and at
# t_best (0.5)
_V_UP = [float(np.nextafter(np.float32(0.75), np.float32(1))),
         0.75 + 2.0 ** -23]
_EPS_BELOW = float(np.nextafter(np.float32(F32_EPSILON), np.float32(0)))
_EPS_ABOVE = float(np.nextafter(np.float32(F32_EPSILON), np.float32(1)))
_DET5 = [F32_EPSILON, -F32_EPSILON, _EPS_BELOW, 0.0, -0.0, np.nan, np.inf,
         -np.inf, 1e-39, 1.0, -1.0, 4.0, -4.0, 3e38]
_NUM5 = [0.0, -0.0, 1e-45, -1e-45, 0.25, -0.25, 0.75, *_V_UP,
         float(np.nextafter(np.float32(0.75), np.float32(0))),
         F32_EPSILON, _EPS_ABOVE, 0.5, 1.5, -1.5, np.inf, np.nan]


def _near_limit(maxt, t_best):
    """csrc/trace.cu Nearest.lim: min(max_t clamped to F32_MAX, t_best),
    NaN where max_t is NaN."""
    lim = torch.where(maxt > F32_MAX, F32_MAX, maxt)
    return torch.where(t_best < lim, t_best, lim)


def _near_accepts(terms, acc, lim):
    """csrc/trace.cu near_accepts: (accepted, u, v, dist) with the
    reciprocal taken for every det and no u <= 1 compare."""
    det, uu, vv, dist = terms
    inv_det = div(1.0, det)
    u, v, dist = uu * inv_det, vv * inv_det, dist * inv_det
    ok = (acc & (torch.abs(det) >= F32_EPSILON) & (u >= 0.0) & (v >= 0.0)
          & (u + v <= 1.0) & (dist > F32_EPSILON) & (dist < lim))
    return ok, u, v, dist


@pytest.mark.parametrize("best", [F32_MAX, 0.5, 2.0])
@pytest.mark.parametrize("maxt", [F32_MAX, np.inf, 1.5, np.nan])
def test_kernel5_test_matches_closest_accept(maxt, best):
    """Kernel 5's test accepts exactly where closest_accept does, and its
    u, v and dist words equal closest_accept's where it accepts, over
    every combination of special det, uu, vv and dist words; among them
    u + v = 1 exactly or by a tie (accepted), 1 + 1 ulp (rejected), -0
    products of negative numerators (accepted, as u >= 0 holds for -0),
    dist at eps, at max_t and at t_best (rejected)."""
    grid = torch.tensor(list(itertools.product(_DET5, _NUM5, _NUM5, _NUM5)),
                        dtype=torch.float32)
    terms = grid.unbind(-1)
    n = grid.shape[0]
    mt, tb = torch.full((n,), maxt), torch.full((n,), best)
    ok, u, v, dist = tp.closest_accept(terms, mt, tb)
    ok5, u5, v5, d5 = _near_accepts(terms, torch.ones(n, dtype=torch.bool),
                                    _near_limit(mt, tb))
    assert torch.equal(ok, ok5)
    for got, ref in ((u5, u), (v5, v), (d5, dist)):
        assert torch.equal(got[ok].view(torch.int32),
                           ref[ok].view(torch.int32))
    det, uu, vv, dd = terms
    if maxt == maxt:
        assert int(ok.sum()) > 0
    one = det == 1.0
    # u + v = 1 exactly, by a tie, and one ulp above
    at = one & (uu == 0.25) & (dd == 0.25)
    sum_one = at & ((vv == 0.75) | (vv == _V_UP[0]))
    above = at & (vv == _V_UP[1])
    assert int(sum_one.sum()) == 2 and int(above.sum()) == 1
    want = maxt == maxt and 0.25 < best
    assert bool(ok5[sum_one].all()) == want and not ok5[above].any()
    # -1e-45 * RN(1 / 4) rounds to -0, which passes u >= 0
    tiny = ((det == 4.0) & (uu < 0) & (uu > -1e-44) & (vv == 0.75)
            & (dd == 0.5))
    assert int(tiny.sum()) == 1
    assert torch.equal(u5[tiny].view(torch.int32),
                       torch.tensor([-0.0]).view(torch.int32))
    assert bool(ok5[tiny].all()) == (maxt == maxt and 0.125 < best)
    # dist at eps, at max_t and at t_best
    for at in (F32_EPSILON, maxt, best):
        assert not ok5[one & (dd == at)].any()


def _kernel5_sweep(tris, ro, rd, max_t, excl, incl):
    """csrc/trace.cu closest_kernel in float32 torch: edge rows, each ray's
    masks as one compare (ray_mask), the padding rows skipped, one limit
    and the winner's index through the loop, and the winner's u and v
    computed again after it from its row. Returns closest_plain's dict."""
    rows = tris.numpy()
    o, d = ro.unbind(-1), rd.unbind(-1)
    ex, inc = excl.float(), incl.float()
    ne = inc < 0.0
    key = torch.where(ne, ex, torch.where(inc == ex, -1.0, inc))
    lim = _near_limit(max_t, torch.full_like(max_t, F32_MAX))
    prim = torch.full(max_t.shape, -1, dtype=torch.int32)
    edges = [tp._tri_scalars(r) for r in rows]
    for i, r in enumerate(rows):
        inst = float(r[9])
        if not inst >= 0.0:
            continue
        e = edges[i]
        terms = tp.mt_terms(o, d, e[0:3], e[3:6], e[6:9])
        ok, _, _, dist = _near_accepts(terms, (key == inst) != ne, lim)
        lim = torch.where(ok, dist, lim)
        prim = torch.where(ok, i, prim)
    hit = prim >= 0
    p = torch.clamp(prim, min=0).long()
    tab = torch.tensor([edges[i] if rows[i, 9] >= 0 else [0.0] * 9
                        for i in range(len(rows))], dtype=torch.float32)
    row = tab[p].unbind(-1)
    det, uu, vv, _ = tp.mt_terms(o, d, row[0:3], row[3:6], row[6:9])
    inv_det = div(1.0, det)
    inst = torch.as_tensor(rows[:, 9])[p]
    return {"t": torch.where(hit, lim, F32_MAX),
            "u": torch.where(hit, uu * inv_det, 0.0),
            "v": torch.where(hit, vv * inv_det, 0.0), "prim": prim,
            "inst": torch.round(torch.where(hit, inst, -1.0)).to(
                torch.int32)}


def _chip_smoke():
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke_rays", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _words_equal(got, ref):
    assert list(got) == list(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype, k
        assert torch.equal(got[k].view(torch.int32),
                           ref[k].view(torch.int32)), k


def test_kernel5_sweep_matches_plain_on_adversarial_rays():
    """The kernel's sweep equals closest_plain word for word on the box
    table (36 triangles and 4 padding rows) over chip_smoke.py's
    adversarial rays: aimed at vertices and shared edges, grazing the
    faces, leaving faces towards the others, and again with max_t at each
    hit's distance and one ulp either side."""
    cs = _chip_smoke()
    tris = build_cornell_box("hikari_tpu_torch").compile().as_pytree(
        torch.device("cpu"))["tri_pos_flat"]
    rays = cs.adversarial_rays(tris.numpy())
    ref = tp.closest_plain(tris, *rays)
    _words_equal(_kernel5_sweep(tris, *rays), ref)
    hit = ref["prim"] >= 0
    assert 0.3 < float(hit.float().mean()) < 0.95
    # ties: two triangles at the same distance, the lower index kept
    near = cs.at_hit_distance(rays, ref["t"], hit)
    ref_near = tp.closest_plain(tris, *near)
    _words_equal(_kernel5_sweep(tris, *near), ref_near)
    k = int(hit.sum())
    assert not (ref_near["prim"][:k] >= 0).any()
    assert torch.equal(ref_near["prim"][k:2 * k], ref["prim"][hit])


@pytest.mark.parametrize("seed", [0, 1])
def test_kernel5_sweep_matches_plain_on_random_rows(seed):
    """The kernel's sweep equals closest_plain word for word on seeded
    random rows (with padding rows and repeated instances) and rays with
    seeded masks and max_t."""
    g = np.random.default_rng(seed)
    p, n = 24, 4096
    tris = g.uniform(-1, 1, (p, 10)).astype(np.float32)
    tris[:, 9] = g.integers(0, 5, p)
    tris[g.random(p) < 0.2, 9] = -1.0
    ro = g.uniform(-1.5, 1.5, (n, 3)).astype(np.float32)
    rd = g.normal(size=(n, 3)).astype(np.float32)
    max_t = np.where(g.random(n) < 0.5, np.float32(F32_MAX),
                     g.uniform(0, 3, n)).astype(np.float32)
    excl = g.integers(-1, 5, n).astype(np.int32)
    incl = np.where(g.random(n) < 0.7, -1, g.integers(-2, 5, n))
    a = tuple(torch.from_numpy(x) for x in
              (tris, ro, rd, max_t, excl, incl.astype(np.int32)))
    ref = tp.closest_plain(*a)
    assert (ref["prim"] >= 0).any()
    _words_equal(_kernel5_sweep(*a), ref)
