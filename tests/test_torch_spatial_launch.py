"""Kernel 10's launch path and the arithmetic of its redesign, on the CPU.

* The launch path (csrc/spatial_fused.cu hk_spatial_fused) with a fake
  library standing in for the built one: the argument table per channel
  (the tap count selects the template instance), the outputs the wrapper
  allocates, bad calls raising before a launch, and the parameter vector
  pack_params builds.
* The exact shortcuts the kernel takes, in numpy float32: the unorm16 and
  snorm8 decodes as a product corrected by one fma (every input of both
  divisors), fmodf(s, 1) as s - trunc(s) on the sums of the random
  numbers, and the material row formed from the G-buffer's
  instance_material .y as the plain version forms it.
* The whole-array tap table against the per-tap scalar loop it replaced.
"""

from __future__ import annotations

import ctypes

import numpy as np
import pytest
import torch

from hikari_tpu_torch import build
from hikari_tpu_torch.ops import spatial_fused
from hikari_tpu_torch.ops.light_fused import _row_index, material_ids
from hikari_tpu_torch.utils.math import TAU, random_float
from tests.test_torch_boundary import _FakeLibrary
from tests.torch_threads import one_torch_thread  # noqa: F401

F32 = np.float32
SIG = ("params", "mats", "n_mats", "temporal", "prev", "position",
       "inst_mat", "h", "w", "n_taps", "emissive_lit", "render", "variance",
       "planes", "stream")


@pytest.fixture
def fake(monkeypatch):
    lib = _FakeLibrary()
    monkeypatch.setattr(build, "load_cuda", lambda name: lib)
    monkeypatch.setattr(spatial_fused, "on_cpu", lambda t: False)
    monkeypatch.setattr(spatial_fused, "stream",
                        lambda dev: ctypes.c_void_p(0))
    monkeypatch.setattr(spatial_fused.spatial_kernel, "launches", 0)
    return lib


def _args(h=5, w=9, n_mats=4):
    return (torch.zeros(spatial_fused._S_COUNT), torch.zeros((n_mats, 15)),
            torch.zeros((h, 16, w)), torch.zeros((h, 16, w)),
            torch.zeros((h, w, 4)), torch.zeros((h, w, 2)))


@pytest.mark.parametrize("emissive_lit, n_taps", [(True, 8), (False, 16)],
                         ids=["emissive", "indirect"])
def test_call_table_and_outputs(fake, emissive_lit, n_taps):
    """Every pointer in its field, the channel's tap count and flag (the
    kernel's template instance), the outputs at their shapes."""
    a = _args()
    render, variance, planes = spatial_fused.spatial_kernel(
        *a, emissive_lit=emissive_lit)
    name, args = fake.calls[-1], fake.args[-1]
    assert name == "hk_spatial_fused"
    t = dict(zip(SIG, args))
    for key, tensor in zip(("params", "mats", "temporal", "prev", "position",
                            "inst_mat"), a):
        assert t[key].value == tensor.data_ptr(), key
    assert (t["n_mats"], t["h"], t["w"], t["n_taps"], t["emissive_lit"]) == (
        4, 5, 9, n_taps, int(emissive_lit))
    assert (tuple(render.shape), tuple(variance.shape),
            tuple(planes.shape)) == ((5, 9, 4), (5, 9), (5, 16, 9))
    for key, o in (("render", render), ("variance", variance),
                   ("planes", planes)):
        assert o.is_contiguous() and t[key].value == o.data_ptr(), key
    assert spatial_fused.spatial_kernel.launches == 1


@pytest.mark.parametrize("bad, error, match", [
    (0, ValueError, "params"),
    (1, ValueError, "materials > 16"),
    (2, ValueError, "not contiguous"),
    (5, ValueError, "inst_mat"),
    (3, TypeError, "prev"),
])
def test_bad_calls_raise_before_launch(fake, bad, error, match):
    a = list(_args())
    a[bad] = {0: torch.zeros(spatial_fused._S_COUNT - 1),
              1: torch.zeros((17, 15)),
              2: torch.zeros((5, 9, 16)).permute(0, 2, 1),
              5: torch.zeros((5, 9)),
              3: torch.zeros((5, 16, 9), dtype=torch.float64)}[bad]
    with pytest.raises(error, match=match):
        spatial_fused.spatial_kernel(*a, emissive_lit=False)
    assert fake.calls == [] and spatial_fused.spatial_kernel.launches == 0


@pytest.mark.parametrize("emissive_lit", [True, False],
                         ids=["emissive", "indirect"])
def test_pack_params_layout(emissive_lit):
    """The host's values first (lifetime, count cap, this frame's tap
    rows, zeros past the channel's taps), then the ambient colour and the
    camera position."""
    scene = {"ambient_color": torch.tensor([0.1, 0.2, 0.3, 1.0])}
    view = {"world_position": torch.tensor([4.0, 5.0, 6.0, 1.0])}
    frame = {"max_reservoir_lifetime": 8.0, "max_spatial_reuse_count": 30.0,
             "number": 11}
    p = spatial_fused.pack_params(scene, view, frame, emissive_lit).numpy()
    sf = spatial_fused
    assert p.shape == (sf._S_COUNT,) and p.dtype == np.float32
    assert (p[sf._S_MAXLIFE], p[sf._S_MAXCNT]) == (8.0, 30.0)
    n, rng_ = sf.channel_taps(emissive_lit)
    taps = p[sf._S_TAPS:sf._S_AMB].reshape(sf.MAX_TAPS, sf._TAP_STRIDE)
    assert np.array_equal(taps[:n], sf.tap_table(n, rng_, 11))
    assert not taps[n:].any()
    assert p[sf._S_AMB:sf._S_AMB + 3].tolist() == pytest.approx(
        [0.1, 0.2, 0.3])
    assert p[sf._S_CAM:sf._S_CAM + 3].tolist() == [4.0, 5.0, 6.0]
    frame["max_reservoir_lifetime"] = 1.0
    p = spatial_fused.pack_params(scene, view, frame, emissive_lit).numpy()
    assert p[sf._S_MAXLIFE] == np.finfo(np.float32).max


def _scalar_tap_offsets(count_taps, reuse_range, frame_number):
    """The per-tap scalar loop tap_table replaced (numpy float32 scalars,
    hikari_tpu's order)."""
    out = []
    frand = random_float(frame_number)
    for fi_gr, radius, inv_len, march in spatial_fused._tap_geometry(
            count_taps, reuse_range):
        angle = F32(TAU) * np.mod(fi_gr + frand, F32(1.0))
        off_x = radius * np.cos(angle)
        off_y = radius * np.sin(angle)
        steps = [(int(np.round(tdist * off_y * inv_len)),
                  int(np.round(tdist * off_x * inv_len)), frac)
                 for tdist, frac in march]
        out.append((int(np.round(off_y)), int(np.round(off_x)), steps))
    return out


@pytest.mark.parametrize("emissive_lit", [True, False],
                         ids=["emissive", "indirect"])
def test_tap_table_equals_the_scalar_loop(emissive_lit):
    """Frames 0-299: every row of the whole-array table is the scalar loop's
    words (offsets as integers, +0.0 for a rounded -0.0; fractions as
    computed), and tap_offsets reads the same taps back."""
    n, rng_ = spatial_fused.channel_taps(emissive_lit)
    for frame in range(300):
        want = _scalar_tap_offsets(n, rng_, frame)
        rows = np.zeros((n, spatial_fused._TAP_STRIDE), F32)
        for t, (oy, ox, steps) in enumerate(want):
            rows[t, :3] = (oy, ox, len(steps))
            for j, step in enumerate(steps):
                rows[t, 3 + 3 * j:6 + 3 * j] = step
        got = spatial_fused.tap_table(n, rng_, frame)
        assert np.array_equal(got.view(np.int32), rows.view(np.int32)), frame
        assert spatial_fused.tap_offsets(n, rng_, frame) == want


# ---- the exact shortcuts of csrc/spatial_fused.cu

def _f32_parts(v):
    """A positive float32 as (integer m, exponent e): v = m * 2**e."""
    m, e = np.frexp(np.float64(v))
    return int(m * 2 ** 24), int(e) - 24


def _round_f32(n, k):
    """The integer n times 2**-k rounded to float32, ties to even (the
    exact rounding of one fma)."""
    if n == 0:
        return 0.0
    sign, n = (-1 if n < 0 else 1), abs(n)
    drop = n.bit_length() - 24
    if k - drop > 149:          # below the least denormal
        drop = k - 149
    if drop > 0:
        q, rem = divmod(n, 1 << drop)
        half = 1 << (drop - 1)
        n, k = q + (rem > half or (rem == half and q & 1)), k - drop
    return sign * float(np.ldexp(np.float64(n), -k))


def div_exact(x, c, rc):
    """div_exact for an integer x: q = x * rc, then fmaf(fmaf(-q, c, x),
    rc, q), each fma rounded once (exact integer arithmetic)."""
    m, e = _f32_parts(rc)
    q = _round_f32(x * m, -e)
    if q == 0.0:
        return q
    qm, qe = _f32_parts(q)
    # -q * c + x = (x * 2**-qe - qm * c) * 2**qe, qe < 0 here
    r = _round_f32(x * (1 << -qe) - qm * c, -qe)
    if r == 0.0:
        return q
    rm, re = _f32_parts(abs(r))
    rm = rm if r > 0 else -rm
    # r * rc + q = rm * m * 2**(re + e) + qm * 2**qe
    k = -min(re + e, qe)
    return _round_f32(rm * m * (1 << (re + e + k)) + qm * (1 << (qe + k)), k)


@pytest.mark.parametrize("c, rc_hex, misses", [
    (65535, "0x1.0001p-16", 512), (255, "0x1.010102p-8", 126)])
def test_corrected_product_is_the_division(c, rc_hex, misses):
    """For every integer x in [0, c]: the corrected product is the word of
    the IEEE division x / c (the kernel's RCP_* literals are the rounded
    reciprocals); the plain product alone misses `misses` of them."""
    rc = F32(float.fromhex(rc_hex))
    assert rc == F32(1.0) / F32(c)
    x = np.arange(c + 1, dtype=F32)
    want = x / F32(c)
    assert int((x * rc != want).sum()) == misses
    got = np.array([div_exact(i, c, rc) for i in range(c + 1)], F32)
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


def test_fmod_of_the_random_sum():
    """fmodf(s, 1) = s - truncf(s) word for word on sums of four unorm16
    quotients (+0 or positive, at most 4): random ones, integers and their
    neighbours."""
    rng = np.random.default_rng(3)
    q = rng.integers(0, 65536, (200000, 4)).astype(F32) / F32(65535)
    q[:64] = F32(1.0)
    q[64:128] = F32(0.0)
    s = ((q[:, 0] + q[:, 1]) + q[:, 2]) + q[:, 3]
    s = np.concatenate([s, np.nextafter(F32([1, 2, 3, 4]), F32(0)),
                        np.nextafter(F32([0, 1, 2, 3]), F32(5))])
    assert (np.signbit(s) == 0).all()
    assert np.array_equal(np.fmod(s, F32(1.0)).view(np.int32),
                          (s - np.trunc(s)).view(np.int32))


def test_material_row_from_the_gbuffer():
    """The kernel's material row from instance_material .y (common.cuh
    material_id: C's truncating cast, NaN to 0 and saturating as CUDA
    converts, then max with 0; then row_of) is the plain version's row
    (material_ids, then _row_index), for ids in and out of range,
    negative, NaN and infinite."""
    ys = np.array([0.5, 1.5, 3.5, 3.99, 4.5, 17.5, -0.5, -1.5, -0.0, 0.0,
                   np.nan, np.inf, -np.inf, 1e10, -1e10, 2.0 ** 31, 2.25],
                  F32)
    inst_mat = torch.from_numpy(np.stack([np.zeros_like(ys), ys], -1))
    plain = _row_index(material_ids(inst_mat), 4).numpy()

    def cuda_int(v):
        if np.isnan(v):
            return 0
        return int(np.clip(np.trunc(np.float64(v)), -2 ** 31, 2 ** 31 - 1))

    def row_of(f, n):
        i = cuda_int(f)
        return i if 0 <= i < n and F32(i) == f else 0

    kernel = [row_of(F32(max(cuda_int(v), 0)), 4) for v in ys]
    assert plain.tolist() == kernel


def test_jacobian_terms_from_the_sample_direction():
    """tap_step's shortcuts, word for word, on random points with shared
    coordinates (zero differences) and normals with zero components:
    |rsqrt_n(vp - sp) . sn| = |sd . sn| with sd = rsqrt_n(sp - vp), and
    |vp - sp|^2 = |sp - vp|^2 (one reciprocal square root stands in for
    rsqrtf: both sides take it of the same word)."""
    rng = np.random.default_rng(5)
    n = 100000
    sp = rng.normal(0, 3, (n, 3)).astype(F32)
    vp = rng.normal(0, 3, (n, 3)).astype(F32)
    same = rng.uniform(size=(n, 3)) < 0.2
    vp[same] = sp[same]
    sn = rng.normal(size=(n, 3)).astype(F32)
    sn[rng.uniform(size=(n, 3)) < 0.2] = F32(0.0)
    sn[rng.uniform(size=(n, 3)) < 0.05] = F32(-0.0)

    def rsqrt_n(v):
        len2 = (v[:, 0] * v[:, 0] + v[:, 1] * v[:, 1]) + v[:, 2] * v[:, 2]
        inv = F32(1.0) / np.sqrt(np.maximum(len2, F32(1e-20)))
        return v * inv[:, None], len2

    def dot(a, b):
        return (a[:, 0] * b[:, 0] + a[:, 1] * b[:, 1]) + a[:, 2] * b[:, 2]

    sd, len2 = rsqrt_n(sp - vp)
    tr, _ = rsqrt_n(vp - sp)
    b = vp - sp
    den = (b[:, 0] * b[:, 0] + b[:, 1] * b[:, 1]) + b[:, 2] * b[:, 2]
    assert np.array_equal(np.abs(dot(tr, sn)).view(np.int32),
                          np.abs(dot(sd, sn)).view(np.int32))
    assert np.array_equal(den.view(np.int32), len2.view(np.int32))
