"""Kernels B and 4's launch path on the CPU: the packed argument table each
call hands csrc/light_fused.cu (LightCall), the outputs it allocates, and
the checks of the scene's tables, made once per set of tables. A fake
library stands in for the built one. Also two of kernel B's dead-work
skips, stated on the plain version: an invalid pixel's render words, and
the shading words of a candidate whose trace_ok is false under
shade_ignores_l's guard."""

from __future__ import annotations

import ctypes

import numpy as np

import pytest
import torch

from hikari_tpu_torch import build
from hikari_tpu_torch.ops import light_fused
from tests.torch_threads import one_torch_thread  # noqa: F401

IO_KEYS = ("render", "var", "packed", "flags", "scatter", "prev")
FIELDS = ("params", "tris", "attrs", "em_tris", "em_attrs", "mats",
          "position", "normal", "inst_mat", "rand") + tuple(
    f"{k}_{c}" for k in IO_KEYS for c in "dei") + (
    "n_tris", "n_em_tris", "n_mats", "h", "w", "n_em", "n_alias", "bounces",
    "temporal", "validation", "track_de", "track_ind")


class RecordingLibrary:
    """A kernel library stand-in: checks each call against the declared
    ctypes signature and records it."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)

        def fn(*args):
            assert len(args) == len(fn.argtypes), name
            for a, t in zip(args, fn.argtypes):
                want = {ctypes.c_char_p: bytes}.get(t, ctypes.c_void_p)
                assert isinstance(a, want), (name, a)
            self.calls.append((name, args))
            return 0

        setattr(self, name, fn)
        return fn


@pytest.fixture
def fake(monkeypatch):
    lib = RecordingLibrary()
    monkeypatch.setattr(build, "load_cuda", lambda name: lib)
    monkeypatch.setattr(light_fused, "on_cpu", lambda t: False)
    monkeypatch.setattr(light_fused, "stream", lambda dev: ctypes.c_void_p(0))
    monkeypatch.setattr(light_fused.lighting_kernel, "launches", 0)
    monkeypatch.setattr(light_fused, "_tables", [None])
    return lib


def _table(lib):
    name, (table, _) = lib.calls[-1]
    assert name == "hk_light_fused"
    return dict(zip(FIELDS, light_fused.LIGHT_TABLE.unpack(table)))


def _scene():
    return dict(tris=torch.zeros((40, 10)), attrs=torch.zeros((40, 17)),
                em_tris=torch.zeros((8, 10)), em_attrs=torch.zeros((8, 17)),
                mats=torch.zeros((4, 15)))


def _args(sc, h, w):
    return (torch.zeros(light_fused._P_COUNT), sc["tris"], sc["attrs"],
            sc["em_tris"], sc["em_attrs"], sc["mats"],
            torch.zeros((h, w, 4)), torch.zeros((h, w, 3)),
            torch.zeros((h, w, 2)), torch.zeros((h, w, 4)))


# (h, w): an even pixel count, and an odd one (the renders stay 16-byte
# aligned in their allocation)
@pytest.mark.parametrize("size", [(4, 6), (3, 5)])
def test_temporal_call_table(fake, size):
    """Kernel 4 with spatial tracking (path S's variant) on the emissive
    and indirect channels: every pointer in its field, the direct
    channel's null, the outputs of one shape (renders; variances and
    flags; packed reservoirs; scatter reservoirs) views of one allocation,
    the packed reservoirs (which the frame carries on) apart."""
    h, w = size
    sc = _scene()
    a = _args(sc, h, w)
    prev = [torch.zeros((h, 16, w)) for _ in range(2)]
    out = light_fused.lighting_kernel(
        *a, prev, has_sun=False, n_em=1, n_alias=2, bounces=1,
        temporal=True, validation=True, track_de=True, track_ind=True)
    t = _table(fake)
    assert light_fused.lighting_kernel.launches == 1
    for key, tensor in zip(FIELDS[:10], a):
        assert t[key] == tensor.data_ptr(), key
    assert sorted(out) == sorted(
        ["e_render", "i_render", "e_var", "i_var", "e_packed", "i_packed",
         "e_flags", "i_flags", "e_scatter"])
    for k in IO_KEYS[:5]:
        assert t[f"{k}_d"] == 0
    assert t["scatter_i"] == 0
    for name, tensor in out.items():
        slot, key = name.split("_")
        assert t[f"{key}_{slot}"] == tensor.data_ptr(), name
        assert tensor.is_contiguous()
    assert (t["prev_d"], t["prev_e"], t["prev_i"]) == (
        0, prev[0].data_ptr(), prev[1].data_ptr())
    assert [out[k].shape for k in ("e_render", "e_var", "e_packed")] == [
        (h, w, 4), (h, w), (h, 16, w)]
    assert (t["n_tris"], t["n_em_tris"], t["n_mats"], t["h"], t["w"],
            t["n_em"], t["n_alias"], t["bounces"]) == (40, 8, 4, h, w, 1, 2,
                                                       1)
    assert (t["temporal"], t["validation"], t["track_de"],
            t["track_ind"]) == (1, 1, 1, 1)
    # one allocation per shape
    storages = {n: o.untyped_storage().data_ptr() for n, o in out.items()}
    groups = [("e_render", "i_render"), ("e_var", "i_var", "e_flags",
                                         "i_flags"),
              ("e_packed", "i_packed"), ("e_scatter",)]
    for group in groups:
        assert {storages[n] for n in group} == {storages[group[0]]}
    assert len(set(storages.values())) == len(groups)
    assert out["i_render"].data_ptr() % 16 == 0


def test_no_reuse_call_table(fake):
    """Kernel B (no reuse) on all three channels: only the renders, and
    no previous reservoirs."""
    h, w = 4, 6
    out = light_fused.lighting_kernel(
        *_args(_scene(), h, w), has_sun=True, n_em=1, n_alias=2, bounces=1)
    t = _table(fake)
    assert sorted(out) == ["d_render", "e_render", "i_render"]
    for c in "dei":
        assert t[f"render_{c}"] == out[f"{c}_render"].data_ptr()
        for k in IO_KEYS[1:]:
            assert t[f"{k}_{c}"] == 0
    assert t["temporal"] == 0


def test_scene_tables_checked_once(fake, monkeypatch):
    """The scene's tables are checked at their first launch; later launches
    on the same tensors skip the checks, new tensors are checked again, and
    the per-frame inputs are checked every launch."""
    checked = []
    real = light_fused.check

    def counting(name, *args, **kw):
        checked.append(name)
        return real(name, *args, **kw)

    monkeypatch.setattr(light_fused, "check", counting)
    sc = _scene()
    kw = dict(has_sun=False, n_em=1, n_alias=2, bounces=1)
    for _ in range(2):
        checked.clear()
        light_fused.lighting_kernel(*_args(sc, 4, 6), **kw)
        assert "position" in checked and "params" in checked
    assert "tris" not in checked
    bad = dict(sc, tris=torch.zeros((40, 10), dtype=torch.float64))
    with pytest.raises(TypeError, match="tris"):
        light_fused.lighting_kernel(*_args(bad, 4, 6), **kw)
    bad = dict(sc, attrs=torch.zeros((40, 16)))
    with pytest.raises(ValueError, match="attrs"):
        light_fused.lighting_kernel(*_args(bad, 4, 6), **kw)
    assert light_fused.lighting_kernel.launches == 2


def test_bad_calls_raise_before_launch(fake):
    h, w = 4, 6
    a = _args(_scene(), h, w)
    kw = dict(has_sun=False, n_em=1, n_alias=2, bounces=1, temporal=True)
    with pytest.raises(ValueError, match="previous reservoirs"):
        light_fused.lighting_kernel(*a, [torch.zeros((h, 16, w))], **kw)
    with pytest.raises(ValueError, match="prev"):
        light_fused.lighting_kernel(
            *a, [torch.zeros((h, 16, w)), torch.zeros((h, w, 16))], **kw)
    with pytest.raises(ValueError, match="position"):
        light_fused.lighting_kernel(*a[:6], torch.zeros((h, w, 3)), *a[7:],
                                    has_sun=False, n_em=1, n_alias=2,
                                    bounces=1)
    assert fake.calls == [] and light_fused.lighting_kernel.launches == 0


# ---- kernel B's dead-work skips, on the plain version

F32 = np.float32


def test_invalid_pixels_render_zero_words():
    """Kernel B returns at an invalid pixel (depth < eps) after writing
    zeros: the plain version's renders there are +0 words whatever the
    pixel's other G-buffer and noise words hold, and the valid pixels'
    words do not depend on them."""
    import hikari_tpu_torch as ht
    from hikari_tpu_torch.camera import view_to_device
    from hikari_tpu_torch.config import make_frame_uniform
    from hikari_tpu_torch.ops import prepass_fused as pf
    from hikari_tpu_torch.ops.noise import noise_constant, sample_blue_noise
    from tests.cornell_box import EYE, TARGET, build_cornell_box

    h, w = 12, 16
    gpu = build_cornell_box("hikari_tpu_torch").compile()
    scene = gpu.as_pytree("cpu")
    view = view_to_device(ht.Camera.from_look_at(
        EYE, TARGET, width=w, height=h).view_uniform(), "cpu")
    got = pf.prepass_plain(pf.pack_params(view, view, (0.0, 0.0), (h, w)),
                           scene["tri_pos_flat"], scene["tri_attr"],
                           scene["inst_motion"], scene["mat_packed"], (h, w))
    g, _ = pf._assemble(*got)
    rand = sample_blue_noise(noise_constant("cpu"), 0, (h, w))
    settings = ht.HikariSettings()
    params = light_fused.pack_params(scene, view,
                                     make_frame_uniform(settings, 0),
                                     gpu.num_emissives, True)

    def light(position, normal, inst_mat, rnd):
        return light_fused.lighting_plain(
            params, scene["tri_pos_flat"], scene["tri_attr"],
            scene["em_tri_pos_flat"], scene["em_tri_attr"],
            scene["mat_packed"], position, normal, inst_mat, rnd,
            has_sun=True, n_em=gpu.num_emissives,
            n_alias=scene["alias_packed"].shape[0], bounces=1)

    ins = [g["position"], g["normal"], g["instance_material"], rand]
    invalid = g["position"][..., 3] < 1.1920929e-7
    assert invalid.any() and (~invalid).any()
    base = light(*ins)
    rng = np.random.default_rng(5)
    junk = []
    for t in ins:
        t = t.clone()
        noise = torch.from_numpy(rng.normal(0, 50, t.shape).astype(F32))
        noise.view(-1)[::7] = float("nan")
        t[invalid] = noise[invalid]
        junk.append(t)
    junk[0][..., 3] = torch.where(invalid, 0.0, junk[0][..., 3])
    other = light(*junk)
    for k in base:
        assert (base[k][invalid].view(torch.int32) == 0).all(), k
        assert torch.equal(base[k].view(torch.int32),
                           other[k].view(torch.int32)), k


def test_shade_words_ignore_l_under_the_guard():
    """shade_ignores_l (csrc/light_fused.cu) on the plain shade: where a
    candidate's trace_ok is false (rad = 0, rad_a = 0, w2d = +0) and the
    guard holds (|f0|, |diff| <= 2^60, nov <= 2, no ambient term -0), the
    words of shade(...) * w2d are the same for every light direction l;
    a negative material under a -0 ambient term, which the guard refuses,
    shows the words can differ."""
    rng = np.random.default_rng(11)
    n = 512
    mats = rng.uniform(0, 1, (8, 15)).astype(F32)
    mats[1, 8] = np.nan                     # roughness NaN -> 0.089
    mats[2, :3] = 1e30                      # beyond the guard's bound
    mats[3, :3] = -1.0                      # a negative base colour
    mats[3, 9] = 0.0
    mats[4, 9] = 1.0                        # metal
    mat_f = torch.from_numpy(rng.integers(0, 8, n).astype(F32))
    surf = light_fused._Surface(torch.from_numpy(mats), mat_f)

    def unit(m):
        x = rng.normal(size=(m, 3)).astype(F32)
        return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(F32)

    v = torch.from_numpy(unit(n)).unbind(-1)
    nrm = unit(n)
    nrm[::9] = 0.0
    nrm[1::9] *= F32(3.0)                    # nov above 2 on some pixels
    nrm = torch.from_numpy(nrm).unbind(-1)
    zero = torch.zeros(n)
    ls = [unit(n), unit(n), -unit(n), np.zeros((n, 3), F32),
          np.full((n, 3), F32(1e30)), unit(n) * F32(1e-30)]
    nov = torch.clamp(light_fused._dot(*nrm, *v), min=0.0001)
    da = light_fused._env_brdf_approx(*surf.diff, torch.ones_like(nov), nov)
    sa = light_fused._env_brdf_approx(*surf.f0, surf.rough, nov)

    def shaded(amb):
        """(the words of shade * +0 for each l [L, 3, n], the guard)."""
        words = []
        with np.errstate(all="ignore"):
            for l in ls:
                o = light_fused._shade(surf, amb, *v, *nrm,
                                       *torch.from_numpy(l).unbind(-1),
                                       zero, zero, zero, zero)
                words.append(torch.stack([c * 0.0 for c in o]).view(
                    torch.int32))
        guard = nov <= 2.0
        for c in surf.f0 + surf.diff:
            guard = guard & (c.abs() <= 2.0 ** 60)
        for i in range(3):
            am = (da[i] + sa[i]) * amb[i]
            guard = guard & (am.view(torch.int32) != torch.tensor(
                -0.0).view(torch.int32))
        same = torch.stack([(w_ == words[0]).all(0) for w_ in words]).all(0)
        return same, guard

    same, guard = shaded([F32(0.0), F32(0.2), F32(0.3)])
    assert guard.float().mean() > 0.5 and (~guard).any()
    assert same[guard].all()
    assert not same[~guard].all()
    # -0 ambient terms: the guard refuses them, and the negative material
    # (row 3) shows why
    same, guard = shaded([F32(-0.0)] * 3)
    assert same[guard].all()
    assert not same[(mat_f == 3) & ~guard].all()
