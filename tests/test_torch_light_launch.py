"""Kernels B and 4's launch path on the CPU: the packed argument table each
call hands csrc/light_fused.cu (LightCall), the outputs it allocates, and
the checks of the scene's tables, made once per set of tables. A fake
library stands in for the built one."""

from __future__ import annotations

import ctypes

import pytest
import torch

from hikari_tpu_torch import build
from hikari_tpu_torch.ops import light_fused

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
