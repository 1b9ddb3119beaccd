"""Kernels 11 and 12's launch path on the CPU: the packed argument table
each call hands csrc/warp.cu (BandCall / MultiCall), and the binding made
once per library object. A fake library stands in for the built one."""

from __future__ import annotations

import ctypes
import gc

import pytest
import torch

from hikari_tpu_torch import build
from hikari_tpu_torch.ops import _kernel, warp2, warp_band
from tests.torch_threads import one_torch_thread  # noqa: F401

BAND_FIELDS = ("src", 4), ("dst", 4), ("sy", 1), ("sx", 1), ("blocks", 1), \
    ("kind", 4), ("f", 4), ("stride", 4), ("n_src", 1), \
    ("h", 1), ("w", 1), ("hs", 1)
MULTI_FIELDS = ("src", 1), ("dst", 4), ("sy", 1), ("sx", 1), ("kind", 4), \
    ("lo", 4), ("hi", 4), ("offy", 4), ("offx", 4), ("n_red", 1), \
    ("hs", 1), ("ws", 1), ("p", 1), ("h", 1), ("w", 1), ("bf16", 1), \
    ("unused", 1)


def decode(table: bytes, layout, fields):
    """{field: value or tuple} of a packed table."""
    values = layout.unpack(table)
    out, i = {}, 0
    for name, n in fields:
        out[name] = values[i] if n == 1 else values[i:i + n]
        i += n
    assert i == len(values)
    return out


class CountingLibrary:
    """A kernel library stand-in: every attribute lookup of a function
    makes a new function object and counts it; calls are recorded."""

    def __init__(self):
        self.lookups = 0
        self.calls = []

    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)
        self.lookups += 1
        lib = self

        def fn(*args):
            assert len(args) == len(fn.argtypes), name
            for a, t in zip(args, fn.argtypes):
                want = {ctypes.c_char_p: bytes}.get(t, ctypes.c_void_p)
                assert isinstance(a, want), (name, a)
            lib.calls.append((name, args))
            return 0

        fn.owner = self
        return fn


@pytest.fixture
def fake(monkeypatch):
    lib = CountingLibrary()
    monkeypatch.setattr(build, "load_cuda", lambda name: lib)
    for mod in (warp_band, warp2):
        monkeypatch.setattr(mod, "on_cpu", lambda t: False)
        monkeypatch.setattr(mod, "stream", lambda dev: ctypes.c_void_p(0))
    return lib


def _band(lib):
    return decode(lib.calls[-1][1][0], warp_band.BAND_TABLE, BAND_FIELDS)


def _multi(lib):
    return decode(lib.calls[-1][1][0], warp2.MULTI_TABLE, MULTI_FIELDS)


def test_taa_call_table(fake):
    """TAA's call: the RGB of a 4-channel history (stride 4) by
    Catmull-Rom and 6 contiguous aux channels by nearest."""
    h, w = 12, 16
    prev = torch.rand(h, w, 4)
    aux = torch.rand(h, w, 6)
    sy, sx = torch.rand(h, w), torch.rand(h, w)
    outs = warp_band.warp_band([prev[..., :3], aux], ("catmull", "nearest"),
                               sy, sx)
    assert [tuple(o.shape) for o in outs] == [(h, w, 3), (h, w, 6)]
    assert all(o.is_contiguous() for o in outs)
    t = _band(fake)
    assert t["src"] == (prev.data_ptr(), aux.data_ptr(), 0, 0)
    assert t["dst"] == (outs[0].data_ptr(), outs[1].data_ptr(), 0, 0)
    assert (t["sy"], t["sx"], t["blocks"]) == (sy.data_ptr(), sx.data_ptr(),
                                               0)
    assert t["kind"] == (2, 0, 0, 0)
    assert t["f"] == (3, 6, 0, 0)
    assert t["stride"] == (4, 6, 0, 0)
    assert (t["n_src"], t["h"], t["w"], t["hs"]) == (2, h, w, h)


def test_smaa_tone_call_table(fake):
    """SMAA's tone call: one nearest source, the RGB of a 4-channel tone
    image at a row offset (a slice with a storage offset); a block
    counter passes through, and one of another dtype raises."""
    h, w = 6, 8
    tone = torch.rand(h + 1, w, 4)[1:]
    sy, sx = torch.rand(h, w), torch.rand(h, w)
    out, = warp_band.warp_band([tone[..., :3]], ("nearest",), sy, sx)
    t = _band(fake)
    assert t["src"] == (tone.data_ptr(), 0, 0, 0)
    assert t["dst"] == (out.data_ptr(), 0, 0, 0)
    assert t["kind"] == (0, 0, 0, 0) and t["f"] == (3, 0, 0, 0)
    assert t["stride"] == (4, 0, 0, 0)
    assert (t["n_src"], t["h"], t["w"], t["hs"]) == (1, h, w, h)
    blocks = torch.zeros(2, dtype=torch.int32)
    warp_band.warp_band([tone[..., :3]], ("nearest",), sy, sx,
                        blocks=blocks)
    assert _band(fake)["blocks"] == blocks.data_ptr()
    with pytest.raises(TypeError):
        warp_band.warp_band([tone[..., :3]], ("nearest",), sy, sx,
                            blocks=blocks.float())


def test_multi_call_table(fake):
    """SMAA's G-buffer call (kernel 12): one bf16 nearest reduce over the
    4 channels of a contiguous source at twice the output size; and two
    reduces with offsets and channel ranges over a 16-channel source."""
    h, w = 6, 8
    pg = torch.rand(2 * h, 2 * w, 4)
    sy, sx = torch.rand(h, w), torch.rand(h, w)
    out, = warp2.warp_multi(pg, sy, sx, [("nearest", (0.0, 0.0), (0, 4))],
                            dtype=torch.bfloat16)
    t = _multi(fake)
    assert t["src"] == pg.data_ptr()
    assert t["dst"] == (out.data_ptr(), 0, 0, 0)
    assert (t["sy"], t["sx"]) == (sy.data_ptr(), sx.data_ptr())
    assert (t["kind"], t["lo"], t["hi"]) == ((0, 0, 0, 0), (0, 0, 0, 0),
                                             (4, 0, 0, 0))
    assert (t["offy"], t["offx"]) == ((0.0,) * 4, (0.0,) * 4)
    assert (t["n_red"], t["hs"], t["ws"], t["p"], t["h"], t["w"],
            t["bf16"]) == (1, 2 * h, 2 * w, 4, h, w, 1)

    src = torch.rand(h, w, 16)
    outs = warp2.warp_multi(src, sy, sx, [("catmull", (0.5, -1.0), (2, 5)),
                                          ("nearest", (1.0, 0.25), (8, 16))])
    assert [tuple(o.shape) for o in outs] == [(h, w, 3), (h, w, 8)]
    t = _multi(fake)
    assert t["dst"] == (outs[0].data_ptr(), outs[1].data_ptr(), 0, 0)
    assert (t["kind"], t["lo"], t["hi"]) == ((2, 0, 0, 0), (2, 8, 0, 0),
                                             (5, 16, 0, 0))
    assert (t["offy"], t["offx"]) == ((0.5, 1.0, 0.0, 0.0),
                                      (-1.0, 0.25, 0.0, 0.0))
    assert (t["n_red"], t["p"], t["bf16"]) == (2, 16, 0)


def test_second_call_does_not_bind_again(fake):
    """The ctypes binding of an entry point is made at its first call; a
    second call, of the same or the other warp, looks nothing up again."""
    h, w = 6, 8
    src = torch.rand(h, w, 4)
    sy, sx = torch.rand(h, w), torch.rand(h, w)
    for _ in range(3):
        warp_band.warp_band([src], ("nearest",), sy, sx)
    assert fake.lookups == 1
    for _ in range(2):
        warp2.warp_multi(src, sy, sx, [("nearest", (0.0, 0.0), (0, 4))])
    assert fake.lookups == 2
    assert [name for name, _ in fake.calls] == ["hk_warp_band"] * 3 + [
        "hk_warp_multi"] * 2


def test_new_library_binds_anew():
    """Bindings belong to their library object: another library (a fresh
    fake, made after the first was dropped by the test) gets its own
    function."""
    first = CountingLibrary()
    fn = _kernel.bind(first, "hk_warp_band", "tp")
    assert _kernel.bind(first, "hk_warp_band", "tp") is fn
    assert fn.owner is first and first.lookups == 1
    del first, fn
    gc.collect()
    for _ in range(4):
        lib = CountingLibrary()
        fn = _kernel.bind(lib, "hk_warp_band", "tp")
        assert fn.owner is lib and lib.lookups == 1
        assert fn.argtypes == [ctypes.c_char_p, ctypes.c_void_p]
        del lib, fn
        gc.collect()
