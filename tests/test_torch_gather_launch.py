"""Kernel 9's launch path on the CPU (csrc/reproj_gather.cu
hk_reproj_gather) with a fake library standing in for the built one: the
packed table the wrapper marshals (GatherCall), the outputs it allocates,
and bad calls raising before a launch."""

from __future__ import annotations

import ctypes

import pytest
import torch

from hikari_tpu_torch import build
from hikari_tpu_torch.ops import reproj_gather
from tests.test_torch_boundary import _FakeLibrary
from tests.torch_threads import one_torch_thread  # noqa: F401

FIELDS = ("s0", "s1", "s2", "s3", "s4", "d0", "d1", "d2", "d3", "d4",
          "piy", "pix", "n_src", "hs", "h", "w", "f")


@pytest.fixture
def fake(monkeypatch):
    lib = _FakeLibrary()
    monkeypatch.setattr(build, "load_cuda", lambda name: lib)
    monkeypatch.setattr(reproj_gather, "on_cpu", lambda t: False)
    monkeypatch.setattr(reproj_gather, "stream",
                        lambda dev: ctypes.c_void_p(0))
    monkeypatch.setattr(reproj_gather.reproj_gather, "launches", 0)
    return lib


def _inputs(n, hs, h, w, f=16):
    srcs = [torch.zeros((hs, f, w)) for _ in range(n)]
    piy = torch.zeros((h, w), dtype=torch.int32)
    pix = torch.zeros((h, w), dtype=torch.int32)
    return srcs, piy, pix


# odd sizes, and sources of another height than the output
@pytest.mark.parametrize("n,hs,h,w", [(1, 3, 3, 5), (3, 7, 7, 33),
                                      (5, 9, 7, 33), (2, 4, 3, 5)])
def test_call_arguments_and_outputs(fake, n, hs, h, w):
    """One packed table (GatherCall): the source pointers in source order
    then nulls, the outputs' pointers in the same order, the coordinates,
    n_src, hs, h, w and f; one [h,16,w] contiguous float32 output per
    source; one launch counted."""
    srcs, piy, pix = _inputs(n, hs, h, w)
    outs = reproj_gather.reproj_gather(srcs, piy, pix)
    assert fake.calls == ["hk_reproj_gather"]
    table, _ = fake.args[0]
    args = dict(zip(FIELDS, reproj_gather.GATHER_TABLE.unpack(table)))
    empty = reproj_gather.MAX_SOURCES - n
    assert [args[f"s{i}"] for i in range(5)] == (
        [s.data_ptr() for s in srcs] + [0] * empty)
    assert [args[f"d{i}"] for i in range(5)] == (
        [o.data_ptr() for o in outs] + [0] * empty)
    assert (args["piy"], args["pix"]) == (piy.data_ptr(), pix.data_ptr())
    assert (args["n_src"], args["hs"], args["h"], args["w"], args["f"]) == (
        n, hs, h, w, 16)
    assert len(outs) == n
    for o in outs:
        assert o.shape == (h, 16, w) and o.dtype == torch.float32
        assert o.is_contiguous()
    assert len({o.data_ptr() for o in outs}) == n
    # views of one allocation
    assert len({o.untyped_storage().data_ptr() for o in outs}) == 1
    assert reproj_gather.reproj_gather.launches == 1


def _bad_calls():
    srcs, piy, pix = _inputs(2, 3, 3, 5)
    six = _inputs(6, 3, 3, 5)[0]
    return [
        ("no sources", ([], piy, pix), ValueError, "0 sources"),
        ("six sources", (six, piy, pix), ValueError, "6 sources"),
        ("float64 source", ([srcs[0].double(), srcs[1]], piy, pix),
         TypeError, "sources"),
        ("int64 piy", (srcs, piy.long(), pix), TypeError, "piy"),
        ("float pix", (srcs, piy, pix.float()), TypeError, "pix"),
        ("sources of two shapes", ([srcs[0], torch.zeros((3, 16, 6))],
                                   piy, pix), ValueError, "sources"),
        ("coordinates of two shapes", (srcs, piy, torch.zeros(
            (3, 6), dtype=torch.int32)), ValueError, "pix"),
        ("a source of another width", ([torch.zeros((3, 16, 6))] * 2, piy,
                                       pix), ValueError, "piy"),
        ("a 2-D source", ([torch.zeros((3, 5))], piy, pix), ValueError,
         "sources"),
        ("a strided source", ([torch.zeros((3, 16, 10))[..., ::2]], piy,
                              pix), ValueError, "contiguous"),
        ("8 planes", ([torch.zeros((3, 8, 5))], piy, pix), ValueError,
         "8 planes"),
    ]


@pytest.mark.parametrize("case", range(len(_bad_calls())),
                         ids=[c[0] for c in _bad_calls()])
def test_bad_calls_raise_before_launch(fake, case):
    _, args, error, match = _bad_calls()[case]
    with pytest.raises(error, match=match):
        reproj_gather.reproj_gather(*args)
    assert fake.calls == [] and reproj_gather.reproj_gather.launches == 0
