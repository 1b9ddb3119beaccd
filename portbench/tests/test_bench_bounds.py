"""The bound arithmetic reproduces PERF.md section 3's bounds."""

import pytest

from portbench.bounds import atrous, light4, walk
from portbench.bounds.peaks import bound_ms


def test_peaks():
    assert bound_ms(3.35e9, 0.0) == (pytest.approx(1.0), "bytes")
    assert bound_ms(0.0, 67e9) == (pytest.approx(1.0), "operations")


def test_kernel_c_levels():
    ms, by = atrous.level_bound_ms(1080 * 1920, 2)
    assert round(ms, 4) == 0.0322 and by == "bytes"
    assert round(atrous.level_bound_ms(540 * 960, 2)[0], 4) == 0.0080


def test_kernel_13_primary_bytes_bound():
    # the city's world-walk tables: bvh_packed 188 KB, tri_pos_flat 105
    # KB, tri_attr 178 KB; 1080p primary rays in full mode
    words = {"bvh_packed": 188e3 / 4, "tri_pos_flat": 105e3 / 4,
             "tri_attr": 178e3 / 4}
    assert round(walk.call_bound_ms("full", 1920 * 1080, words), 4) == 0.0447
    assert walk.RAY_OUT == {"hit": 20, "full": 36, "shadow": 8}


def test_kernel_13_calls_of_a_city_frame():
    calls = [{"mode": "full", "domain": "output", "when": "always"},
             {"mode": "full", "domain": "render",
              "when": "emissive_validation"},
             {"mode": "shadow", "domain": "render",
              "when": "direct_validation"}]
    dom = {"output": 100, "render": 25}
    assert walk.frame_calls(calls, 15, 3, 5, dom) == [
        ("full", 100), ("full", 25), ("shadow", 25)]
    assert walk.frame_calls(calls, 7, 3, 5, dom) == [("full", 100)]


def test_kernel_4_on_path_d():
    # the box (36 triangles, a 2-triangle emissive quad, no sun) at
    # 960x540, indirect tracking: PERF.md's 0.0628 ms (operations)
    ms, by = light4.call_bound_ms(540 * 960, 36, 2, False, 1, 1,
                                  (False, False), False, True)
    assert round(ms, 4) == 0.0628 and by == "operations"


def test_kernel_13_call_table_of_the_city():
    calls = walk.calls_of("city")
    dom = {"output": 4, "render": 1}
    # 4 full + 3 shadow always; frame 15 validates both channels
    assert len(walk.frame_calls(calls, 1, 3, 5, dom)) == 7
    assert len(walk.frame_calls(calls, 15, 3, 5, dom)) == 10
    assert walk.calls_of("minimal") is None


def _walk_ctx(launches, frames):
    from types import SimpleNamespace

    device = [SimpleNamespace(kind="kernel", name="void bvh_kernel<1>(...)",
                              start=0, end=1000) for _ in range(launches)]
    return SimpleNamespace(
        config={"name": "city"}, device=device, frames=frames,
        intervals=(3, 5), domains={"output": 1920 * 1080,
                                   "render": 960 * 540},
        table_words={"bvh_packed": 1000, "tri_pos_flat": 1000,
                     "tri_attr": 1000})


def test_walk_roofline_refuses_launches_the_table_does_not_give():
    from portbench.harness.spec import load_cell

    reader = load_cell("city-orbit").reader("walk_roofline")
    # frames 16 and 17: 7 calls each, frame 18 validates the direct channel
    assert reader.read(_walk_ctx(14, [16, 17])) > 0
    with pytest.raises(ValueError, match="launches"):
        reader.read(_walk_ctx(13, [16, 17]))
    assert reader.read(_walk_ctx(0, [16, 17])) is None
