"""fps and both 95th percentiles are taken over every frame of the
window, so one stall moves them."""

import numpy as np
import pytest

from portbench.harness.stats import window_metrics


def _frames(n, period, latency, stall_at=None, stall=0.0):
    dispatch, done, t = [], [], 0.0
    for i in range(n):
        if i == stall_at:
            t += stall
        dispatch.append(t)
        done.append(t + latency)
        t += period
    return dispatch, done


def test_steady_window():
    d, c = _frames(200, 0.01, 0.02)
    m = window_metrics(d, c, 0.0, 1.505)
    assert m["frames"] == 149   # completions at 0.02 .. 1.50
    assert m["fps"] == pytest.approx(149 / 1.505)
    assert m["frame_ms_p95"] == pytest.approx(10.0)
    assert m["latency_ms_p95"] == pytest.approx(20.0)


def test_stalls_move_fps_and_the_tails():
    base = window_metrics(*_frames(200, 0.01, 0.02), 0.0, 1.5)
    d, c = _frames(200, 0.01, 0.02)
    d, c = np.array(d), np.array(c)
    for s in range(6, 200, 12):       # a 50 ms hitch every 12th frame
        c[s:] += 0.05
        d[s + 1:] += 0.05
    m = window_metrics(d, c, 0.0, 1.5)
    assert m["fps"] < base["fps"]
    assert m["frame_ms_p95"] == pytest.approx(60.0)
    d2, c2 = _frames(200, 0.01, 0.02)
    c2 = np.array(c2)
    c2[::10] += 0.03                  # one frame in ten held 30 ms longer
    assert window_metrics(d2, c2, 0.0, 1.5)["latency_ms_p95"] == \
        pytest.approx(50.0)
    assert base["latency_ms_p95"] == pytest.approx(20.0)


def test_a_window_without_frames_raises():
    with pytest.raises(RuntimeError):
        window_metrics([0.0], [5.0], 0.0, 1.0)
