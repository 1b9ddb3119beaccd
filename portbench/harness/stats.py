"""The end-to-end metrics of one window, from every frame in it:

* fps: frames whose completion falls in the window, over its seconds;
* frame_ms_p95: the 95th percentile of the intervals between consecutive
  completions of those frames;
* latency_ms_p95: the 95th percentile, over those frames, of the time from
  the start of a frame's dispatch (the host clock before its camera is set)
  to its completion.

Completions are device event times mapped to the host clock by one
anchor event, so both ends of a latency are on one clock."""

from __future__ import annotations

import numpy as np


def p95(values) -> float:
    return float(np.percentile(np.asarray(values, np.float64), 95.0))


def window_metrics(dispatch_s, done_s, t0: float, seconds: float) -> dict:
    """dispatch_s, done_s: per dispatched frame, the host time its dispatch
    started and its completion (host clock); t0: the window's start."""
    dispatch_s = np.asarray(dispatch_s, np.float64)
    done_s = np.asarray(done_s, np.float64)
    inside = (done_s >= t0) & (done_s <= t0 + seconds)
    n = int(inside.sum())
    if n < 3:
        raise RuntimeError(f"only {n} frames completed in the window")
    done = done_s[inside]
    return {
        "frames": n,
        "fps": n / seconds,
        "frame_ms_p95": p95(np.diff(done) * 1e3),
        "latency_ms_p95": p95((done - dispatch_s[inside]) * 1e3),
    }
