"""Tracing and timing (the port of hikari_tpu/utils/profiling.py, in
PyTorch's idiom): named scopes that torch.profiler records, a Chrome trace
of a block, the steady-state time of a function, and a rolling frame
timer."""

from __future__ import annotations

import contextlib
import os
import time

import torch


def pass_scope(name: str):
    """Annotate a pipeline pass: a torch.profiler range named `name`."""
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Profile a block with torch.profiler (the CPU, and CUDA when it is
    available) and write its Chrome trace to log_dir/trace.json (open it
    in chrome://tracing or Perfetto)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                     if torch.cuda.is_available() else [])
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _sync(out):
    """Wait for the CUDA devices of the tensors in `out` (a tensor or a
    tuple, list or dict of them)."""
    if isinstance(out, torch.Tensor):
        if out.is_cuda:
            torch.cuda.synchronize(out.device)
    elif isinstance(out, dict):
        for v in out.values():
            _sync(v)
    elif isinstance(out, (list, tuple)):
        for v in out:
            _sync(v)


def time_fn(fn, *args, iters: int = 10, warmup: int = 1):
    """Steady-state wall time of fn(*args) in ms: `warmup` calls, then the
    mean of `iters` calls, each batch waited for on the devices of its
    output tensors."""
    out = None
    for _ in range(warmup):
        out = fn(*args)
    _sync(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    _sync(out)
    return (time.perf_counter() - t0) / iters * 1e3


class FrameTimer:
    """Rolling per-frame wall-clock stats for interactive loops."""

    def __init__(self, window: int = 60):
        self.window = window
        self.samples = []
        self._last = None

    def tick(self):
        now = time.perf_counter()
        if self._last is not None:
            self.samples.append(now - self._last)
            if len(self.samples) > self.window:
                self.samples.pop(0)
        self._last = now

    @property
    def ms(self) -> float:
        if not self.samples:
            return 0.0
        return sum(self.samples) / len(self.samples) * 1e3
