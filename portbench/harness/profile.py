"""The traced run's reduction: torch.profiler's device activity (kernels,
copies and fills; kernels that a CUDA graph replays are recorded one by
one) and the benchmark's own host spans (record_function ranges named
`portbench.*` around update_scene, render_frame and the event waits), as
plain intervals in nanoseconds on one clock."""

from __future__ import annotations

import dataclasses

HOST_PREFIX = "portbench."


@dataclasses.dataclass
class Activity:
    name: str
    start: int      # ns
    end: int        # ns
    kind: str


def _kind(name: str) -> str:
    if name.startswith("Memcpy"):
        return "gpu_memcpy"
    if name.startswith("Memset"):
        return "gpu_memset"
    return "kernel"


def activities(prof):
    """(device activities, host spans) of a finished profiler run, from
    its events (FunctionEvent times are microseconds on one clock)."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    device, host = [], []
    for e in prof.events():
        start = int(round(e.time_range.start * 1e3))
        end = int(round(e.time_range.end * 1e3))
        if e.name.startswith(HOST_PREFIX) and e.device_type == cuda:
            continue        # the device-side copy of a host span
        if e.device_type == cuda:
            device.append(Activity(e.name, start, end, _kind(e.name)))
        elif e.name.startswith(HOST_PREFIX):
            host.append(Activity(e.name[len(HOST_PREFIX):], start, end,
                                 "host"))
    device.sort(key=lambda a: a.start)
    host.sort(key=lambda a: a.start)
    return device, host


def merged(device):
    """The union of the activities' intervals, as sorted [start, end]."""
    out = []
    for a in device:
        if out and a.start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], a.end)
        else:
            out.append([a.start, a.end])
    return out


def busy_and_span(device, start=None):
    """(busy ns: the union of the device's intervals, span ns: first start
    to last end), over the activities from `start` (ns) on."""
    if start is not None:
        device = [a for a in device if a.start >= start]
    if not device:
        return 0, 0
    busy = sum(e - s for s, e in merged(device))
    return busy, max(a.end for a in device) - device[0].start


def steady_start(host):
    """The end of the first render_frame span: the traced span starts
    after a synchronize, so until the first frame's graph is launched the
    device waits on the host; the steady span starts after it."""
    first = [h.end for h in host if h.name == "render_frame"]
    return min(first) if first else None


def top_ops(device, k: int = 10):
    """The k device operations that took most time: [[name, seconds]]."""
    total = {}
    for a in device:
        total[a.name] = total.get(a.name, 0) + (a.end - a.start)
    ranked = sorted(total.items(), key=lambda kv: -kv[1])[:k]
    return [[name[:160], ns / 1e9] for name, ns in ranked]


def idle_gaps(device, host, k: int = 10):
    """The k longest idle gaps of the device, each named by the host span
    that was open when it began (the innermost; "none" outside every
    span): [[name, seconds]]."""
    spans = merged(device)
    gaps = [(spans[i][1], spans[i + 1][0]) for i in range(len(spans) - 1)]
    gaps.sort(key=lambda g: g[0] - g[1])
    out = []
    for s, e in gaps[:k]:
        inner = [h for h in host if h.start <= s < h.end]
        name = (min(inner, key=lambda h: h.end - h.start).name if inner
                else "none")
        out.append([name, (e - s) / 1e9])
    return out
