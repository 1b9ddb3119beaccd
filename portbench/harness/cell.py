"""One run of one cell: set-up and warm-up, the timed window with two
frames in flight, the traced span (with --trace 1), then the check against
the reference and the result line.

The window drives hikari_tpu_torch's Renderer.render_frame(), which on
CUDA replays the frame's captured graphs. Before each frame the loop sets
the camera and, where the traffic moves the scene, calls
update_scene(fast=True) (the refit's graph). It records a CUDA event
after each frame and, before it dispatches frame i + 2, waits on frame
i's event; nothing else in the window waits for the device."""

from __future__ import annotations

import gc
import time
from types import SimpleNamespace

import numpy as np
import torch

from portbench.harness import profile as prof_mod
from portbench.harness.frames import Frames, to_numpy
from portbench.harness.stats import window_metrics
from portbench.harness.traffic import Traffic
from portbench.reference import compare


class HostEvent:
    """The CPU's stand-in for a CUDA event: CPU work is done when the call
    returns."""

    def record(self):
        self.t = time.perf_counter()

    def synchronize(self):
        pass


def _event(cuda: bool):
    return torch.cuda.Event(enable_timing=True) if cuda else HostEvent()


def _sync(cuda: bool):
    if cuda:
        torch.cuda.synchronize()


class _span:
    """A record_function range named portbench.<name> while tracing."""

    def __init__(self, name, on):
        self.rf = (torch.autograd.profiler.record_function(f"portbench.{name}")
                   if on else None)

    def __enter__(self):
        if self.rf is not None:
            self.rf.__enter__()

    def __exit__(self, *exc):
        if self.rf is not None:
            self.rf.__exit__(*exc)


def run(cell, seed: int, seconds: float, trace: bool, t_start: float,
        device: str = "cuda", api=None, limits=None) -> dict:
    """The result line's object for one run. `api`: the renderer package
    under test (hikari_tpu_torch unless a test hands in another)."""
    if api is None:
        import hikari_tpu_torch as api
    cuda = device == "cuda"
    cfg = cell.config
    desc = cell.scene.build()
    traffic = Traffic(cell.traffic, seed, desc)
    with torch.no_grad():
        frames = Frames(api, cfg, desc, traffic, device)
        r = frames.renderer
        warm = frames.warmup_frames()
        for f in range(warm):
            frames.frame(f)
        _sync(cuda)
        keys = set(r.graph_keys())
        compared = traffic.compared(warm)
        timed = _window(frames, traffic, warm, seconds, trace, cuda,
                        compared, t_start)
        if set(r.graph_keys()) != keys:
            raise RuntimeError("a graph was captured inside the window: "
                               f"{sorted(map(str, set(r.graph_keys()) - keys))}")
    got = {f: to_numpy(timed["kept"][f]) for f in compared}
    result = {"correct": False, "attempted": timed["dispatched"],
              "failed": 0, "metrics": {},
              "device": _device(cuda, int(torch.cuda.max_memory_allocated())
                                if cuda else 0)}
    if trace:
        ctx = _trace_context(cell, desc, r, timed)
        result["metrics"] = _per_layer(cell, ctx)
        result["device"].update(busy_s=ctx.steady_busy_ns / 1e9,
                                window_s=ctx.span_ns / 1e9)
        result["traced_frames"] = len(ctx.frames)
        result["traced_device_ops"] = len(ctx.device)
        result["breakdown"] = {
            "device_ops": prof_mod.top_ops(ctx.device),
            "idle_gaps": prof_mod.idle_gaps(ctx.steady, ctx.host)}
        del ctx
    else:
        values = dict(timed["metrics"], setup_s=timed["setup_s"])
        result["metrics"] = {e["name"]: {"value": values[e["name"]],
                                         "unit": e["unit"]}
                             for e in cell.end_to_end}
        result["frames"] = values["frames"]
    # the port's state is freed before the reference runs on the device
    del frames, r, timed
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    ref = compare.reference_images(cfg, desc,
                                   Traffic(cell.traffic, seed, desc),
                                   compared, device)
    check_s = time.perf_counter() - t_check
    correct, numbers, failed, worst = compare.judge(
        got, ref, cfg["limits"] if limits is None else limits)
    result.update(correct=correct, failed=failed, warmup_frames=warm,
                  compared_frames=compared, differences=worst,
                  check_s=check_s, compared=numbers)
    return result


def _window(frames, traffic, warm, seconds, trace, cuda, compared,
            t_start):
    """Dispatches frames warm, warm + 1, ... until `seconds` have passed
    since the first, `in_flight` at most in flight; with `trace`, the first
    trace_frames of them under torch.profiler (synchronized at both ends,
    with CUDA events around each update_scene)."""
    in_flight = traffic.in_flight
    n_traced = int(traffic.spec.get("trace_frames", 0)) if trace else 0
    keep = set(compared)
    prof = traced = None
    if n_traced:
        prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA] if cuda else [
            torch.profiler.ProfilerActivity.CPU])
        prof.start()
    anchor = _event(cuda)
    anchor.record()
    anchor.synchronize()
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    t_end = t0 + seconds
    events, dispatch, kept, refit = [], [], {}, []
    i = 0
    while True:
        tracing = prof is not None
        if i >= in_flight:
            with _span("wait", tracing):
                events[i - in_flight].synchronize()
        t = time.perf_counter()
        if t >= t_end:
            break
        f = warm + i
        dispatch.append(t)
        frames.pose(f)
        with _span("update_scene", tracing):
            if tracing and traffic.update_scene:
                a, b = _event(cuda), _event(cuda)
                a.record()
                frames.move(f)
                b.record()
                refit.append((a, b))
            else:
                frames.move(f)
        with _span("render_frame", tracing):
            img = frames.render(f)
        ev = _event(cuda)
        ev.record()
        events.append(ev)
        if f in keep:
            kept[f] = img
        i += 1
        if prof is not None and i == n_traced:
            _sync(cuda)
            prof.stop()
            traced = (prof, list(range(warm, warm + i)))
            prof = None
    if prof is not None:
        _sync(cuda)
        prof.stop()
        traced = (prof, list(range(warm, warm + i)))
    _sync(cuda)
    if cuda:
        done = [t0 + anchor.elapsed_time(e) / 1e3 for e in events]
        refit_ms = [a.elapsed_time(b) for a, b in refit]
    else:
        done = [e.t for e in events]
        refit_ms = [(b.t - a.t) * 1e3 for a, b in refit]
    missing = keep - set(kept)
    if missing:
        raise RuntimeError(f"the window ended before frames {sorted(missing)}"
                           " that the check compares")
    out = {"kept": kept, "setup_s": setup_s, "refit_ms": refit_ms,
           "dispatched": i, "traced": traced}
    if not n_traced:
        out["metrics"] = window_metrics(dispatch, done, t0, seconds)
    return out


def _trace_context(cell, desc, renderer, timed):
    """What the per-layer readers read (portbench/metrics)."""
    prof, traced_frames = timed["traced"]
    device, host = prof_mod.activities(prof)
    busy, _ = prof_mod.busy_and_span(device)
    steady = prof_mod.steady_start(host)
    steady_busy, span = prof_mod.busy_and_span(device, steady)
    cfg = cell.config
    settings = renderer.settings
    h, w = cfg["height"], cfg["width"]
    ratio = float(settings.upscale.clamped_ratio)
    rh, rw = int(round(h / ratio)), int(round(w / ratio))
    emissive = {i for i, m in enumerate(desc.materials)
                if max(m.get("emissive", (0, 0, 0, 0))[:3]) > 0
                and m.get("emissive", (0, 0, 0, 0))[3] > 0}
    em_inst = [m for m, mat, _ in desc.instances if mat in emissive]
    arrays = renderer.gpu_scene.arrays
    return SimpleNamespace(
        device=device, host=host, busy_ns=busy,
        steady_busy_ns=steady_busy, span_ns=span,
        steady=[a for a in device if steady is None or a.start >= steady],
        frames=traced_frames, refit_ms=timed["refit_ms"], config=cfg,
        intervals=(int(settings.direct_validate_interval),
                   int(settings.emissive_validate_interval)),
        domains={"output": h * w, "render": rh * rw},
        table_words={k: int(np.asarray(v).size) for k, v in arrays.items()},
        facts=dict(n_tri=desc.num_triangles,
                   n_em_tri=sum(desc.meshes[m].num_triangles
                                for m in em_inst),
                   n_em=len(em_inst), has_sun=desc.sun["illuminance"] > 0,
                   bounces=int(settings.indirect_bounces)))


def _per_layer(cell, ctx) -> dict:
    out = {}
    for m in cell.per_layer:
        value = cell.reader(m["name"]).read(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def _device(cuda: bool, peak: int) -> dict:
    if not cuda:
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1, "memory_peak_bytes": peak}
