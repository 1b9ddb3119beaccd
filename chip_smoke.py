"""On-card smoke test of hikari_tpu_torch (the PyTorch + CUDA port).

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py [--profile]

1. prints the card's name and power limit (nvidia-smi);
2. builds the five CUDA libraries from hikari_tpu_torch/csrc/ (one nvcc
   each, started together) and prints their register and spill counts;
3. holds kernels A, B and C against their plain PyTorch versions on the
   card at the 1080p flagship shapes of the no-reuse frame;
4. drives the reuse paths at 1080p with the camera panning 1.5 px per
   frame and holds each kernel against its plain version on the inputs it
   really got: kernel 9 (the reprojection gather) bit for bit, kernel 4
   (temporal lighting) on a validation and a no-validation frame with the
   tracking outputs on (path S) and off (path R), kernel 10 (the spatial
   pass) on both channels, and kernel C on path R's real variance;
5. runs the directional branch of kernels 4 and 10 on the box with a sun
   at 270x480;
6. checks small CUDA renders of the three paths against the plain
   versions on the CPU;
7. renders the box through Renderer at 1920x1080 on the three paths
   (no reuse; temporal reuse R; temporal + spatial reuse S): 3 warm-up
   frames, then timed frames with the launch counters set to 0, which
   must rise by exactly 1/1/4 (prepass, lighting, a-trous), 1/1/1/4
   (prepass, gather, lighting, a-trous) and 1/1/1/2/4 (+ spatial) per
   frame;
8. prints frame_ms_1080p, frame_ms_reuse and frame_ms_spatial, one JSON
   line of per-kernel numbers, and last {"ok": true, "device": {...}}.

Tolerances: kernels A, B, C as stated at their checks; kernel 9 bit for
bit; kernels 4 and 10: >= 99% of pixels with all 16 packed words equal,
and >= 99% of render and variance values within 1e-3 * max(|ref|, 1)
(NaN-coded variances NaN at the same pixels).

With --profile it also prints a torch.profiler table of device time by
kernel over two frames of each path. Any failed check raises: the exit
code is then not 0 and the last line is not printed. Without CUDA it exits
1 at once.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))

FULL = (1080, 1920)   # (height, width) of the flagship frame
SUN = (270, 480)      # the directional-branch check
SMALL = (48, 64)
WARMUP_FRAMES = 3
TIMED_FRAMES = 10
REPS = 20             # kernel timing repetitions
PLAIN_REPS = 3
PAN_PX = 1.5          # camera motion per frame of the reuse checks
# frames of the reuse checks: frame 4 validates nothing, frame 5 the
# emissive channel, frame 6 the direct one (intervals 3 and 5)
CHECK_FRAMES = 7

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): HBM3 bytes/s and
# the f32 rate outside the tensor cores, which these kernels use.
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
# Floating-point operations of one ray-triangle test (Moller-Trumbore
# with its accept tests, as written in csrc/common.cuh): the unit of the
# operation counts below.
FLOPS_PER_TRI_TEST = 60
# per-pixel allowances of the reservoir algebra (unpack, gates, WRS,
# finalize, repack) and of one spatial tap (unpack, march, gates,
# Jacobian, WRS; + one Burley/GGX shading for the indirect channel)
FLOPS_RESERVOIR = 300
FLOPS_TAP = 150
FLOPS_SHADE = 110


def fail(msg):
    raise RuntimeError(msg)


def load_box_module():
    """tests/cornell_box.py by path (an installed package named `tests`
    would shadow the repository's directory on import)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "cornell_box", os.path.join(HERE, "tests", "cornell_box.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def event_ms(fn, reps):
    """Median milliseconds of fn() over `reps` runs, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def bound_ms(nbytes, flops):
    return max(nbytes / PEAK_BYTES, flops / PEAK_F32) * 1e3, (
        "bytes" if nbytes / PEAK_BYTES >= flops / PEAK_F32 else "operations")


def rel_close(got, ref, rtol):
    """Fraction of values within rtol * max(|ref|, 1), and the max abs
    error (NaN at the same places counts as equal)."""
    got, ref = got.float(), ref.float()
    both_nan = torch.isnan(got) & torch.isnan(ref)
    d = torch.where(both_nan, 0.0, (got - ref).abs())
    ok = both_nan | (d <= rtol * torch.clamp(ref.abs(), min=1.0))
    return float(ok.float().mean()), float(torch.nan_to_num(d, nan=1e30).max())


def planes_equal(got, ref):
    """Fraction of pixels of [h,16,w] planes with all 16 words equal."""
    return float((got.view(torch.int32) == ref.view(torch.int32))
                 .all(1).float().mean())


def bf16_ulps(a, b):
    """Distance in bf16 units in the last place between two bf16 tensors."""
    def ordered(t):
        bits = t.view(torch.int16).to(torch.int32)
        return torch.where(bits < 0, -(bits & 0x7FFF), bits)

    return (ordered(a) - ordered(b)).abs()


def ssim(a, b):
    """Mean SSIM of two [H,W,3] images in [0,1] over 7x7 windows."""
    import torch.nn.functional as F

    x = torch.as_tensor(a).permute(2, 0, 1)[None].double()
    y = torch.as_tensor(b).permute(2, 0, 1)[None].double()

    def mean(t):
        return F.avg_pool2d(t, 7, 1)

    mx, my = mean(x), mean(y)
    vx = mean(x * x) - mx * mx
    vy = mean(y * y) - my * my
    cxy = mean(x * y) - mx * my
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    s = ((2 * mx * my + c1) * (2 * cxy + c2)
         / ((mx * mx + my * my + c1) * (vx + vy + c2)))
    return float(s.mean())


def flagship_settings(ht, **changes):
    """bench.py's flagship (no reuse, 1 bounce, denoise, no TAA, no
    upscale) with `changes` on top."""
    base = dict(temporal_reuse=False, denoise=True, indirect_bounces=1,
                taa=ht.Taa.NONE, upscale=ht.Upscale.none(),
                emissive_spatial_reuse=False, indirect_spatial_reuse=False,
                checkerboard_lighting=False)
    return dataclasses.replace(ht.HikariSettings(), **{**base, **changes})


# the three paths: settings changes over the flagship, and the launches
# per frame of (prepass, gather, lighting, spatial, a-trous)
PATHS = {
    "no-reuse": ({}, (1, 0, 1, 0, 4)),
    "R": ({"temporal_reuse": True}, (1, 1, 1, 0, 4)),
    "S": ({"temporal_reuse": True, "emissive_spatial_reuse": True,
           "indirect_spatial_reuse": True}, (1, 1, 1, 2, 4)),
}


def real_tris(t):
    return int((t[:, 9] >= 0).sum())


def tri_tests(gpu, has_sun, n_em, bounces, validation=(False, False)):
    """Ray-triangle tests per pixel of one lighting launch: solar shadow;
    emissive probe + shadow; per bounce the bounce and its NEE; and the
    validation retraces of this frame."""
    n_tri = real_tris(gpu.arrays["tri_pos_flat"])
    n_em_tri = real_tris(gpu.arrays["em_tri_pos_flat"])
    tests = 0
    if has_sun:
        tests += n_tri * (1 + validation[0])
    if n_em > 0:
        tests += (n_em_tri + n_tri) * (1 + validation[1])
    if bounces > 0:
        nee = (n_em_tri if n_em > 0 else 0) + n_tri
        tests += bounces * (n_tri + nee)
    return tests


def check_kernels(ht, scene_host):
    """Kernels A, B, C vs plain at 1080p on the box's first no-reuse
    frame. Returns the per-kernel records (launches filled in later)."""
    from hikari_tpu_torch.camera import view_to_device
    from hikari_tpu_torch.config import make_frame_uniform
    from hikari_tpu_torch.ops import denoise as dn
    from hikari_tpu_torch.ops import denoise_fused as dnf
    from hikari_tpu_torch.ops import light_fused as lf
    from hikari_tpu_torch.ops import prepass_fused as pf
    from hikari_tpu_torch.ops.noise import noise_constant, sample_blue_noise

    box = load_box_module()

    dev = torch.device("cuda")
    h, w = FULL
    npix = h * w
    gpu = scene_host.compile()
    scene = gpu.as_pytree(dev)
    cam = ht.Camera.from_look_at(box.EYE, box.TARGET, width=w, height=h)
    view = view_to_device(cam.view_uniform(), dev)
    settings = flagship_settings(ht)
    frame = make_frame_uniform(settings, 0)
    records = []
    n_tri = real_tris(gpu.arrays["tri_pos_flat"])

    # --- kernel A
    params = pf.pack_params(view, view, (0.0, 0.0), FULL)
    a_args = (params, scene["tri_pos_flat"], scene["tri_attr"],
              scene["inst_motion"], scene["mat_packed"], FULL)
    got = pf.prepass_kernel(*a_args)
    ref = pf.prepass_plain(*a_args)
    torch.cuda.synchronize()
    ids_eq = float((got[2] == ref[2]).all(-1).float().mean())
    fracs, max_err = [], 0.0
    for i in (0, 1, 3, 4):
        frac, err = rel_close(got[i], ref[i], 1e-4)
        fracs.append(frac)
        max_err = max(max_err, err)
    print(f"kernel A prepass: ids equal on {ids_eq:.6f} of pixels (need "
          f">= 0.995); float planes within 1e-4*max(|ref|,1) on "
          f"{min(fracs):.6f} of values (need >= 0.99); max abs err "
          f"{max_err:.3g}")
    if ids_eq < 0.995 or min(fracs) < 0.99:
        fail("kernel A disagrees with its plain version")
    ms = event_ms(lambda: pf.prepass_kernel(*a_args), REPS)
    plain_ms = event_ms(lambda: pf.prepass_plain(*a_args), PLAIN_REPS)
    nbytes = 4 * (params.numel() + sum(t.numel() for t in a_args[1:5])
                  + npix * (4 + 3 + 2 + 4 + 4))
    flops = npix * (n_tri * FLOPS_PER_TRI_TEST + 250)
    b_ms, b_by = bound_ms(nbytes, flops)
    records.append(dict(
        name="prepass_fused", route="cuda",
        source="hikari_tpu_torch/csrc/prepass_fused.cu",
        replaces="hikari_tpu/ops/prepass_fused.py:78", launches=None,
        max_abs_err=max_err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=None))
    gbuf, albedo = pf._assemble(*got)

    # --- kernel B
    noise = noise_constant(dev)
    rand = sample_blue_noise(noise, 0, FULL)
    n_em = gpu.num_emissives
    lparams = lf.pack_params(scene, view, frame, n_em, gpu.has_sun)
    b_args = (lparams, scene["tri_pos_flat"], scene["tri_attr"],
              scene["em_tri_pos_flat"], scene["em_tri_attr"],
              scene["mat_packed"], gbuf["position"], gbuf["normal"],
              gbuf["instance_material"], rand)
    b_kw = dict(has_sun=gpu.has_sun, n_em=n_em,
                n_alias=scene["alias_packed"].shape[0],
                bounces=settings.indirect_bounces)
    got = lf.lighting_kernel(*b_args, **b_kw)
    ref = lf.lighting_plain(*b_args, **b_kw)
    torch.cuda.synchronize()
    fracs, max_err = [], 0.0
    for k in ref:
        frac, err = rel_close(got[k], ref[k], 1e-3)
        fracs.append(frac)
        max_err = max(max_err, err)
    print(f"kernel B lighting: within 1e-3*max(|ref|,1) on {min(fracs):.6f} "
          f"of values (need >= 0.99); max abs err {max_err:.3g}")
    if min(fracs) < 0.99:
        fail("kernel B disagrees with its plain version")
    ms = event_ms(lambda: lf.lighting_kernel(*b_args, **b_kw), REPS)
    plain_ms = event_ms(lambda: lf.lighting_plain(*b_args, **b_kw),
                        PLAIN_REPS)
    n_out = len(got)
    nbytes = 4 * (lparams.numel() + sum(t.numel() for t in b_args[1:6])
                  + npix * (4 + 3 + 2 + 4) + npix * 4 * n_out)
    tests = tri_tests(gpu, b_kw["has_sun"], n_em, b_kw["bounces"])
    flops = npix * (tests * FLOPS_PER_TRI_TEST + 400 * n_out)
    b_ms, b_by = bound_ms(nbytes, flops)
    records.append(dict(
        name="light_fused", route="cuda",
        source="hikari_tpu_torch/csrc/light_fused.cu",
        replaces="hikari_tpu/ops/light_fused.py:592", launches=None,
        max_abs_err=max_err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=None))

    # --- kernel C: the 4 levels on the frame's demodulated e/i channels
    chans = [got["e_render"], got["i_render"]]
    zero_var = torch.zeros(FULL, device=dev)
    irrs, variances = [], []
    for r_ in chans:
        irr_c, var_c = dn.demodulate(albedo, r_, zero_var, FULL)
        irrs.append(irr_c)
        variances.append(var_c)
    from hikari_tpu_torch.utils.math import normalize

    nch = len(chans)
    irr, geo, f32s = dnf.level_stacks(
        irrs, variances, normalize(gbuf["normal"]), gbuf["depth_gradient"],
        gbuf["position"][..., 3], gbuf["instance_material"][..., 0])
    ffs = (True,) * nch
    level_calls = []
    level_in = irr
    for step in dn.STEPS:
        kw = dict(step=step, nch=nch, ffs=ffs)
        level_calls.append(((level_in, geo, f32s), kw))
        level_in = dnf.atrous_level(level_in, geo, f32s, **kw)
    max_err = check_levels(dnf, level_calls, "zero variance")

    def cascade(level):
        x = irr
        for step in dn.STEPS:
            x = level(x, geo, f32s, step=step, nch=nch, ffs=ffs)
        return x

    ms = event_ms(lambda: cascade(dnf.atrous_level), REPS) / len(dn.STEPS)
    plain_ms = event_ms(lambda: cascade(dnf.atrous_plain),
                        PLAIN_REPS) / len(dn.STEPS)
    nbytes = npix * (2 * 3 * nch + 2 * (2 + nch) + 4 * 5 + 2 * 3 * nch)
    flops = npix * (8 * (20 + 25 * nch) + 30 * nch)
    b_ms, b_by = bound_ms(nbytes, flops)
    records.append(dict(
        name="denoise_fused", route="cuda",
        source="hikari_tpu_torch/csrc/denoise_fused.cu",
        replaces="hikari_tpu/ops/denoise_fused.py:60", launches=None,
        max_abs_err=max_err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=None))
    return records


def check_levels(dnf, calls, what):
    """Each captured a-trous level against its plain version on the same
    input: <= 1 bf16 ulp on >= 99.9% of values. Returns the max abs
    error."""
    worst_frac, max_err, max_ulp = 1.0, 0.0, 0
    for args, kw in calls:
        g_ = dnf.atrous_level(*args, **kw)
        r_ = dnf.atrous_plain(*args, **kw)
        torch.cuda.synchronize()
        ulps = bf16_ulps(g_, r_)
        worst_frac = min(worst_frac, float((ulps <= 1).float().mean()))
        max_ulp = max(max_ulp, int(ulps.max()))
        max_err = max(max_err, float((g_.float() - r_.float()).abs().max()))
    print(f"kernel C a-trous ({what}, {len(calls)} levels): <= 1 bf16 ulp "
          f"on {worst_frac:.6f} of values (need >= 0.999); max {max_ulp} "
          f"ulp, max abs err {max_err:.3g}")
    if worst_frac < 0.999:
        fail(f"kernel C disagrees with its plain version ({what})")
    return max_err


class Capture:
    """Records the calls of a kernel wrapper (module attribute `name` of
    `mod`) made while it is installed, and passes them on."""

    def __init__(self, mod, name):
        self.mod, self.name = mod, name
        self.fn = getattr(mod, name)
        self.calls = []
        self.on = False

    def __enter__(self):
        def wrapper(*a, **k):
            if self.on:
                self.calls.append((a, k))
            return self.fn(*a, **k)

        # the wrapper counts its launches through its module name, which
        # now names this stand-in: those counts land here
        wrapper.launches = 0
        setattr(self.mod, self.name, wrapper)
        return self

    def __exit__(self, *exc):
        setattr(self.mod, self.name, self.fn)


def drive(ht, scene_host, size, changes, frames, captures, keep):
    """Renders `frames` frames of the box at `size` with the camera
    panning PAN_PX per frame, recording the kernel calls of the frames in
    `keep`."""
    box = load_box_module()
    h, w = size
    step = PAN_PX * 2.0 * 3.2 * np.tan(np.pi / 8.0) / h
    r = None
    for i in range(frames):
        d = np.array([step * i, 0.0, 0.0])
        cam = ht.Camera.from_look_at(tuple(np.add(box.EYE, d)),
                                     tuple(np.add(box.TARGET, d)),
                                     width=w, height=h)
        if r is None:
            r = ht.Renderer(scene_host, cam, flagship_settings(ht, **changes))
        r.camera = cam
        for c in captures:
            c.on = i in keep
        r.render_frame()
    torch.cuda.synchronize()
    return r


def compare_outputs(what, got, ref):
    """Kernel 4/10 tolerance: planes equal on >= 99% of pixels, renders
    and variances within 1e-3 * max(|ref|,1) on >= 99% of values."""
    worst_planes, worst_vals, max_err = 1.0, 1.0, 0.0
    for k in ref:
        if ref[k].dim() == 3 and ref[k].shape[1] == 16:
            worst_planes = min(worst_planes, planes_equal(got[k], ref[k]))
        else:
            frac, err = rel_close(got[k], ref[k], 1e-3)
            worst_vals = min(worst_vals, frac)
            max_err = max(max_err, err)
    print(f"  {what}: packed planes equal on {worst_planes:.6f} of pixels, "
          f"values within tolerance on {worst_vals:.6f}; max abs err "
          f"{max_err:.3g}")
    if worst_planes < 0.99 or worst_vals < 0.99:
        fail(f"{what} disagrees with its plain version")
    return max_err


def check_lighting_calls(lf, calls, label):
    """Kernel 4 vs plain on captured calls; returns the max abs error."""
    max_err = 0.0
    for a, k in calls:
        got = lf.lighting_kernel(*a, **k)
        ref = lf.lighting_plain(*a, **k)
        torch.cuda.synchronize()
        p = a[0].cpu().numpy()
        what = (f"kernel 4 {label} (validation {k['validation']}, flags "
                f"d/e {p[lf._P_VAL]:.0f}/{p[lf._P_VAL + 1]:.0f}, tracking "
                f"{k['track_de']}/{k['track_ind']})")
        max_err = max(max_err, compare_outputs(what, got, ref))
    return max_err


def check_spatial_calls(sf, calls, label):
    max_err = 0.0
    for a, k in calls:
        got = dict(zip(("render", "variance", "planes"),
                       sf.spatial_kernel(*a, **k)))
        ref = dict(zip(("render", "variance", "planes"),
                       sf.spatial_plain(*a, **k)))
        torch.cuda.synchronize()
        what = (f"kernel 10 {label} "
                f"({'emissive' if k['emissive_lit'] else 'indirect'})")
        max_err = max(max_err, compare_outputs(what, got, ref))
    return max_err


def check_reuse(ht, build_box):
    """Kernels 9, 4, 10 (and C on real variance) against their plain
    versions on the inputs the reuse paths give them at 1080p, and the
    directional branch at 270x480. Returns the records of 9, 4, 10."""
    from hikari_tpu_torch import frame as fr
    from hikari_tpu_torch.ops import denoise_fused as dnf
    from hikari_tpu_torch.ops import light_fused as lf
    from hikari_tpu_torch.ops import reproj_gather as rg
    from hikari_tpu_torch.ops import spatial_fused as sf

    h, w = FULL
    npix = h * w
    box_host = build_box()
    gpu = box_host.compile()
    caps = [Capture(fr, "reproj_gather"), Capture(lf, "lighting_kernel"),
            Capture(sf, "spatial_kernel")]
    keep = (CHECK_FRAMES - 3, CHECK_FRAMES - 2)      # frames 4 and 5
    with caps[0], caps[1], caps[2]:
        drive(ht, box_host, FULL, PATHS["S"][0], CHECK_FRAMES - 1, caps,
              keep)
    gather_calls, light_s, spatial_s = (c.calls for c in caps)

    # --- kernel 9: bit for bit
    for a, _ in gather_calls:
        got = rg.reproj_gather(*a)
        ref = rg.gather_plain(*a)
        torch.cuda.synchronize()
        eq = min(float((g_.view(torch.int32) == r_.view(torch.int32))
                       .float().mean()) for g_, r_ in zip(got, ref))
        moved = float((a[2] != torch.arange(w, device=a[2].device))
                      .float().mean())
        print(f"kernel 9 gather ({len(a[0])} sources, {moved:.3f} of pixels "
              f"reproject off their column): words equal on {eq:.6f} "
              f"(need 1)")
        if eq != 1.0:
            fail("kernel 9 disagrees with its plain version")
    srcs, piy, pix = gather_calls[-1][0]
    ms = event_ms(lambda: rg.reproj_gather(srcs, piy, pix), REPS)
    plain_ms = event_ms(lambda: rg.gather_plain(srcs, piy, pix), PLAIN_REPS)
    # yardstick: one PyTorch indexing call fetching the same 64 B rows, on
    # the sources as [n, hs*w + 1, 16] rows with a zero row for rejects
    n = len(srcs)
    rows = torch.cat([torch.stack(srcs).permute(0, 1, 3, 2).reshape(
        n, h * w, 16), torch.zeros((n, 1, 16), device=piy.device)], 1)
    ok = (piy >= 0) & (piy < h) & (pix >= 0) & (pix < w)
    idx = torch.where(ok, piy * w + pix, h * w).reshape(-1)
    lib_ms = event_ms(lambda: rows[:, idx], REPS)
    nbytes = n * npix * 16 * 4 * 2 + npix * 8
    b_ms, b_by = bound_ms(nbytes, 0)
    rec9 = dict(
        name="reproj_gather", route="cuda",
        source="hikari_tpu_torch/csrc/reproj_gather.cu",
        replaces="hikari_tpu/ops/reproj_gather.py:80", launches=None,
        max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=lib_ms)

    # --- kernel 4 with tracking (S) on a no-validation and a validation
    # frame, then without tracking (R)
    err4 = check_lighting_calls(lf, light_s, "path S")
    caps = [Capture(lf, "lighting_kernel"), Capture(dnf, "atrous_level")]
    with caps[0], caps[1]:
        drive(ht, box_host, FULL, PATHS["R"][0], CHECK_FRAMES - 1, caps,
              keep)
    light_r, levels_r = caps[0].calls, caps[1].calls
    err4 = max(err4, check_lighting_calls(lf, light_r, "path R"))
    check_levels(dnf, levels_r[-4:], "path R's real variance")

    def light_record(a, k):
        ms_ = event_ms(lambda: lf.lighting_kernel(*a, **k), REPS)
        plain_ = event_ms(lambda: lf.lighting_plain(*a, **k), PLAIN_REPS)
        p = a[0].cpu().numpy()
        val = (bool(p[lf._P_VAL]), bool(p[lf._P_VAL + 1]))
        n_de = int(k["has_sun"]) + int(k["n_em"] > 0)
        n_ch = n_de + int(k["bounces"] > 0)
        # per active channel: render, var, packed; flags + scatter only for
        # active d/e channels under track_de, i_flags only under track_ind
        out_b = (4 * (4 + 1 + 16) * n_ch + 4 * (1 + 16) * n_de * k["track_de"]
                 + 4 * int(k["bounces"] > 0) * k["track_ind"])
        nbytes = npix * (4 * (4 + 3 + 2 + 4) + 64 * n_ch + out_b)
        tests = tri_tests(gpu, k["has_sun"], k["n_em"], k["bounces"], val)
        flops = npix * (tests * FLOPS_PER_TRI_TEST
                        + (400 + FLOPS_RESERVOIR) * n_ch)
        return ms_, plain_, bound_ms(nbytes, flops)

    (a_nv, k_nv), (a_v, k_v) = light_s
    ms4, plain4, (b4, by4) = light_record(a_nv, k_nv)
    ms4v, plain4v, (b4v, _) = light_record(a_v, k_v)
    print(f"  kernel 4 path S: {ms4:.4f} ms (no validation, bound "
          f"{b4:.4f}), {ms4v:.4f} ms (emissive validation, bound "
          f"{b4v:.4f}); plain {plain4:.1f} / {plain4v:.1f} ms")
    rec4 = dict(
        name="light_fused_temporal", route="cuda",
        source="hikari_tpu_torch/csrc/light_fused.cu",
        replaces="hikari_tpu/ops/light_fused.py:592", launches=None,
        max_abs_err=err4, ms=ms4, plain_ms=plain4, bound_ms=b4,
        bound_by=by4, library_ms=None, ms_validation=ms4v,
        plain_ms_validation=plain4v, bound_ms_validation=b4v)

    # --- kernel 10, both channels of the last captured S frame
    err10 = check_spatial_calls(sf, spatial_s, "path S")
    per = []
    for a, k in spatial_s[-2:]:
        ms_ = event_ms(lambda: sf.spatial_kernel(*a, **k), REPS)
        plain_ = event_ms(lambda: sf.spatial_plain(*a, **k), PLAIN_REPS)
        # the taps this frame's data evaluates: valid pixels whose tap
        # lands in the image
        p = a[0].cpu().numpy()
        valid = a[4][..., 3] >= 1.1920929e-7
        n_taps = sf.channel_taps(k["emissive_lit"])[0]
        taps = 0
        for t in range(n_taps):
            oy, ox = (int(v) for v in p[sf._S_TAPS + sf._TAP_STRIDE * t:
                                        sf._S_TAPS + sf._TAP_STRIDE * t + 2])
            taps += int(valid[max(0, -oy):h - max(0, oy),
                              max(0, -ox):w - max(0, ox)].sum())
        per_tap = FLOPS_TAP + (0 if k["emissive_lit"] else FLOPS_SHADE)
        flops = npix * (FLOPS_RESERVOIR + FLOPS_SHADE) + taps * per_tap
        nbytes = npix * (64 + 64 + 16 + 4 + 16 + 4 + 64)
        per.append((ms_, plain_, bound_ms(nbytes, flops)))
        print(f"  kernel 10 {'emissive' if k['emissive_lit'] else 'indirect'}"
              f": {ms_:.4f} ms, plain {plain_:.1f} ms, bound "
              f"{per[-1][2][0]:.4f} ms ({per[-1][2][1]}), {taps} taps")
    rec10 = dict(
        name="spatial_fused", route="cuda",
        source="hikari_tpu_torch/csrc/spatial_fused.cu",
        replaces="hikari_tpu/ops/spatial_fused.py:150", launches=None,
        max_abs_err=err10, ms=float(np.mean([p[0] for p in per])),
        plain_ms=float(np.mean([p[1] for p in per])),
        bound_ms=float(np.mean([p[2][0] for p in per])),
        bound_by=per[-1][2][1], library_ms=None,
        ms_emissive=per[0][0], ms_indirect=per[1][0])

    # --- the directional branch: the box with a sun, path S at 270x480
    sun_host = build_box()
    sun_host.directional_light = type(sun_host.directional_light)(
        illuminance=10000.0, direction=(0.25, -0.5, -1.0))
    caps = [Capture(lf, "lighting_kernel"), Capture(sf, "spatial_kernel")]
    with caps[0], caps[1]:
        r = drive(ht, sun_host, SUN, PATHS["S"][0], CHECK_FRAMES, caps,
                  (CHECK_FRAMES - 3, CHECK_FRAMES - 2, CHECK_FRAMES - 1))
    if not r.gpu_scene.has_sun:
        fail("the sun scene has no sun")
    check_lighting_calls(lf, caps[0].calls, "sun 270x480")
    check_spatial_calls(sf, caps[1].calls, "sun 270x480")
    return [rec9, rec4, rec10]


def check_small_render(ht, build_box):
    """Small CUDA renders of the three paths against the plain versions on
    the CPU."""
    box = load_box_module()
    h, w = SMALL
    cam = ht.Camera.from_look_at(box.EYE, box.TARGET, width=w, height=h)
    for name, (changes, _) in PATHS.items():
        frames = 3 if name == "no-reuse" else 4
        settings = flagship_settings(ht, **changes)
        img_gpu = ht.Renderer(build_box(), cam, settings).render(frames)
        img_cpu = ht.Renderer(build_box(), cam, settings,
                              device="cpu").render(frames)
        s = ssim(np.clip(img_gpu[..., :3], 0, 1),
                 np.clip(img_cpu[..., :3], 0, 1))
        mad = float(np.abs(img_gpu - img_cpu).mean())
        print(f"small render {name} {h}x{w}, {frames} frames, CUDA vs CPU "
              f"plain: SSIM {s:.5f} (need >= 0.98), mean abs diff {mad:.3g} "
              f"(need < 1e-3)")
        if not np.isfinite(img_gpu).all() or s < 0.98 or mad >= 1e-3:
            fail(f"the CUDA render of {name} disagrees with the CPU plain "
                 "render")


def main_path(ht, build_box, name, timed, profile):
    """One path through Renderer at 1080p. Returns (frame times, launch
    counts per wrapper over the timed frames)."""
    from hikari_tpu_torch.ops import denoise_fused as dnf
    from hikari_tpu_torch.ops import light_fused as lf
    from hikari_tpu_torch.ops import prepass_fused as pf
    from hikari_tpu_torch.ops import reproj_gather as rg
    from hikari_tpu_torch.ops import spatial_fused as sf

    box = load_box_module()
    changes, per_frame = PATHS[name]
    h, w = FULL
    cam = ht.Camera.from_look_at(box.EYE, box.TARGET, width=w, height=h)
    r = ht.Renderer(build_box(), cam, flagship_settings(ht, **changes))
    for _ in range(WARMUP_FRAMES):
        r.render_frame()
    torch.cuda.synchronize()
    wrappers = (pf.prepass_kernel, rg.reproj_gather, lf.lighting_kernel,
                sf.spatial_kernel, dnf.atrous_level)
    for fn in wrappers:
        fn.launches = 0
    times = []
    img = None
    for _ in range(timed):
        t = time.perf_counter()
        img = r.render_frame()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    counts = [fn.launches for fn in wrappers]
    expected = [timed * k for k in per_frame]
    print(f"path {name}: launches over {timed} frames (prepass, gather, "
          f"lighting, spatial, a-trous): {counts} (need {expected})")
    if counts != expected:
        fail(f"path {name} did not launch each kernel as expected")
    out = img.cpu()
    if tuple(out.shape) != (h, w, 4) or not torch.isfinite(out).all():
        fail(f"bad image on path {name}: shape {tuple(out.shape)}")
    mean = float(out[..., :3].mean())
    if mean <= 0.01:
        fail(f"image of path {name} is black (mean {mean})")
    print(f"  image {tuple(out.shape)} finite, mean rgb {mean:.4f}")
    if profile:
        from torch.profiler import ProfilerActivity, profile as prof_

        with prof_(activities=[ProfilerActivity.CPU,
                               ProfilerActivity.CUDA]) as prof:
            for _ in range(2):
                r.render_frame()
            torch.cuda.synchronize()
        print(prof.key_averages().table(sort_by="cuda_time_total",
                                        row_limit=25))
    return times, counts


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also print device time by kernel over 2 frames "
                    "of each path")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import hikari_tpu_torch as ht
    from hikari_tpu_torch.build import build_cuda

    box = load_box_module()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)
    card = f"{torch.cuda.get_device_name(0)}, power limit " \
           f"{smi.split(',')[-1].strip()}"
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    logs = build_cuda()
    print(f"built {sorted(logs)} in {time.perf_counter() - t0:.1f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"  {name}: {line.strip()}")

    def build_box():
        return box.build_cornell_box("hikari_tpu_torch")

    t0 = time.perf_counter()
    records = check_kernels(ht, build_box())
    records += check_reuse(ht, build_box)
    for rec in records:
        print(f"  {rec['name']}: {rec['ms']:.4f} ms per launch, plain "
              f"{rec['plain_ms']:.3f} ms, bound {rec['bound_ms']:.4f} ms "
              f"({rec['bound_by']}), library {rec['library_ms']}")
    check_small_render(ht, build_box)
    print(f"checks took {time.perf_counter() - t0:.1f} s")

    frame_ms, launches = {}, {}
    for name in PATHS:
        times, counts = main_path(ht, build_box, name, TIMED_FRAMES,
                                  args.profile)
        frame_ms[name] = (float(np.median(times)), times)
        launches[name] = counts
    # launches over the timed frames of the path(s) running each kernel:
    # A and C on all three, B on no-reuse, 4 and 9 on R and S, 10 on S
    total = [sum(launches[p][i] for p in PATHS) for i in range(5)]
    by_name = {
        "prepass_fused": total[0], "light_fused": launches["no-reuse"][2],
        "denoise_fused": total[4], "reproj_gather": total[1],
        "light_fused_temporal": launches["R"][2] + launches["S"][2],
        "spatial_fused": total[3]}
    for rec in records:
        rec["launches"] = by_name[rec["name"]]

    rays = FULL[0] * FULL[1] * (1 + 1 + 2 + 3)
    m = frame_ms["no-reuse"][0]
    print(json.dumps({
        "frame_ms_1080p": m, "mrays_per_s": rays / m / 1e3,
        "frames": TIMED_FRAMES, "reps_ms": frame_ms["no-reuse"][1],
        "card": card}))
    print(json.dumps({"frame_ms_reuse": frame_ms["R"][0],
                      "reps_ms": frame_ms["R"][1], "card": card}))
    print(json.dumps({"frame_ms_spatial": frame_ms["S"][0],
                      "reps_ms": frame_ms["S"][1], "card": card}))
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
