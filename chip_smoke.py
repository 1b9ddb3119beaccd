"""On-card smoke test of hikari_tpu_torch (the PyTorch + CUDA port).

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py [--profile]

1. prints the card's name and power limit (nvidia-smi);
2. builds kernels A, B and C from hikari_tpu_torch/csrc/ (one nvcc each,
   started together) and prints their register and spill counts;
3. holds each kernel against its plain PyTorch version on the card at the
   1080p flagship shapes, with inputs from the procedural Cornell box
   (tests/cornell_box.py), and times both with CUDA events;
4. checks a small CUDA render against the plain versions on the CPU;
5. renders the box through Renderer at 1920x1080 with the flagship
   settings (no reuse, emissive NEE, 1 bounce, denoise; no TAA, no
   upscale): 3 warm-up frames, then timed frames with the launch counters
   set to 0, which must rise by exactly 1, 1 and 4 per frame;
6. prints frame_ms_1080p and mrays_per_s, one JSON line of per-kernel
   numbers, and last {"ok": true, "device": {...}}.

With --profile it also prints a torch.profiler table of device time by
kernel over two frames. Any failed check raises: the exit code is then not
0 and the last line is not printed. Without CUDA it exits 1 at once.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))

FULL = (1080, 1920)   # (height, width) of the flagship frame
SMALL = (48, 64)
WARMUP_FRAMES = 3
TIMED_FRAMES = 10
REPS = 20             # kernel timing repetitions
PLAIN_REPS = 3

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): HBM3 bytes/s and
# the f32 rate outside the tensor cores, which these kernels use.
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
# Floating-point operations of one ray-triangle test (Moller-Trumbore
# with its accept tests, as written in csrc/common.cuh): the unit of the
# operation counts below.
FLOPS_PER_TRI_TEST = 60


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
    error."""
    d = (got.float() - ref.float()).abs()
    ok = d <= rtol * torch.clamp(ref.float().abs(), min=1.0)
    return float(ok.float().mean()), float(d.max())


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


def flagship_settings(ht):
    import dataclasses

    return dataclasses.replace(
        ht.HikariSettings(), temporal_reuse=False, denoise=True,
        indirect_bounces=1, taa=ht.Taa.NONE, upscale=ht.Upscale.none(),
        emissive_spatial_reuse=False, indirect_spatial_reuse=False,
        checkerboard_lighting=False)


def real_tris(t):
    return int((t[:, 9] >= 0).sum())


def check_kernels(ht, scene_host):
    """Kernel vs plain at 1080p on the box's first frame. Returns the
    per-kernel records (launches filled in later)."""
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
    n_em_tri = real_tris(gpu.arrays["em_tri_pos_flat"])

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
    lparams = lf.pack_params(scene, view, frame, n_em)
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
    for g_, r_ in zip(got, ref):
        if g_ is None:
            continue
        frac, err = rel_close(g_, r_, 1e-3)
        fracs.append(frac)
        max_err = max(max_err, err)
    print(f"kernel B lighting: within 1e-3*max(|ref|,1) on {min(fracs):.6f} "
          f"of values (need >= 0.99); max abs err {max_err:.3g}")
    if min(fracs) < 0.99:
        fail("kernel B disagrees with its plain version")
    ms = event_ms(lambda: lf.lighting_kernel(*b_args, **b_kw), REPS)
    plain_ms = event_ms(lambda: lf.lighting_plain(*b_args, **b_kw),
                        PLAIN_REPS)
    n_out = sum(g_ is not None for g_ in got)
    nbytes = 4 * (lparams.numel() + sum(t.numel() for t in b_args[1:6])
                  + npix * (4 + 3 + 2 + 4) + npix * 4 * n_out)
    tests = 0
    if b_kw["has_sun"]:
        tests += n_tri
    if n_em > 0:
        tests += n_em_tri + n_tri                  # probe + shadow
    if b_kw["bounces"] > 0:
        nee = (n_em_tri if n_em > 0 else 0) + n_tri
        tests += b_kw["bounces"] * (n_tri + nee)   # bounce + NEE
    flops = npix * (tests * FLOPS_PER_TRI_TEST + 400 * n_out)
    b_ms, b_by = bound_ms(nbytes, flops)
    records.append(dict(
        name="light_fused", route="cuda",
        source="hikari_tpu_torch/csrc/light_fused.cu",
        replaces="hikari_tpu/ops/light_fused.py:592", launches=None,
        max_abs_err=max_err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=None))

    # --- kernel C: the 4 levels on the frame's demodulated e/i channels
    chans = [got[1], got[2]]
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
    worst_frac, max_err, max_ulp = 1.0, 0.0, 0
    level_in = irr
    for step in dn.STEPS:
        g_ = dnf.atrous_level(level_in, geo, f32s, step=step, nch=nch,
                              ffs=ffs)
        r_ = dnf.atrous_plain(level_in, geo, f32s, step=step, nch=nch,
                              ffs=ffs)
        torch.cuda.synchronize()
        ulps = bf16_ulps(g_, r_)
        worst_frac = min(worst_frac, float((ulps <= 1).float().mean()))
        max_ulp = max(max_ulp, int(ulps.max()))
        max_err = max(max_err, float((g_.float() - r_.float()).abs().max()))
        level_in = g_
    print(f"kernel C a-trous: <= 1 bf16 ulp on {worst_frac:.6f} of values "
          f"(need >= 0.999); max {max_ulp} ulp, max abs err {max_err:.3g}")
    if worst_frac < 0.999:
        fail("kernel C disagrees with its plain version")

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
    for rec in records:
        print(f"  {rec['name']}: {rec['ms']:.4f} ms per launch, plain "
              f"{rec['plain_ms']:.3f} ms, bound {rec['bound_ms']:.4f} ms "
              f"({rec['bound_by']})")
    return records


def check_small_render(ht, build_box):
    """A small CUDA render against the plain versions on the CPU."""
    box = load_box_module()
    h, w = SMALL
    cam = ht.Camera.from_look_at(box.EYE, box.TARGET, width=w, height=h)
    settings = flagship_settings(ht)
    img_gpu = ht.Renderer(build_box(), cam, settings).render(3)
    img_cpu = ht.Renderer(build_box(), cam, settings,
                          device="cpu").render(3)
    s = ssim(np.clip(img_gpu[..., :3], 0, 1), np.clip(img_cpu[..., :3], 0, 1))
    mad = float(np.abs(img_gpu - img_cpu).mean())
    print(f"small render {h}x{w}, 3 frames, CUDA vs CPU plain: SSIM {s:.5f} "
          f"(need >= 0.98), mean abs diff {mad:.3g} (need < 1e-3)")
    if not np.isfinite(img_gpu).all() or s < 0.98 or mad >= 1e-3:
        fail("the CUDA render disagrees with the CPU plain render")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also print device time by kernel over 2 frames")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import hikari_tpu_torch as ht
    from hikari_tpu_torch.build import build_cuda
    from hikari_tpu_torch.ops import denoise_fused as dnf
    from hikari_tpu_torch.ops import light_fused as lf
    from hikari_tpu_torch.ops import prepass_fused as pf

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
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    def build_box():
        return box.build_cornell_box("hikari_tpu_torch")

    records = check_kernels(ht, build_box())
    check_small_render(ht, build_box)

    # --- the main path: Renderer at 1080p, flagship settings
    h, w = FULL
    cam = ht.Camera.from_look_at(box.EYE, box.TARGET, width=w, height=h)
    r = ht.Renderer(build_box(), cam, flagship_settings(ht))
    for _ in range(WARMUP_FRAMES):
        r.render_frame()
    torch.cuda.synchronize()
    wrappers = (pf.prepass_kernel, lf.lighting_kernel, dnf.atrous_level)
    for fn in wrappers:
        fn.launches = 0
    times = []
    img = None
    for _ in range(TIMED_FRAMES):
        t = time.perf_counter()
        img = r.render_frame()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    counts = [fn.launches for fn in wrappers]
    expected = [TIMED_FRAMES * k for k in (1, 1, 4)]
    print(f"launches over {TIMED_FRAMES} frames: prepass {counts[0]}, "
          f"lighting {counts[1]}, a-trous {counts[2]} (need {expected})")
    if counts != expected:
        fail("the main path did not launch each kernel as expected")
    for rec, n in zip(records, counts):
        rec["launches"] = n
    out = img.cpu()
    if tuple(out.shape) != (h, w, 4) or not torch.isfinite(out).all():
        fail(f"bad image: shape {tuple(out.shape)}")
    mean = float(out[..., :3].mean())
    if mean <= 0.01:
        fail(f"image is black (mean {mean})")
    print(f"image {tuple(out.shape)} finite, mean rgb {mean:.4f}")

    if args.profile:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(2):
                r.render_frame()
            torch.cuda.synchronize()
        print(prof.key_averages().table(sort_by="cuda_time_total",
                                        row_limit=25))

    frame_ms = float(np.median(times))
    rays = h * w + h * w * (1 + 2 + 3 * r.settings.indirect_bounces)
    print(json.dumps({
        "frame_ms_1080p": frame_ms, "mrays_per_s": rays / frame_ms / 1e3,
        "frames": TIMED_FRAMES, "reps_ms": times, "card": card}))
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
