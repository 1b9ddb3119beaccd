"""On-card smoke test of hikari_tpu_torch (the PyTorch + CUDA port).

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py [--profile]

1. prints the card's name and power limit (nvidia-smi);
2. builds the nine CUDA libraries from hikari_tpu_torch/csrc/ (one nvcc
   each, started together) and prints their register and spill counts,
   and those of each lighting instance (kernels B and 4), of kernels A and
   8, of kernel 10's two channel instances and of kernel 13's three modes
   from their build logs;
3. holds kernels A, B and C against their plain PyTorch versions on the
   card at the 1080p flagship shapes of the no-reuse frame, and kernel C
   (the a-trous level) on synthetic fields at 1080p, 960x540 and 541x963
   (an odd width: word-by-word staging), every step, 1-3 channels with
   every firefly mask, with NaN and +-Inf irradiance, zero-depth pixels
   and instance edges along the blocks' edges;
4. drives the reuse paths at 1080p with the camera panning 1.5 px per
   frame and holds each kernel against its plain version on the inputs it
   really got: kernel 9 (the reprojection gather) bit for bit on S's and
   R's calls, kernel 4
   (temporal lighting) on a validation and a no-validation frame with the
   tracking outputs on (path S) and off (path R), printing the share of
   its output words equal to the plain version's, kernel 10 (the spatial
   pass) on both channels, kernel A on path S's calls, and kernel C on
   path R's real variance;
5. runs the directional branch of kernels 4, 10 and B on the box with a
   sun at 270x480 (and kernel A on its calls);
6. drives the post paths at 1080p with the camera panning (D, the literal
   HikariSettings(), and P, the flagship + TAA + SMAA 2.0) and holds
   kernel 8 (the SMAA parity quads, moved from kernel A's planes) against
   its plain version and against kernel A's strided planes (kernel A
   itself against its plain version on D's calls), and on
   synthetic G-buffers of random words (NaN payloads, -0.0), kernels 11
   and 12 (the history warps: TAA's
   at 1920x1080, SMAA's at 960x540) against their plain versions on the
   captured calls (timed by events, on the device and on the host, the
   nearest ones beside one grid_sample) and on synthetic fields at 1080p,
   540p and 541x963 (coords past every edge, .5 ties, a region whose
   blocks' texel boxes exceed the staging budget; every source layout the
   kernels branch on; the staged and direct block counts, both non-zero),
   and kernels B, 9, 4, 10 and C at the 960x540 render size;
7. drives the checkerboard paths at 1080p with the camera panning: KR
   (checkerboard + temporal reuse, the modular lighting path) through an
   emissive validation frame and a frame without one, holding kernels 5,
   6 and 7 (the brute-force tracer; timed by events, on the device and
   on the host) and kernel 9 against their plain
   versions bit for bit and kernel C on KR's reconstructed variance,
   kernel 5 also on adversarial rays over the box (closest_sets); and K
   (checkerboard, no reuse), holding kernel B on its compressed 1080x960
   domain;
8. drives the city (BASELINE config 5: 122 instances, 2,618 triangles)
   at 1920x1080 output, HikariSettings() with SMAA 2.0 and an HDR camera,
   the sphere turning each frame through the on-device refit, and holds
   kernel 13 (the BVH walk: the 1080p primary rays, the include-masked
   probes, the shadow rays and the bounce) against its plain version (the
   world walk over bvh_packed) bit for bit on the calls it got, with the
   work per ray of the world walk and of the kernel's own walk of its
   tables, kernels 9 (3 sources), C, 11 and 12 on the city's calls, kernel
   13 on the box against kernels 5 and 7, and the CUDA refit (kernel 13's
   tables included) against the CPU refit; then kernels 13 and 9 on one
   frame of path T's calls (two emissive subtrees);
9. drives path T (the textured simple scene, BASELINE config 3, with a
   seeded procedural Earth on both spheres) at 1920x1080 and holds kernel
   14 (the coherent atlas sampler, one launch for both textured slots)
   against its plain version bit for bit on every slot of the launches it
   got (1920x1080 and the 960x540 lighting domain), on a synthetic 1080p
   field (four textures, ids -1, negative and seam-crossing uv) in one
   launch of all four slots, of two, and of each alone, and through
   retrieve_surface's four slots; its time by events, on the device and
   on the host beside one grid_sample over the same samples (these
   checks run first, before any profiler session: the host reads slower
   after one);
10. drives path F (the scene of examples/scene.py, BASELINE config 4,
   without its absent glTF model: 1,226 triangles, 4 bounces, FSR 1.0 at
   ratio 2) at 1920x1080 and holds kernel 13 (the 1080p primary rays and
   4 bounces of rays at 960x540), 9 (3 sources), C and 11 (TAA at the
   960x540 render size, a partial group of 128 columns) against their
   plain versions on the calls of two frames; then the box at 1080p on
   the upscale settings beyond SMAA 2.0, three frames each, every kernel
   call of the last two against its plain version and a small render
   against the CPU: the flagship with FSR 1.0 at ratio 1.5 (kernel A's
   full-only call, B and C at 1280x720), HikariSettings() with SMAA at
   ratios 1 and 1.5 (11 and 12 at 2160x3840 / 1080x1920 and 1440x2560 /
   720x1280), HikariSettings() at 1081x1919 (ratio 2 at an odd size: no
   kernel 8) and checkerboard lighting with SMAA 2.0 (B over 540x480,
   8); path TN (path T's scene at the flagship settings: the modular path
   without reuse) over two 1080p frames, every call of kernel 13 (full,
   shadow), 14 and C against its plain version; the city at
   HikariSettings() without temporal reuse (indirect spatial reuse alone,
   the modular spatial pass at 960x540) and the box at HikariSettings()
   with the spatial tap scramble (the modular path over kernels 5, 6 and
   7), three frames each, every kernel call of the last two against its
   plain version and a small render against the CPU; then path CL (the
   city with 16 street lamps, tests/city_lamps.py: 154 instances, 3,002
   triangles, 17 emissives, so the emissive channel walks the emissive
   BVH and update_scene(fast=True) is the host refit) at 1920x1080 with
   bloom, over two frames, every call of kernel 13 (full and shadow, the
   probes in the 17 emitters' subtrees), 9, C, 11 and 12 against its
   plain version, and the scene the Renderer uploaded after the host
   refits against the host refit's arrays word for word; then path M
   (hikari_tpu_torch/examples/minimal.py's main at 1920x1080: a cube on a
   plane, 14 triangles, a sun, HikariSettings()) over two frames, every
   call of kernels A, 8, 9, 4 (the sun's and the indirect channels), 10,
   C, 11 and 12 against its plain version, and its small render; then
   check U: the city compiled without the mesh acceleration structure
   (HikariUniversalSettings) and rendered with brute_force_max=4096 at
   960x540, every call of kernels 5, 6 and 7 over its 2,618-row table
   (and the 1,224-row emissive table) word for word against its plain
   version over two frames (kernels 5, 6 and 7 stage a table above 768
   rows chunk by chunk), with one record each; the box with
   brute_force_max=0 (kernel 13 and the non-fused prepass), every kernel
   call of a 1080p frame against its plain version; and small renders of
   both against the CPU at SSIM >= 0.9999;
11. checks small CUDA renders of the seven paths against the plain
   versions on the CPU, KR on the box with a sun at 270x480 (the solar
   branch of the modular path, kernel 7 on sun rays), and the city, CL
   (4 frames, and 3 with FXAA) and paths T, TN and F at 48x256;
12. renders the box through Renderer at 1920x1080 on the seven paths
   (no reuse; temporal reuse R; temporal + spatial reuse S; P; D;
   checkerboard K; checkerboard + temporal reuse KR): 3 warm-up frames,
   then timed frames with the launch counters set to 0, which must rise
   by exactly the counts of PATHS below (per frame number: KR's, the
   city's and T's validation frames trace more); then the city the same
   way, each frame update_scene(rotate_sphere(...), fast=True) +
   render_frame(); then path CL the same way (with --profile also
   bloom's share of its device time and the emissive walk's calls,
   PyTorch ops and host time per frame beside the city's); then path T,
   whose 1080p image must differ from the untextured scene's on the
   spheres; then path TN; then path F (with
   --profile also FSR's share of its device time); then P and D
   alternately, frame by frame; path M and path G
   (hikari_tpu_torch/examples/cornell.py's main at 1920x1080 on the box
   this script writes as a GLB with tests/torch_glb.py, read through the
   glTF loader from $HIKARI_ASSETS: D's launches) the same way, after
   which G's renderer runs render_dissection() three times (timed), a
   fourth with every kernel call (A, 8, 9, 5, 6, 7, C, 11, 12; no 4 or
   10) against its plain version and its launches checked, and a
   render_frame() with D's launches; then path SM: examples/minimal.py's
   scene, settings and camera at 1920x1080 under hikari_tpu_torch.parallel
   shard_frame, one spawned rank per card over NCCL (on a machine with one
   card 2 ranks on it over gloo, the collectives staged through the host),
   3 warm-up and 10 timed frames with exact launches per rank (path M's),
   every island call of two more frames (A, 8, 9, 4, C, 11, 12 on the
   rank's rows; 10 whole) against its plain version on every rank, and
   check SB (the box at the flagship settings, kernel B's island, and with
   checkerboard + temporal reuse, the modular path with kernel 9's island,
   3 frames each); rank 0 then renders every frame again on one card
   without the mesh, and the image, albedo and carry must equal the
   sharded ones word for word (the ranks' words are compared by a
   digest);
13. runs the compiled-frame check: every single-card path (no-reuse, R,
   S, P, D, K, KR, the city, CL, T, TN, F, M, G) at 1920x1080 from one
   fresh state twice in lockstep, eagerly (compiled.eager()) and through
   Renderer's captured CUDA graphs, the camera panning and, on the city
   and CL, update_scene(fast=True) before every frame (the device refit's
   own graph; the host refit), until every key of the path's frame
   program has come twice (at least 8 frames without a capture): the
   image, the albedo and every carry tensor equal word for word (NaNs
   as words), each key's capture launching exactly the path's launches
   of its frame number, a replayed frame launching nothing from Python;
   it prints each path's eager and replayed frame medians and IQRs, host
   times and capture times (with --profile the replayed frames' device
   time and idle share of D, the city and F) in one line. Then, in the
   same lockstep: the retunes (paths D and the city: every key captured,
   then each dynamic field retuned by update_settings on both renderers,
   both validation intervals so that old and new keys cross, the solar
   angle, the indirect clamp, the clear colour, both reuse caps and the
   lifetime, two frames after each: words equal, the graphs, carry and
   frame index kept, no key captured again; the first replayed frame
   after each retune timed beside a capture); the untimed settings
   replayed (the box's upscale settings, the city without temporal reuse,
   the tap scramble, check U's brute_force_max 4096 and 0, FXAA: every
   key once and two frames more, words equal); the dissection replayed
   (path G's render_dissection until every key has come twice: planes,
   final image and carry equal; dissection_ms replayed beside eager);
   path SM replayed (the sharded frame over NCCL, one graph per key on
   every rank, against the eager sharded frames in lockstep until every
   key has come twice, rank 0's frames against the single card's, word
   for word; on a machine with one card over a one-rank NCCL mesh, since
   path SM's gloo ranks run eagerly by rule: its islands' all-gathers are
   captured there, the halo exchange only with two or more cards). Every
   check and timed path before it runs its frames eagerly, inside
   compiled.eager(), path SM's ranks too;
14. prints frame_ms_1080p, frame_ms_reuse, frame_ms_spatial,
   frame_ms_smaa2, frame_ms_default, frame_ms_ckb, frame_ms_ckb_reuse,
   frame_ms_city with city_refit_ms, frame_ms_city_lamps with
   city_lamps_refit_ms (path CL), frame_ms_simple (path T),
   frame_ms_simple_noreuse (path TN), frame_ms_scene (path F),
   frame_ms_minimal (path M), frame_ms_cornell with dissection_ms (path
   G), P's and D's alternating medians, frame_ms_minimal_sharded (path
   SM, with its ranks, backend, card and the bytes a rank receives a
   frame), the compiled check's keys, eager and replayed medians and
   replayed host times per path again (compiled_frame_ms), one JSON line
   of per-kernel
   numbers of the kernels the paths run (kernels 5, 6 and 7 also over
   check U's 2,624-row table), one of kernel 13's mode `hit` (no path
   traces without attributes), and last {"ok": true, "device": {...}}.

Every check of kernels A, 4, 10 and B also prints the share of its output
words equal to the plain version's.

Tolerances: kernels A and C as stated at their checks (C: <= 1 bf16 ulp
on >= 99.9% of values, the words not equal counted); kernels B, 5, 6, 7,
9, 8, 12, 13 and 14 bit for bit (8 also against kernel A's planes; 13 against
5 and 7 on the box: ids equal but at ties, floats equal where they agree);
kernel 11 bit for bit for nearest sources and within 1e-5 * max(|ref|, 1)
on >= 99.99% of values for the filtered ones; kernels 4 and 10: >= 99% of
pixels with all 16 packed words equal, and >= 99% of render and variance
values within 1e-3 * max(|ref|, 1) (NaN-coded variances NaN at the same
pixels); the refit within 1e-6 * max(|ref|, 1), its BVH boxes bit for bit
against the CPU pyramid of the CUDA triangles; small renders SSIM >= 0.98
and mean abs diff < 1e-3.

The examples write their images, and path G finds its GLB, in a
temporary directory the script removes at its end.

With --profile it also prints a torch.profiler table of device time by
kernel over two frames of each path. With --ab it only times the frames of
paths P and D (alternately), no-reuse, R, S, K, KR, the city, CL, T and M
before any check or profiler session,
then checks and times kernels 8, C, 11 and 12 on path D's calls, C on a
synthetic 1080p field, kernel 4 on R's, S's (1080p) and D's (960x540)
calls with and without the validation retrace, kernel B on the no-reuse
frame's, P's (960x540) and K's (1080x960) calls, kernel 9 on R's, S's,
D's, KR's and the city's calls (beside the rows[:, idx] yardstick), kernel
14 on T's 1080p and 960x540 launches, kernel A on the
no-reuse frame's and D's 1080p calls, kernel 10 on S's two 1080p calls
and D's 960x540 call, kernel 13 on the city's frame-1 calls, reached
through BvhTracer, and kernels 5, 6 and 7 on every call of KR's frames 4
and 5, reached through BruteForceTracer (events, device and host times,
the host times of each wrapper and of its pack_params before any
profiler session), and
prints the records and the frame medians (no ok line): run it in two
trees of the repository in one call, in turns, to compare them; `--ab-summary
FILE...` (one file of --ab lines per tree) prints each metric's median
and interquartile range over the runs.
With --sharded it only builds the kernels and runs path SM and check SB
(its line, no ok line); with --compiled only the compiled-frame check
(its line, no ok line). Any failed check raises: the exit code is then
not 0 and the last line is not printed. Without CUDA it exits 1 at once.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))

FULL = (1080, 1920)   # (height, width) of the flagship frame
SUN = (270, 480)      # the directional-branch check
SMALL = (48, 64)
CITY_SMALL = (48, 256)  # the city's CUDA-vs-CPU render (128-wide groups)
ODD = (1081, 1919)    # ratio 2 at an odd output size (render 541x960)
CITY_EYE, CITY_TARGET = (0.0, 2.5, 20.0), (0.0, 0.0, 0.0)
# where check_city makes its own tensors (a CPU rehearsal of this script
# sets "cpu")
DEVICE = "cuda"
WARMUP_FRAMES = 3
TIMED_FRAMES = 10
REPS = 20             # kernel timing repetitions
PLAIN_REPS = 3
HOST_REPS = 100       # host-time repetitions (host_us)
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
# operation counts below; and of one slab test of a BVH node (kernel 13).
FLOPS_PER_TRI_TEST = 60
FLOPS_PER_NODE = 30
# per-pixel allowances of the reservoir algebra (unpack, gates, WRS,
# finalize, repack) and of one spatial tap (unpack, march, gates,
# Jacobian, WRS; + one Burley/GGX shading for the indirect channel)
FLOPS_RESERVOIR = 300
FLOPS_TAP = 150
FLOPS_SHADE = 110


def fail(msg):
    raise RuntimeError(msg)


def kernel_resources(name):
    """[{kernel, registers, spill_stores, spill_loads, stack}] of every
    entry function of lib<name>.so, from ptxas's -v lines in its build log
    (written beside the library at each build)."""
    from hikari_tpu_torch.build import BUILD_DIR

    out, cur = [], None
    with open(os.path.join(BUILD_DIR, f"lib{name}.so.log")) as f:
        for line in f:
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                cur = dict(kernel=m.group(1))
                out.append(cur)
                continue
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", line)
            if m and cur is not None:
                cur.update(stack=int(m.group(1)),
                           spill_stores=int(m.group(2)),
                           spill_loads=int(m.group(3)))
            m = re.search(r"Used (\d+) registers", line)
            if m and cur is not None:
                cur["registers"] = int(m.group(1))
    return out


def kernel_instances(name, label=lambda r: r["kernel"]):
    """Every entry function of lib<name>.so (kernel_resources), printed
    with its registers, spills and stack under `label`: for prepass_fused
    kernels A and 8, for spatial_fused kernel 10's two channel instances."""
    recs = kernel_resources(name)
    for r in recs:
        print(f"  {name} {label(r)}: {r.get('registers')} registers, "
              f"{r.get('spill_stores')} B spill stores, "
              f"{r.get('spill_loads')} B spill loads, {r.get('stack')} B "
              f"stack")
    return recs


def light_instances():
    """The lighting kernel's template instances (kernels B and 4) with
    their registers and spills, printed; kernel B's own kernel is
    instance B, and a kernel-4 instance's name is ptxas's mangled booleans
    (validation, track_de, track_ind)."""
    def label(r):
        if "light_kernel_b" in r["kernel"]:
            r["instance"] = "B"
        else:
            r["instance"] = "".join(re.findall(r"Lb([01])E", r["kernel"]))
        return f"instance {r['instance'] or r['kernel']}"

    return kernel_instances("light_fused", label)


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


def device_ms(fn, reps, kernel, per_call=False):
    """Median device time in ms of the CUDA kernel whose name contains
    `kernel` over `reps` runs of fn(), from torch.profiler's trace: the
    kernel's own time, without the host's launch gaps that event_ms counts
    for a kernel shorter than its wrapper's host work. With per_call, the
    device time of every matching kernel summed, over `reps` (fn() launches
    several). None when three traces hold no device time for it (a trace
    now and then comes back without the kernel's events)."""
    from torch.profiler import ProfilerActivity, profile as prof_

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with prof_(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        times = [e.device_time_total for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and kernel in e.name]
        if times:
            return (sum(times) / reps if per_call
                    else float(np.median(times))) / 1e3
    return None


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


def default_settings(ht):
    """The literal HikariSettings(): temporal + indirect spatial reuse,
    denoise, TAA Jasmine, SMAA TU4X at ratio 2 (bench.py:148)."""
    return ht.HikariSettings()


def fixed(*counts):
    """Launches per frame that do not depend on the frame number."""
    return lambda settings, number: counts


def kr_launches(settings, number):
    """Path KR's launches in frame `number`: the emissive channel's probe
    (kernel 6) and shadow ray (kernel 7), both again on its validation
    frames, and the indirect bounce (kernel 5) with its probe and shadow
    ray; the box has no sun, so the direct channel traces nothing."""
    v = int(number % settings.emissive_validate_interval == 0)
    return (1, 0, 1, 0, 0, 4, 0, 0, 1, 2 + v, 2 + v, 0, 0, 0, 0)


def city_launches(settings, number):
    """The city's launches in frame `number` (kernel 13 for every ray: the
    1,224-row emissive table is above kernel 6's 768): the primary rays
    (full), the gather of 3 sources, the sun's shadow ray, the emissive
    channel's probe (full) and shadow ray, the bounce (full), its probe
    (full) and shadow ray; the direct channel traces its shadow ray again
    on its validation frames, the emissive one its probe and shadow ray;
    a-trous 4, SMAA's two warps and TAA's."""
    vd = int(number % settings.direct_validate_interval == 0)
    ve = int(number % settings.emissive_validate_interval == 0)
    return (0, 0, 1, 0, 0, 4, 2, 1, 0, 0, 0, 0, 4 + ve, 3 + vd + ve, 0)


def cl_launches(settings, number):
    """Path CL's launches in frame `number` (the city with 16 street
    lamps: 17 emissives, so the emissive channel walks the emissive BVH
    and every update_scene(fast=True) is the host refit, which launches
    no kernel): the city's. The lamp heads' 192 triangles join the
    sphere's 1,224 in the emissive table (above kernel 6's 768: kernel 13
    for every ray), and bloom launches no kernel of the port's. The same
    calls as hikari_tpu's tracer makes per frame number on the CPU
    (tests/test_torch_frame_city_lamps.py counts them)."""
    return city_launches(settings, number)


def simple_launches(settings, number):
    """Path T's launches in frame `number`: the city's (the same settings
    but emissive spatial reuse, which traces nothing; kernel 13 for every
    ray: the two spheres' 2,436-row emissive table is above kernel 6's
    768), and kernel 14 once for the 1080p G-buffer and once for the
    960x540 lighting domain, each launch sampling both textured slots
    (base colour and emissive)."""
    return city_launches(settings, number)[:-1] + (2,)


def scene_launches(settings, number):
    """Path F's launches in frame `number` (the scene of examples/scene.py,
    1,226 triangles: kernel 13 for every ray): the city's, with the
    bounce, its probe (full) and its shadow ray once per bounce (4), and
    TAA's warp alone (no SMAA; FSR launches no kernel of the port's)."""
    vd = int(number % settings.direct_validate_interval == 0)
    ve = int(number % settings.emissive_validate_interval == 0)
    b = settings.indirect_bounces
    return (0, 0, 1, 0, 0, 4, 1, 0, 0, 0, 0, 0, 2 + ve + 2 * b,
            2 + vd + ve + b, 0)


def simple_noreuse_launches(settings, number):
    """Path TN's launches in frame `number` (path T's scene at the flagship
    settings; without reuse no frame validates): kernel 13 full for the
    1080p primary rays, the emissive channel's probe, the bounce and its
    probe, 13 shadow for the sun's, the emissive channel's and the
    bounce's NEE shadow rays, a-trous 4, and kernel 14 once (at ratio 1
    the G-buffer is the lighting domain: one surface serves the albedo
    and the channels). The same calls as hikari_tpu's tracer gets in its
    no-reuse frame of this scene (with_info 2, probe_info 2, shadow 3)."""
    return (0, 0, 0, 0, 0, 4, 0, 0, 0, 0, 0, 0, 4, 3, 1)


# the seven paths of the box: their settings, and the launches of COUNTERS
# in a frame
COUNTERS = ("prepass", "quads", "gather", "lighting", "spatial", "a-trous",
            "warp_band", "warp_multi", "trace_closest", "trace_full",
            "trace_shadow", "bvh_closest", "bvh_full", "bvh_shadow",
            "sample_atlas")
PATHS = {
    "no-reuse": (flagship_settings,
                 fixed(1, 0, 0, 1, 0, 4, 0, 0, 0, 0, 0, 0, 0, 0, 0)),
    "R": (lambda ht: flagship_settings(ht, temporal_reuse=True),
          fixed(1, 0, 1, 1, 0, 4, 0, 0, 0, 0, 0, 0, 0, 0, 0)),
    "S": (lambda ht: flagship_settings(
        ht, temporal_reuse=True, emissive_spatial_reuse=True,
        indirect_spatial_reuse=True),
        fixed(1, 0, 1, 1, 2, 4, 0, 0, 0, 0, 0, 0, 0, 0, 0)),
    # the flagship + TAA + SMAA 2.0 (bench.py:142-144): lighting at 960x540
    "P": (lambda ht: flagship_settings(ht, taa=ht.Taa.JASMINE,
                                       upscale=ht.Upscale.smaa_tu4x(2.0)),
          fixed(1, 1, 0, 1, 0, 4, 2, 1, 0, 0, 0, 0, 0, 0, 0)),
    "D": (default_settings,
          fixed(1, 1, 1, 1, 1, 4, 2, 1, 0, 0, 0, 0, 0, 0, 0)),
    # checkerboard lighting (bench.py:140-141): kernel B over 1080x960
    "K": (lambda ht: flagship_settings(ht, checkerboard_lighting=True),
          fixed(1, 0, 0, 1, 0, 4, 0, 0, 0, 0, 0, 0, 0, 0, 0)),
    # checkerboard + temporal reuse (bench.py:155-157): the modular path
    "KR": (lambda ht: flagship_settings(ht, temporal_reuse=True,
                                        checkerboard_lighting=True),
           kr_launches),
}


def counter_wrappers():
    """The launch counters of COUNTERS, in order."""
    from hikari_tpu_torch.ops import denoise_fused as dnf
    from hikari_tpu_torch.ops import light_fused as lf
    from hikari_tpu_torch.ops import prepass_fused as pf
    from hikari_tpu_torch.ops import reproj_gather as rg
    from hikari_tpu_torch.ops import spatial_fused as sf
    from hikari_tpu_torch.ops import texture_pallas as tx
    from hikari_tpu_torch.ops import trace_cull as tc
    from hikari_tpu_torch.ops import trace_pallas as tp
    from hikari_tpu_torch.ops import warp2 as w2
    from hikari_tpu_torch.ops import warp_band as wb

    return (pf.prepass_kernel, pf.prepass_quads_kernel, rg.reproj_gather,
            lf.lighting_kernel, sf.spatial_kernel, dnf.atrous_level,
            wb.warp_band, w2.warp_multi, tp.trace_closest, tp.trace_full,
            tp.trace_shadow, tc.bvh_closest, tc.bvh_full, tc.bvh_shadow,
            tx.sample_atlas_slots)


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
    max_err, words_a = check_prepass_call(pf, a_args, "no reuse")
    got = pf.prepass_kernel(*a_args)
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
        max_abs_err=max_err, words_equal=words_a, ms=ms, plain_ms=plain_ms,
        bound_ms=b_ms, bound_by=b_by, library_ms=None))
    gbuf, albedo = pf._assemble(*got)
    check_prepass_full_table(
        pf, pf.pack_params(view, view, (0.0, 0.0), (270, 480)), a_args)

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
    max_err, words = check_b_call(lf, b_args, b_kw, "no reuse")
    got = lf.lighting_kernel(*b_args, **b_kw)
    rec = light_record(lf, gpu, b_args, b_kw)
    print_kernel_times("kernel B lighting 1080p", rec)
    records.append(dict(
        name="light_fused", route="cuda",
        source="hikari_tpu_torch/csrc/light_fused.cu",
        replaces="hikari_tpu/ops/light_fused.py:592", launches=None,
        max_abs_err=max_err, words_equal=words, library_ms=None, **rec))

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
    max_err = check_levels(dnf, level_calls, "zero variance")[0]
    max_err = max(max_err, check_atrous_fields(dnf))
    b_ms, b_by = atrous_bound(npix, nch)
    rec = atrous_times(dnf, level_calls)
    print_kernel_times("kernel C a-trous 1080p, per level",
                       dict(rec, bound_ms=b_ms))
    records.append(dict(
        name="denoise_fused", route="cuda",
        source="hikari_tpu_torch/csrc/denoise_fused.cu",
        replaces="hikari_tpu/ops/denoise_fused.py:60", launches=None,
        max_abs_err=max_err, bound_ms=b_ms, bound_by=b_by, library_ms=None,
        **rec))
    return records


PREPASS_PLANES = ("position", "normal", "instance_material", "velocity_uv",
                  "albedo")


def check_prepass_call(pf, a, label):
    """Kernel A against its plain version on one call: ids equal on >=
    99.5% of pixels, the float planes within 1e-4 * max(|ref|, 1) on >= 99%
    of values; prints the share of output words equal to the plain
    version's. Returns (max abs error, that share)."""
    got = pf.prepass_kernel(*a)
    ref = pf.prepass_plain(*a)
    torch.cuda.synchronize()
    ids_eq = float((got[2] == ref[2]).all(-1).float().mean())
    fracs, max_err = [], 0.0
    for i in (0, 1, 3, 4):
        frac, err = rel_close(got[i], ref[i], 1e-4)
        fracs.append(frac)
        max_err = max(max_err, err)
    words, n = outputs_words(dict(zip(PREPASS_PLANES, got)),
                             dict(zip(PREPASS_PLANES, ref)))
    print(f"kernel A prepass {label} {a[5]}: ids equal on {ids_eq:.6f} of "
          f"pixels (need >= 0.995); float planes within 1e-4*max(|ref|,1) "
          f"on {min(fracs):.6f} of values (need >= 0.99); max abs err "
          f"{max_err:.3g}; {words:.8f} of {n} words equal")
    if ids_eq < 0.995 or min(fracs) < 0.99:
        fail(f"kernel A disagrees with its plain version ({label})")
    return max_err, words


def check_prepass_full_table(pf, params, a):
    """Kernel A on a table at its cap (the box's real rows of call `a`
    repeated to MAX_TRIS, so the lowest index wins every tie) at 270x480
    (`params` packed for that size), on every card the process sees, in
    order: its staged triangles alone take 48 KB, so each card's first
    launch needs the shared-memory attribute above the default (held per
    card), which the box's paths never reach."""
    from hikari_tpu_torch.ops.light_fused import MAX_TRIS

    tris, attrs = a[1], a[2]
    real = tris[:, 9] >= 0
    reps = -(-MAX_TRIS // int(real.sum()))
    full = (params, tris[real].repeat(reps, 1)[:MAX_TRIS].contiguous(),
            attrs[real].repeat(reps, 1)[:MAX_TRIS].contiguous(), *a[3:5])
    for i in range(torch.cuda.device_count()):
        dev = torch.device("cuda", i)
        with torch.cuda.device(dev):
            check_prepass_call(pf, (*(t.to(dev) for t in full), (270, 480)),
                               f"{MAX_TRIS}-row table on {dev}")


def check_levels(dnf, calls, what):
    """Each a-trous level call against its plain version on the same
    input: <= 1 bf16 ulp on >= 99.9% of values; also counts the words not
    equal. Returns (max abs error, words not equal, words)."""
    worst_frac, max_err, max_ulp, unequal, n = 1.0, 0.0, 0, 0, 0
    for args, kw in calls:
        g_ = dnf.atrous_level(*args, **kw)
        r_ = dnf.atrous_plain(*args, **kw)
        torch.cuda.synchronize()
        ulps = bf16_ulps(g_, r_)
        worst_frac = min(worst_frac, int((ulps <= 1).sum()) / ulps.numel())
        max_ulp = max(max_ulp, int(ulps.max()))
        unequal += int((g_.view(torch.int16) != r_.view(torch.int16)).sum())
        n += ulps.numel()
        max_err = max(max_err, max_abs_err([g_], [r_]))
    print(f"kernel C a-trous ({what}, {len(calls)} levels): <= 1 bf16 ulp "
          f"on {worst_frac:.6f} of values (need >= 0.999); max {max_ulp} "
          f"ulp, max abs err {max_err:.3g}; {unequal} of {n} words not "
          f"equal")
    if worst_frac < 0.999:
        fail(f"kernel C disagrees with its plain version ({what})")
    return max_err, unequal, n


def atrous_times(dnf, levels):
    """The a-trous level calls `levels` (one cascade) timed per level by
    events, on the host and on the device, and their plain versions by
    events."""
    def cascade(level):
        return [level(*a, **k) for a, k in levels]

    n = len(levels)
    rec = kernel_times([(lambda: cascade(dnf.atrous_level), None)],
                       "atrous_kernel", None)[0]
    rec = {k: v / n if k != "device_ms" else v for k, v in rec.items()}
    rec["plain_ms"] = event_ms(lambda: cascade(dnf.atrous_plain),
                               PLAIN_REPS) / n
    return rec


# the synthetic a-trous fields: 1080p and 960x540 (rows 16-byte aligned),
# and 541x963 (odd width: the word-by-word staging)
ATROUS_FIELD_SIZES = ((1080, 1920), (540, 960), (541, 963))


def atrous_field(h, w, nch, gen):
    """Synthetic level inputs (irr, geo, f32s) on the card. Irradiance:
    mostly dim, 0.5% fireflies 1000x brighter, and bad texels (NaN, +Inf,
    -Inf; bf16 holds no finite value above F32_MAX, so +Inf stands for
    those) on ~0.3% of the channels' texels; depth a gentle slope with
    zero-depth pixels (2% scattered, and rows 100-103); instance ids that
    change across the 64-column tile boundaries and every 8 rows, so the
    instance edges lie along the blocks' edges at step 1; normals near +z,
    some flipped."""
    dev = DEVICE

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    irr = rand(3 * nch, h, w) ** 4 * 4.0
    irr = torch.where(rand(3 * nch, h, w) < 0.005, irr * 1000.0, irr)
    bad = rand(1, h, w).expand(3 * nch, h, w)
    pick = torch.rand((3 * nch, h, w), generator=gen, device=dev)
    irr = torch.where((bad < 0.003) & (pick < 1 / 3), float("nan"), irr)
    irr = torch.where((bad < 0.003) & (pick > 2 / 3), float("inf"), irr)
    irr = torch.where((bad < 0.001) & (pick < 1 / 6), float("-inf"), irr)
    yy = torch.arange(h, device=dev, dtype=torch.float32)[:, None]
    xx = torch.arange(w, device=dev, dtype=torch.float32)[None, :]
    depth = 0.5 + 0.3 * (yy / h) + 0.1 * (xx / w) + 0.002 * rand(h, w)
    depth = torch.where(rand(h, w) < 0.02, 0.0, depth)
    depth[100:103] = 0.0
    inst = torch.remainder(torch.floor(xx / 64) + torch.floor(yy / 8),
                           3.0) + 0.5
    inst = inst.expand(h, w)
    n = torch.stack([rand(h, w) - 0.5, rand(h, w) - 0.5,
                     torch.ones(h, w, device=dev)])
    n = n / n.norm(dim=0, keepdim=True)
    n = torch.where(rand(h, w) < 0.05, -n, n)
    grads = (rand(2, h, w) - 0.5) * 0.02
    denom = 1.0 / (4.0 * torch.sqrt(torch.sqrt(rand(nch, h, w) * 2.0))
                   + 1e-3)
    geo = torch.cat([grads, denom]).to(torch.bfloat16)
    f32s = torch.stack([depth, inst, n[0], n[1], n[2]]).contiguous()
    return irr.to(torch.bfloat16), geo, f32s


def check_atrous_fields(dnf):
    """Kernel C on the synthetic fields of ATROUS_FIELD_SIZES, every step
    of the cascade, nch 1, 2 and 3 with every firefly mask, against its
    plain version: <= 1 bf16 ulp on >= 99.9% of values. Returns the max
    abs error."""
    from hikari_tpu_torch.ops import denoise as dn

    gen = torch.Generator(device=DEVICE).manual_seed(12)
    max_err, unequal, words, n_calls = 0.0, 0, 0, 0
    for h, w in ATROUS_FIELD_SIZES:
        for nch in (1, 2, 3):
            irr, geo, f32s = atrous_field(h, w, nch, gen)
            calls = [((irr, geo, f32s), dict(
                step=step, nch=nch,
                ffs=tuple(bool(m >> c & 1) for c in range(nch))))
                for m in range(2 ** nch) for step in dn.STEPS]
            err, neq, n = check_levels(dnf, calls, f"field {h}x{w}, "
                                       f"{nch} channels")
            max_err = max(max_err, err)
            unequal += neq
            words += n
            n_calls += len(calls)
    print(f"kernel C on {n_calls} synthetic calls ({ATROUS_FIELD_SIZES}, "
          f"steps {dn.STEPS}, 1-3 channels, every firefly mask): all within "
          f"1 bf16 ulp on >= 99.9% of values; {unequal} of {words} words "
          f"not equal to the plain version; max abs err {max_err:.3g}")
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


def drive(ht, scene_host, size, settings, frames, captures, keep):
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
            r = ht.Renderer(scene_host, cam, settings)
        r.camera = cam
        for c in captures:
            c.on = i in keep
        r.render_frame()
    torch.cuda.synchronize()
    return r


def outputs_words(got, ref):
    """The fraction of all the words of a dict of outputs equal to the
    plain version's, and the count of words."""
    eq = n = 0
    for k in ref:
        e = got[k].view(torch.int32) == ref[k].view(torch.int32)
        eq += int(e.sum())
        n += e.numel()
    return eq / n, n


def compare_outputs(what, got, ref):
    """Kernel 4/10 tolerance: planes equal on >= 99% of pixels, renders
    and variances within 1e-3 * max(|ref|,1) on >= 99% of values. Also
    prints the share of all output words equal to the plain version's.
    Returns (max abs error, that share)."""
    worst_planes, worst_vals, max_err = 1.0, 1.0, 0.0
    for k in ref:
        if ref[k].dim() == 3 and ref[k].shape[1] == 16:
            worst_planes = min(worst_planes, planes_equal(got[k], ref[k]))
        else:
            frac, err = rel_close(got[k], ref[k], 1e-3)
            worst_vals = min(worst_vals, frac)
            max_err = max(max_err, err)
    words, n = outputs_words(got, ref)
    print(f"  {what}: packed planes equal on {worst_planes:.6f} of pixels, "
          f"values within tolerance on {worst_vals:.6f}; max abs err "
          f"{max_err:.3g}; {words:.8f} of {n} words equal")
    if worst_planes < 0.99 or worst_vals < 0.99:
        fail(f"{what} disagrees with its plain version")
    return max_err, words


def check_lighting_calls(lf, calls, label):
    """Kernel 4 vs plain on captured calls; returns (the max abs error,
    the least share of equal words of a call)."""
    max_err, words = 0.0, 1.0
    for a, k in calls:
        got = lf.lighting_kernel(*a, **k)
        ref = lf.lighting_plain(*a, **k)
        torch.cuda.synchronize()
        p = a[0].cpu().numpy()
        what = (f"kernel 4 {label} (validation {k['validation']}, flags "
                f"d/e {p[lf._P_VAL]:.0f}/{p[lf._P_VAL + 1]:.0f}, tracking "
                f"{k['track_de']}/{k['track_ind']})")
        err, eq = compare_outputs(what, got, ref)
        max_err, words = max(max_err, err), min(words, eq)
    return max_err, words


def check_b_call(lf, a, k, label):
    """Kernel B against its plain version on one call: every output word
    equal; prints the share of equal words and of values within
    1e-3 * max(|ref|, 1). Returns (max abs error, the share of equal
    words)."""
    got, ref = lf.lighting_kernel(*a, **k), lf.lighting_plain(*a, **k)
    torch.cuda.synchronize()
    fracs, max_err = [], 0.0
    for n in ref:
        frac, err = rel_close(got[n], ref[n], 1e-3)
        fracs.append(frac)
        max_err = max(max_err, err)
    words, n = outputs_words(got, ref)
    print(f"kernel B lighting {label} {tuple(a[6].shape[:2])}: within "
          f"1e-3*max(|ref|,1) on {min(fracs):.6f} of values; max abs err "
          f"{max_err:.3g}; {words:.8f} of {n} words equal (need 1)")
    if words != 1.0:
        fail(f"kernel B disagrees with its plain version ({label})")
    return max_err, words


def check_spatial_calls(sf, calls, label):
    """Kernel 10 vs plain on captured calls (compare_outputs); returns (the
    max abs error, the least share of equal words of a call)."""
    max_err, words = 0.0, 1.0
    for a, k in calls:
        got = dict(zip(("render", "variance", "planes"),
                       sf.spatial_kernel(*a, **k)))
        ref = dict(zip(("render", "variance", "planes"),
                       sf.spatial_plain(*a, **k)))
        torch.cuda.synchronize()
        what = (f"kernel 10 {label} {tuple(a[4].shape[:2])} "
                f"({'emissive' if k['emissive_lit'] else 'indirect'})")
        err, eq = compare_outputs(what, got, ref)
        max_err, words = max(max_err, err), min(words, eq)
    return max_err, words


def check_gather_calls(rg, calls, label):
    """Kernel 9 against its plain version on captured calls: bit for bit.
    Returns the max abs error."""
    err = 0.0
    for a, _ in calls:
        got = rg.reproj_gather(*a)
        ref = rg.gather_plain(*a)
        torch.cuda.synchronize()
        eq = min(float((g_.view(torch.int32) == r_.view(torch.int32))
                       .float().mean()) for g_, r_ in zip(got, ref))
        err = max(err, max_abs_err(got, ref))
        w = a[2].shape[1]
        moved = float((a[2] != torch.arange(w, device=a[2].device))
                      .float().mean())
        print(f"kernel 9 gather {label} ({len(a[0])} sources, {moved:.3f} of "
              f"pixels reproject off their column): words equal on "
              f"{eq:.6f} (need 1)")
        if eq != 1.0:
            fail("kernel 9 disagrees with its plain version")
    return err


def gather_record(rg, call, plain=True):
    """(ms, plain ms (None unless `plain`), library ms, bound) of one
    captured gather call."""
    srcs, piy, pix = call[0]
    h, w = piy.shape
    npix = h * w
    ms = event_ms(lambda: rg.reproj_gather(srcs, piy, pix), REPS)
    plain_ms = (event_ms(lambda: rg.gather_plain(srcs, piy, pix), PLAIN_REPS)
                if plain else None)
    # yardstick: one PyTorch indexing call fetching the same 64 B rows, on
    # the sources as [n, hs*w + 1, 16] rows with a zero row for rejects
    n = len(srcs)
    rows = torch.cat([torch.stack(srcs).permute(0, 1, 3, 2).reshape(
        n, h * w, 16), torch.zeros((n, 1, 16), device=piy.device)], 1)
    ok = (piy >= 0) & (piy < h) & (pix >= 0) & (pix < w)
    idx = torch.where(ok, piy * w + pix, h * w).reshape(-1)
    lib_ms = event_ms(lambda: rows[:, idx], REPS)
    nbytes = n * npix * 16 * 4 * 2 + npix * 8
    return ms, plain_ms, lib_ms, bound_ms(nbytes, 0)


def light_work(lf, gpu, a, k):
    """(bound ms, bound by) of one call of the lighting kernel, B (no
    reuse) or 4 (temporal): the bytes of its inputs and outputs, the
    reservoir algebra and shading per active channel, and the triangle
    tests this frame's variant traces, for B at its valid pixels only."""
    h, w = a[6].shape[:2]
    npix = h * w
    p = a[0].cpu().numpy()
    temporal = k.get("temporal", False)
    val = ((bool(p[lf._P_VAL]), bool(p[lf._P_VAL + 1])) if temporal
           else (False, False))
    n_de = int(k["has_sun"]) + int(k["n_em"] > 0)
    n_ch = n_de + int(k["bounces"] > 0)
    if temporal:
        # per active channel: render, var, packed; flags + scatter only for
        # active d/e channels under track_de, i_flags only under track_ind
        out_b = (4 * (4 + 1 + 16) * n_ch
                 + 4 * (1 + 16) * n_de * k["track_de"]
                 + 4 * int(k["bounces"] > 0) * k["track_ind"])
        nbytes = npix * (4 * (4 + 3 + 2 + 4) + 64 * n_ch + out_b)
        flops = npix * (FLOPS_RESERVOIR + 400) * n_ch
        traced = npix
    else:
        # position in and one render per active channel out for every
        # pixel; normal, ids and noise in, shading and tests for the valid
        # ones (kernel B writes an invalid pixel's zeros and returns)
        traced = int((a[6][..., 3] >= 1.1920929e-7).sum())
        nbytes = npix * (4 * 4 + 16 * n_ch) + traced * 4 * (3 + 2 + 4)
        flops = traced * 400 * n_ch
    tests = tri_tests(gpu, k["has_sun"], k["n_em"], k["bounces"], val)
    flops += traced * tests * FLOPS_PER_TRI_TEST
    return bound_ms(nbytes, flops)


def light_records(lf, gpu, calls, plain=True, device=True):
    """Records of captured calls (a, k) of the lighting kernel: each call's
    time by events and on the host (host_us) and its bound (light_work)
    first, for every call, before any profiler session (the host reads
    slower after one); then, with `device`, each call's device time
    (profiler) and, when `plain`, the plain version's time
    (light_device)."""
    recs = []
    for a, k in calls:
        def run(a=a, k=k):
            return lf.lighting_kernel(*a, **k)

        rec = dict(ms=event_ms(run, REPS), host_us=host_us(run, HOST_REPS // 4))
        rec["bound_ms"], rec["bound_by"] = light_work(lf, gpu, a, k)
        recs.append(rec)
    if device:
        light_device(lf, calls, recs, plain)
    return recs


def light_device(lf, calls, recs, plain=True):
    """The device pass of light_records."""
    for rec, (a, k) in zip(recs, calls):
        rec["device_ms"] = device_ms(lambda: lf.lighting_kernel(*a, **k), REPS,
                                     "light_kernel")
        if plain:
            rec["plain_ms"] = event_ms(lambda: lf.lighting_plain(*a, **k),
                                       PLAIN_REPS)


def light_record(lf, gpu, a, k):
    """light_records of one call."""
    return light_records(lf, gpu, [(a, k)])[0]


def spatial_record(sf, a, k):
    """(ms, plain ms, (bound ms, bound by)) of one captured call of kernel
    10, counting the taps this frame's data evaluates: valid pixels whose
    tap lands in the image."""
    h, w = a[4].shape[:2]
    npix = h * w
    ms_ = event_ms(lambda: sf.spatial_kernel(*a, **k), REPS)
    plain_ = event_ms(lambda: sf.spatial_plain(*a, **k), PLAIN_REPS)
    p = a[0].cpu().numpy()
    valid = a[4][..., 3] >= 1.1920929e-7
    taps = 0
    for t in range(sf.channel_taps(k["emissive_lit"])[0]):
        oy, ox = (int(v) for v in p[sf._S_TAPS + sf._TAP_STRIDE * t:
                                    sf._S_TAPS + sf._TAP_STRIDE * t + 2])
        taps += int(valid[max(0, -oy):h - max(0, oy),
                          max(0, -ox):w - max(0, ox)].sum())
    per_tap = FLOPS_TAP + (0 if k["emissive_lit"] else FLOPS_SHADE)
    flops = npix * (FLOPS_RESERVOIR + FLOPS_SHADE) + taps * per_tap
    nbytes = npix * (64 + 64 + 16 + 4 + 16 + 4 + 64)
    out = (ms_, plain_, bound_ms(nbytes, flops))
    print(f"  kernel 10 {'emissive' if k['emissive_lit'] else 'indirect'} "
          f"{h}x{w}: {ms_:.4f} ms, plain {plain_:.1f} ms, bound "
          f"{out[2][0]:.4f} ms ({out[2][1]}), {taps} taps")
    return out


def atrous_bound(npix, nch):
    """Bytes and flops of one a-trous level over nch channels."""
    nbytes = npix * (2 * 3 * nch + 2 * (2 + nch) + 4 * 5 + 2 * 3 * nch)
    flops = npix * (8 * (20 + 25 * nch) + 30 * nch)
    return bound_ms(nbytes, flops)


def check_reuse(ht, build_box):
    """Kernels 9, 4, 10 (and C on real variance) against their plain
    versions on the inputs the reuse paths give them at 1080p, and the
    directional branch at 270x480. Returns the records of 9, 4, 10."""
    from hikari_tpu_torch import frame as fr
    from hikari_tpu_torch.ops import denoise_fused as dnf
    from hikari_tpu_torch.ops import light_fused as lf
    from hikari_tpu_torch.ops import prepass_fused as pf
    from hikari_tpu_torch.ops import reproj_gather as rg
    from hikari_tpu_torch.ops import spatial_fused as sf

    box_host = build_box()
    gpu = box_host.compile()
    caps = [Capture(fr, "reproj_gather"), Capture(lf, "lighting_kernel"),
            Capture(sf, "spatial_kernel"), Capture(pf, "prepass_kernel")]
    keep = (CHECK_FRAMES - 3, CHECK_FRAMES - 2)      # frames 4 and 5
    with caps[0], caps[1], caps[2], caps[3]:
        drive(ht, box_host, FULL, PATHS["S"][0](ht), CHECK_FRAMES - 1, caps,
              keep)
    gather_calls, light_s, spatial_s, prepass_s = (c.calls for c in caps)
    for a, _ in prepass_s:
        check_prepass_call(pf, a, "path S")

    # --- kernel 9: bit for bit
    err9 = check_gather_calls(rg, gather_calls, "path S")
    ms, plain_ms, lib_ms, (b_ms, b_by) = gather_record(rg, gather_calls[-1])
    rec9 = dict(
        name="reproj_gather", route="cuda",
        source="hikari_tpu_torch/csrc/reproj_gather.cu",
        replaces="hikari_tpu/ops/reproj_gather.py:80", launches=None,
        max_abs_err=err9, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=lib_ms)

    # --- kernel 4 with tracking (S) on a no-validation and a validation
    # frame, then without tracking (R)
    err4, words4 = check_lighting_calls(lf, light_s, "path S")
    caps = [Capture(lf, "lighting_kernel"), Capture(dnf, "atrous_level"),
            Capture(fr, "reproj_gather")]
    with caps[0], caps[1], caps[2]:
        drive(ht, box_host, FULL, PATHS["R"][0](ht), CHECK_FRAMES - 1, caps,
              keep)
    light_r, levels_r = caps[0].calls, caps[1].calls
    rec9["max_abs_err"] = max(err9, check_gather_calls(rg, caps[2].calls,
                                                       "path R"))
    err_r, words_r = check_lighting_calls(lf, light_r, "path R")
    err4, words4 = max(err4, err_r), min(words4, words_r)
    check_levels(dnf, levels_r[-4:], "path R's real variance")

    (a_nv, k_nv), (a_v, k_v) = light_s
    rec, rec_v = light_records(lf, gpu, light_s)
    print_kernel_times("kernel 4 path S 1080p, no validation", rec)
    print_kernel_times("kernel 4 path S 1080p, emissive validation", rec_v)
    rec4 = dict(
        name="light_fused_temporal", route="cuda",
        source="hikari_tpu_torch/csrc/light_fused.cu",
        replaces="hikari_tpu/ops/light_fused.py:592", launches=None,
        max_abs_err=err4, words_equal=words4, library_ms=None, **rec,
        **{f"{key}_validation": v for key, v in rec_v.items()
           if key != "bound_by"})

    # --- kernel 10, both channels of the last captured S frame
    err10, words10 = check_spatial_calls(sf, spatial_s, "path S")
    per = [spatial_record(sf, a, k) for a, k in spatial_s[-2:]]
    rec10 = dict(
        name="spatial_fused", route="cuda",
        source="hikari_tpu_torch/csrc/spatial_fused.cu",
        replaces="hikari_tpu/ops/spatial_fused.py:150", launches=None,
        max_abs_err=err10, words_equal=words10,
        ms=float(np.mean([p[0] for p in per])),
        plain_ms=float(np.mean([p[1] for p in per])),
        bound_ms=float(np.mean([p[2][0] for p in per])),
        bound_by=per[-1][2][1], library_ms=None,
        ms_emissive=per[0][0], ms_indirect=per[1][0])

    # --- the directional branch: the box with a sun, path S at 270x480
    sun_host = sun_box(build_box)
    caps = [Capture(lf, "lighting_kernel"), Capture(sf, "spatial_kernel"),
            Capture(pf, "prepass_kernel")]
    with caps[0], caps[1], caps[2]:
        r = drive(ht, sun_host, SUN, PATHS["S"][0](ht), CHECK_FRAMES, caps,
                  (CHECK_FRAMES - 3, CHECK_FRAMES - 2, CHECK_FRAMES - 1))
    if not r.gpu_scene.has_sun:
        fail("the sun scene has no sun")
    check_lighting_calls(lf, caps[0].calls, "sun 270x480")
    check_spatial_calls(sf, caps[1].calls, "sun")
    for a, _ in caps[2].calls:
        check_prepass_call(pf, a, "sun")
    # kernel B's solar channel: the no-reuse frame on the box with a sun
    cap = Capture(lf, "lighting_kernel")
    with cap:
        drive(ht, sun_host, SUN, PATHS["no-reuse"][0](ht), 3, [cap], (2,))
    if not cap.calls[-1][1]["has_sun"]:
        fail("kernel B's sun call has no direct channel")
    check_b_call(lf, *cap.calls[-1], "sun")
    return [rec9, rec4, rec10]


def words_frac(got, ref):
    """The fraction of the floats of two tensors equal to the bit (an exact
    count: 1.0 only when all are)."""
    eq = got.view(torch.int32) == ref.view(torch.int32)
    return int(eq.sum()) / eq.numel()


def words_equal(got, ref):
    """Every float of the tensors equal to the bit."""
    return all(torch.equal(g.view(torch.int32), r.view(torch.int32))
               for g, r in zip(got, ref))


def max_abs_err(got, ref):
    """The largest |got - ref| over paired tensors (equal values, infinities
    included, and NaN at the same places count as 0)."""
    worst = 0.0
    for g, r in zip(got, ref):
        g, r = g.float(), r.float()
        same = (g == r) | (torch.isnan(g) & torch.isnan(r))
        d = torch.where(same, 0.0, (g - r).abs())
        worst = max(worst, float(torch.nan_to_num(d, nan=float("inf")).max()))
    return worst


def grid_nearest(src, sy, sx):
    """One torch.nn.functional.grid_sample call (nearest, border) over the
    HWC source at the coords: the time yardstick of the nearest warps (its
    tie rule differs, so it is not a parity reference)."""
    import torch.nn.functional as F

    hs, ws = src.shape[:2]
    inp = src.permute(2, 0, 1)[None].contiguous()
    grid = torch.stack([(2.0 * sx + 1.0) / ws - 1.0,
                        (2.0 * sy + 1.0) / hs - 1.0], -1)[None]
    return lambda: F.grid_sample(inp, grid, mode="nearest",
                                 padding_mode="border", align_corners=False)


def quads_checks(pf, quad_calls, a_calls):
    """Kernel 8 bit for bit against its plain version and against kernel
    A's strided planes (parity_quads of the G-buffer kernel A writes again
    from the captured call of the same frame), on the captured calls.
    Returns the max abs error against the plain version."""
    from hikari_tpu_torch.ops.smaa import parity_quads

    def strided(a_args):
        quads = parity_quads(pf._assemble(*pf.prepass_kernel(*a_args))[0])
        return [torch.stack([quads[ab][k] for ab in pf.QUAD_PARITIES])
                for k in ("depth", "velocity", "instance")]

    err = 0.0
    for (qa, _), (aa, _) in zip(quad_calls, a_calls):
        got = pf.prepass_quads_kernel(*qa)
        ref = pf.quads_plain(*qa)
        eq_a = words_equal(got, strided(aa))
        torch.cuda.synchronize()
        eq_plain = words_equal(got, ref)
        err = max(err, max_abs_err(got, ref))
        print(f"kernel 8 quads {tuple(got[0].shape[1:])} x 4 parities: equal "
              f"to the plain version {eq_plain}, to kernel A's strided "
              f"planes {eq_a} (need both)")
        if not (eq_plain and eq_a):
            fail("kernel 8 disagrees with its plain version or kernel A")
    return err


def quads_times(pf, qa, aa):
    """Kernel 8's call `qa` timed by events, on the host and on the device,
    beside its plain version and the library yardstick: the 12 strided
    views of kernel A's planes (call `aa`) made contiguous."""
    from hikari_tpu_torch.ops.smaa import parity_quads

    views = parity_quads(pf._assemble(*pf.prepass_kernel(*aa))[0])

    def library():
        return [t.contiguous() for q in views.values() for t in q.values()]

    rec = kernel_times([(lambda: pf.prepass_quads_kernel(*qa), library)],
                       "quads_kernel", "")[0]
    rec["plain_ms"] = event_ms(lambda: pf.quads_plain(*qa), PLAIN_REPS)
    return rec


# float32 words a G-buffer may hold that arithmetic would not keep: quiet
# and signalling NaNs with payloads, -0.0, infinities, a denormal
SPECIAL_WORDS = (0x7FC00001, 0x7F800001, 0xFFC0BEEF, 0xFFA00000, 0x80000000,
                 0x7F800000, 0xFF800000, 0x00000001)


def special_words(shape, gen):
    """Random float32 words on the card, 30% of them SPECIAL_WORDS."""
    bits = torch.randint(-2 ** 31, 2 ** 31, shape, generator=gen,
                         device=DEVICE, dtype=torch.int64).to(torch.int32)
    table = torch.tensor(np.array(SPECIAL_WORDS, np.uint32).view(np.int32),
                         device=DEVICE)
    pick = torch.rand(shape, generator=gen, device=DEVICE) < 0.3
    idx = torch.randint(0, len(SPECIAL_WORDS), shape, generator=gen,
                        device=DEVICE)
    return torch.where(pick, table[idx], bits).view(torch.float32)


# kernel 8's synthetic G-buffers: 1080p, and planes of odd height and width
QUAD_FIELD_SIZES = ((1080, 1920), (1082, 1930))


def check_quads_field(pf):
    """Kernel 8 on synthetic G-buffers of random words (NaN payloads, -0.0,
    infinities, denormals) at 1080p and at 1082x1930 (planes of odd height
    and width): bit for bit against its plain version and against the strided
    words."""
    gen = torch.Generator(device=DEVICE).manual_seed(8)
    for h, w in QUAD_FIELD_SIZES:
        planes = [special_words((h, w, c), gen) for c in (4, 4, 2)]
        got = pf.prepass_quads_kernel(*planes)
        ref = pf.quads_plain(*planes)
        want = [torch.stack([t[a::2, b::2, k] for a, b in pf.QUAD_PARITIES])
                for t, k in zip(planes, (3, slice(0, 2), 0))]
        torch.cuda.synchronize()
        ok = words_equal(got, ref) and words_equal(got, want)
        print(f"kernel 8 synthetic G-buffer {h}x{w}: words equal to the "
              f"plain version and the strided words {ok} (need True)")
        if not ok:
            fail("kernel 8 changed a word of a synthetic G-buffer")


def check_quads(pf, quad_calls, a_calls):
    """Kernel 8 on the captured calls and on synthetic G-buffers, bit for
    bit; returns its record. Its bound: 16 B read and 16 B written per
    image pixel."""
    err = quads_checks(pf, quad_calls, a_calls)
    check_quads_field(pf)
    qa, aa = quad_calls[-1][0], a_calls[-1][0]
    rec = quads_times(pf, qa, aa)
    h, w = qa[0].shape[:2]
    b_ms, b_by = bound_ms(32 * h * w, 0)
    print_kernel_times(f"kernel 8 quads {h}x{w}", dict(rec, bound_ms=b_ms))
    return dict(
        name="prepass_quads", route="cuda",
        source="hikari_tpu_torch/csrc/prepass_fused.cu",
        replaces="hikari_tpu/ops/prepass_fused.py:276", launches=None,
        max_abs_err=err, bound_ms=b_ms, bound_by=b_by, **rec)


WARP_TAPS = {"nearest": 1, "bilinear": 4, "catmull": 16}


def warp_work(n_out, n_src, reads):
    """(bytes, flops) a warp needs at its least: for each (kind, channels)
    read, the f32 texels its filter taps, at most the whole source; the two
    coords and the outputs. A filtered channel costs 16 taps of a
    multiply-add and the 4 row sums, its 8 weights ~10 flops each."""
    texels = sum(f * min(WARP_TAPS[k] * n_out, n_src) for k, f in reads)
    nbytes = 4 * (texels + n_out * (2 + sum(f for _, f in reads)))
    flops = n_out * sum(40 * f + 80 for k, f in reads if k != "nearest")
    return nbytes, flops


def host_us(fn, reps=HOST_REPS):
    """Microseconds of host time per fn() call: `reps` calls enqueued back
    to back without a synchronize (the wrapper's own cost, which event_ms
    counts too for a kernel shorter than it)."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t) / reps * 1e6
    torch.cuda.synchronize()
    return us


def kernel_times(calls, kernel, library_kernel):
    """For each (kernel call, library call or None) of `calls`, a dict of
    the kernel call's events ms, host us and device ms (profiler, kernels
    whose name contains `kernel`) and the same three of the library call
    (its kernels named `library_kernel`, summed per call). All events and
    host times come first: host times read higher later in a process,
    after a profiler session."""
    recs = []
    for fn, lib_fn in calls:
        rec = dict(ms=event_ms(fn, REPS), host_us=host_us(fn))
        if lib_fn is not None:
            rec.update(library_ms=event_ms(lib_fn, REPS),
                       library_host_us=host_us(lib_fn))
        recs.append(rec)
    for rec, (fn, lib_fn) in zip(recs, calls):
        rec["device_ms"] = device_ms(fn, REPS, kernel)
        if lib_fn is not None:
            rec["library_device_ms"] = device_ms(lib_fn, REPS,
                                                 library_kernel, True)
    return recs


def warp_band_bound(call):
    """(bound ms, by) of one captured kernel 11 call."""
    sources, kinds, sy, _ = call[0]
    h, w = sy.shape
    return bound_ms(*warp_work(h * w, sources[0].shape[0] * w, [
        (k, s.shape[2]) for k, s in zip(kinds, sources)]))


def print_kernel_times(label, rec):
    def num(key):
        v = rec.get(key)
        return "n/a" if v is None else f"{v:.4f}"

    line = (f"  {label}: {num('ms')} ms by events, device {num('device_ms')}"
            f" ms, host {num('host_us')} us per call; bound "
            f"{num('bound_ms')} ms")
    if rec.get("library_ms") is not None:
        line += (f"; library {num('library_ms')} ms, device "
                 f"{num('library_device_ms')} ms, host "
                 f"{num('library_host_us')} us")
    print(line)


def check_band_calls(wb, band_calls):
    """Kernel 11 against its plain version on captured calls: nearest
    sources bit for bit, filtered ones within 1e-5 * max(|ref|, 1) on
    >= 99.99% of values. Returns the max abs error."""
    err11 = 0.0
    for a, _ in band_calls:
        _, kinds, sy, _ = a
        got = wb.warp_band(*a)
        ref = wb.band_plain(*a)
        torch.cuda.synchronize()
        for kind, g, r in zip(kinds, got, ref):
            words = words_frac(g, r)
            if kind == "nearest":
                frac, need = words, 1.0
            else:
                frac, need = rel_close(g, r, 1e-5)[0], 0.9999
            err = max_abs_err([g], [r])
            err11 = max(err11, err)
            print(f"kernel 11 warp_band {tuple(sy.shape)} {kind} "
                  f"x{g.shape[2]}: equal / within 1e-5*max(|ref|,1) on "
                  f"{frac:.6f} (need {need}); words equal on {words:.6f}; "
                  f"max abs err {err:.3g}")
            if frac < need:
                fail("kernel 11 disagrees with its plain version")
    return err11


def check_multi_calls(w2, multi_calls):
    """Kernel 12 against its plain version on captured calls, bit for
    bit. Returns the max abs error."""
    err12 = 0.0
    for a, k in multi_calls:
        got = w2.warp_multi(*a, **k)
        ref = w2.multi_plain(*a, k.get("dtype") == torch.bfloat16)
        torch.cuda.synchronize()
        ok = words_equal(got, ref)
        err12 = max(err12, max_abs_err(got, ref))
        print(f"kernel 12 warp_multi {tuple(a[1].shape)} from "
              f"{tuple(a[0].shape)}: words equal {ok} (need True)")
        if not ok:
            fail("kernel 12 disagrees with its plain version")
    return err12


def check_warps(wb, w2, band_calls, multi_calls):
    """Kernels 11 and 12 against their plain versions on the captured
    calls; returns their records (row 11: the TAA call at the output
    size, with SMAA's tone call beside it, keys *_smaa_call; max_abs_err
    over every call). Each call is timed by events, on the device and on
    the host, and the nearest ones beside one grid_sample."""
    err11 = check_band_calls(wb, band_calls)
    err12 = check_multi_calls(w2, multi_calls)

    taa = next(c for c in reversed(band_calls) if "catmull" in c[0][1])
    smaa = next(c for c in reversed(band_calls) if c[0][1] == ("nearest",))
    a, k = multi_calls[-1]
    src, sy, sx, reduces = a[:4]
    s_src, _, s_sy, s_sx = smaa[0]
    taa_rec, smaa_rec, multi_rec = kernel_times([
        (lambda: wb.warp_band(*taa[0]), None),
        (lambda: wb.warp_band(*smaa[0]), grid_nearest(s_src[0], s_sy, s_sx)),
        (lambda: w2.warp_multi(*a, **k), grid_nearest(src, sy, sx))],
        "warp_", "grid_sampler")
    rec11 = dict(
        name="warp_band", route="cuda", source="hikari_tpu_torch/csrc/warp.cu",
        replaces="hikari_tpu/ops/warp_band.py:95", launches=None,
        max_abs_err=err11, library_ms=None, **taa_rec)
    rec11["plain_ms"] = event_ms(lambda: wb.band_plain(*taa[0]), PLAIN_REPS)
    rec11["bound_ms"], rec11["bound_by"] = warp_band_bound(taa)
    smaa_rec["plain_ms"] = event_ms(lambda: wb.band_plain(*smaa[0]),
                                    PLAIN_REPS)
    smaa_rec["bound_ms"] = warp_band_bound(smaa)[0]
    rec11.update({f"{key}_smaa_call": v for key, v in smaa_rec.items()})
    h, w = sy.shape
    b_ms, b_by = bound_ms(*warp_work(
        h * w, src.shape[0] * src.shape[1],
        [(kind, hi - lo) for kind, _, (lo, hi) in reduces]))
    rec12 = dict(
        name="warp_multi", route="cuda",
        source="hikari_tpu_torch/csrc/warp.cu",
        replaces="hikari_tpu/ops/warp2.py:68", launches=None,
        max_abs_err=err12, plain_ms=event_ms(
            lambda: w2.multi_plain(*a, k.get("dtype") == torch.bfloat16),
            PLAIN_REPS),
        bound_ms=b_ms, bound_by=b_by, **multi_rec)
    print_kernel_times(f"kernel 11 TAA call {tuple(taa[0][2].shape)}", rec11)
    print_kernel_times(f"kernel 11 SMAA call {tuple(smaa[0][2].shape)}",
                     smaa_rec)
    print_kernel_times(f"kernel 12 SMAA call {tuple(sy.shape)}", rec12)
    return rec11, rec12


# the source layouts the warps branch on: (pixel stride, channels)
WARP_LAYOUTS = {"3 of stride 4": (4, 3), "6 contiguous": (6, 6),
                "1 channel": (1, 1), "5 of stride 8": (8, 5)}
MULTI_LAYOUTS = {"4 contiguous": (4, 4), "16 contiguous": (16, 16),
                 "3 of stride 4": (4, 3)}
# synthetic field sizes: (output h, w, source rows of kernel 11)
FIELD_SIZES = ((1080, 1920, 1080), (540, 960, 540), (541, 963, 546))


def warp_field(h, w, hs, ws, seed):
    """[h, w] float32 coords into an [hs, ws] source: a smooth reprojection
    (a few pixels) scaled to spill 4.5 px beyond every edge; rows [h/3,
    h/2) snapped to exact .5 ties; rows [h/2, 2h/3) uniform over the whole
    source and past its edges, so those blocks' texel boxes exceed the
    shared-memory budget."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.arange(h, dtype=np.float64),
                         np.arange(w, dtype=np.float64), indexing="ij")
    sy = (yy + 0.5) * (hs + 9.0) / h - 5.0 + 1.5 * np.sin(xx / 37.0)
    sx = (xx + 0.5) * (ws + 9.0) / w - 5.0 + 2.0 * np.cos(yy / 23.0)
    ties = slice(h // 3, h // 2)
    sy[ties] = np.floor(sy[ties]) + 0.5
    sx[ties] = np.floor(sx[ties]) + 0.5
    far = slice(h // 2, 2 * h // 3)
    sy[far] = rng.uniform(-3.0, hs + 2.0, sy[far].shape)
    sx[far] = rng.uniform(-3.0, ws + 2.0, sx[far].shape)
    return (torch.from_numpy(a.astype(np.float32)).to(DEVICE)
            for a in (sy, sx))


def layout_source(hs, ws, layout, gen):
    """A float32 [hs, ws, F] source of (pixel stride, F): the first F
    channels of a contiguous [hs, ws, stride] tensor."""
    p, f = layout
    t = torch.rand((hs, ws, p), generator=gen, device=DEVICE) * 4.0 - 1.0
    return t[..., :f]


def check_warp_fields(wb, w2):
    """Kernels 11 and 12 on synthetic fields at 1080p, 540p and 541x963
    (edges, .5 ties, footprints beyond the staging budget) over every
    layout of WARP_LAYOUTS / MULTI_LAYOUTS: nearest and every kernel 12
    output word for word, filtered outputs within 1e-5 * max(|ref|, 1) on
    >= 99.99%; the staged and direct blocks of the tiled (catmull, nearest)
    instance counted (both must be non-zero)."""
    gen = torch.Generator(device=DEVICE).manual_seed(7)
    blocks = torch.zeros(2, dtype=torch.int32, device=DEVICE)
    n_calls, filtered_words = 0, 1.0
    for h, w, hs in FIELD_SIZES:
        sy, sx = warp_field(h, w, hs, w, h + w)
        n_blocks = -(-h // 8) * -(-w // 32)
        for name, lay in WARP_LAYOUTS.items():
            for kinds in (("catmull", "nearest"), ("nearest",),
                          ("bilinear", "catmull")):
                srcs = [layout_source(hs, w, lay, gen) for _ in kinds]
                blocks.zero_()
                got = wb.warp_band(srcs, kinds, sy, sx, blocks=blocks)
                ref = wb.band_plain(srcs, kinds, sy, sx)
                torch.cuda.synchronize()
                n_calls += 1
                for kind, g, r in zip(kinds, got, ref):
                    words = words_frac(g, r)
                    frac = words if kind == "nearest" else \
                        rel_close(g, r, 1e-5)[0]
                    if kind != "nearest":
                        filtered_words = min(filtered_words, words)
                    if frac < (1.0 if kind == "nearest" else 0.9999):
                        fail(f"kernel 11 {kind} on the {h}x{w} field, "
                             f"{name}: {frac:.6f} equal / within tolerance "
                             f"(words {words:.6f})")
                staged, direct = (int(v) for v in blocks.tolist())
                if kinds[0] != "catmull" or staged + direct == 0:
                    continue          # the generic instance stages nothing
                print(f"kernel 11 field {h}x{w} {name} {'+'.join(kinds)}: "
                      f"blocks staged {staged}, direct {direct} (need both "
                      f"> 0, of {n_blocks})")
                if staged == 0 or direct == 0 or staged + direct != n_blocks:
                    fail("kernel 11 did not take both staging branches")
        for name, lay in MULTI_LAYOUTS.items():
            f = lay[1]
            src = layout_source(2 * h, 2 * w, lay, gen)
            my, mx = warp_field(h, w, 2 * h, 2 * w, h + w + 1)
            for reduces, dtype in (
                    ([("nearest", (0.0, 0.0), (0, f))], torch.bfloat16),
                    ([("nearest", (1.0, -0.5), (0, f)),
                      ("nearest", (0.5, 0.0), (f // 2, f))], torch.float32),
                    ([("bilinear", (1.0, -1.0), (0, f)),
                      ("catmull", (0.0, 0.5), (f - 1, f))], torch.bfloat16)):
                got = w2.warp_multi(src, my, mx, reduces, dtype=dtype)
                ref = w2.multi_plain(src, my, mx, reduces,
                                     dtype == torch.bfloat16)
                torch.cuda.synchronize()
                n_calls += 1
                if not words_equal(got, ref):
                    fail(f"kernel 12 on the {h}x{w} field, {name}, "
                         f"{[r[0] for r in reduces]}: words differ")
    print(f"kernels 11 and 12 on {n_calls} synthetic calls over "
          f"{len(FIELD_SIZES)} field sizes: all within their bars; kernel "
          f"11's filtered outputs words equal on >= {filtered_words:.6f}")


def light_ab(ht, build_box, lf, d_calls):
    """--ab's lighting records: kernel 4 on R's and S's calls at 1080p and
    D's at 960x540 (frames 4 and 5 of a panning camera: without and with
    the emissive channel's validation retrace; D's given, as `d_calls`),
    and kernel B on the no-reuse frame's 1080p call, P's 960x540 call and
    K's 1080x960 call (frame 2 of each), each checked against its plain
    version (the share of equal words printed) and timed by events, on the
    device and on the host."""
    gpu = build_box().compile()
    keep = (CHECK_FRAMES - 3, CHECK_FRAMES - 2)
    calls = {}
    for path in ("R", "S"):
        cap = Capture(lf, "lighting_kernel")
        with cap:
            drive(ht, build_box(), FULL, PATHS[path][0](ht),
                  CHECK_FRAMES - 1, [cap], keep)
        calls[path] = cap.calls
    calls["D"] = d_calls
    for path in ("no-reuse", "P", "K"):
        cap = Capture(lf, "lighting_kernel")
        with cap:
            drive(ht, build_box(), FULL, PATHS[path][0](ht), 3, [cap], (2,))
        calls[path] = cap.calls[-1:]
    named = []
    for path, path_calls in calls.items():
        for a, k in path_calls:
            h, w = a[6].shape[:2]
            name = f"light_{path}_{h}x{w}"
            if k.get("temporal", False):
                p = a[0].cpu().numpy()
                val = bool(p[lf._P_VAL] or p[lf._P_VAL + 1])
                name = f"{name}{'_validation' if val else ''}"
                err, words = check_lighting_calls(lf, [(a, k)], path)
            else:
                err, words = check_b_call(lf, a, k, path)
            named.append((dict(name=name, max_abs_err=err, words_equal=words),
                          (a, k)))
    calls = [c for _, c in named]
    times = light_records(lf, gpu, calls, plain=False, device=False)

    def device_pass():
        light_device(lf, calls, times, plain=False)
        for (rec, _), t in zip(named, times):
            rec.update(t)
            print_kernel_times(rec["name"], rec)

    return [rec for rec, _ in named], device_pass


def gather_ab(ht, build_box, d_calls):
    """--ab's kernel 9 records: the gather calls of R and S (1080p; 2 and 4
    sources), D (960x540, 3 sources; given, as `d_calls`) and KR (1080p,
    2 sources), frame 5 of a panning camera, and of the city's frame 1
    (960x540, 3 sources, a static camera), each held word for word against
    gather_plain and timed by events and on the host (before any profiler
    session), beside its bound and the rows[:, idx] yardstick
    (gather_record). Reached only through reproj_gather and gather_plain,
    so it times a parent tree's kernel alike. Returns the records and the
    pass that adds their device times."""
    from hikari_tpu_torch import frame as fr
    from hikari_tpu_torch.examples import city
    from hikari_tpu_torch.ops import reproj_gather as rg

    calls = {}
    for path in ("R", "S", "KR"):
        cap = Capture(fr, "reproj_gather")
        with cap:
            drive(ht, build_box(), FULL, PATHS[path][0](ht), CHECK_FRAMES - 1,
                  [cap], (CHECK_FRAMES - 2,))
        calls[path] = cap.calls[-1]
    calls["D"] = d_calls[-1]
    sc = city.build_scene(3)
    r = ht.Renderer(sc, city_camera(ht, FULL), ht.HikariSettings())
    cap = Capture(fr, "reproj_gather")
    with cap:
        for f in range(2):
            r.update_scene(city.rotate_sphere(sc, city_angle(f)), fast=True)
            cap.on = f == 1
            r.render_frame()
        torch.cuda.synchronize()
    calls["city"] = cap.calls[-1]
    named = []
    for path, call in calls.items():
        srcs, piy, pix = call[0]
        h, w = piy.shape
        err = check_gather_calls(rg, [call], f"--ab {path}")
        ms, _, lib_ms, (b_ms, b_by) = gather_record(rg, call, plain=False)
        run = (lambda a=call[0]: rg.reproj_gather(*a))
        named.append((dict(name=f"gather_{path}_{h}x{w}_{len(srcs)}src",
                           words_equal=1.0, max_abs_err=err, ms=ms,
                           host_us=host_us(run), bound_ms=b_ms,
                           bound_by=b_by, library_ms=lib_ms), run))

    def device_pass():
        for rec, run in named:
            rec["device_ms"] = device_ms(run, REPS, "gather_kernel")
            print_kernel_times(rec["name"], rec)

    return [rec for rec, _ in named], device_pass


def prepass_spatial_ab(ht, build_box, d_calls):
    """--ab's records of kernels A and 10: A on the no-reuse frame's call
    and path D's (both 1080p), 10 on path S's two 1080p calls (frame 5)
    and D's 960x540 call (`d_calls`: D's captured (prepass_kernel,
    prepass_fused.pack_params, spatial_kernel, spatial_fused.pack_params)
    calls), each checked against its plain version (the share of equal
    words printed) and timed by events and on the host, the wrapper's call
    and its pack_params' apart, before any profiler session. Returns the
    records and the pass that adds their device times."""
    from hikari_tpu_torch.ops import prepass_fused as pf
    from hikari_tpu_torch.ops import spatial_fused as sf

    caps = [Capture(pf, "prepass_kernel"), Capture(pf, "pack_params")]
    with caps[0], caps[1]:
        drive(ht, build_box(), FULL, PATHS["no-reuse"][0](ht), 3, caps,
              (2,))
    a_calls = [("no-reuse", caps[0].calls[-1], caps[1].calls[-1]),
               ("D", d_calls[0][-1], d_calls[1][-1])]
    caps = [Capture(sf, "spatial_kernel"), Capture(sf, "pack_params")]
    with caps[0], caps[1]:
        drive(ht, build_box(), FULL, PATHS["S"][0](ht), CHECK_FRAMES - 1,
              caps, (CHECK_FRAMES - 2,))
    s_calls = [("S", c, pc) for c, pc in zip(caps[0].calls, caps[1].calls)]
    s_calls.append(("D", d_calls[2][-1], d_calls[3][-1]))
    named = []
    for path, (a, k), pack in a_calls:
        err, words = check_prepass_call(pf, a, path)
        named.append((dict(name=f"prepass_{path}_{a[5][0]}x{a[5][1]}",
                           max_abs_err=err, words_equal=words),
                      lambda a=a: pf.prepass_kernel(*a), pf.pack_params,
                      pack, "prepass_kernel"))
    for path, (a, k), pack in s_calls:
        h, w = a[4].shape[:2]
        chan = "emissive" if k["emissive_lit"] else "indirect"
        err, words = check_spatial_calls(sf, [(a, k)], path)
        named.append((dict(name=f"spatial_{path}_{chan}_{h}x{w}",
                           max_abs_err=err, words_equal=words),
                      lambda a=a, k=k: sf.spatial_kernel(*a, **k),
                      sf.pack_params, pack, "spatial_kernel"))
    for rec, run, pack_fn, (pa, pk), _ in named:
        rec.update(ms=event_ms(run, REPS), host_us=host_us(run),
                   pack_host_us=host_us(lambda: pack_fn(*pa, **pk)))

    def device_pass():
        for rec, run, _, _, kernel in named:
            rec["device_ms"] = device_ms(run, REPS, kernel)
            print_kernel_times(rec["name"], rec)
            print(f"    pack_params {rec['pack_host_us']:.1f} us on the host")

    return [rec for rec, *_ in named], device_pass


def texture_ab(ht):
    """--ab's kernel 14 records: path T's two frames, every launch checked
    bit for bit against sample_atlas per slot, and frame 1's launches
    (the 1080p G-buffer's, the 960x540 domain's) timed (texture_records)."""
    from hikari_tpu_torch.ops import shading as sh
    from hikari_tpu_torch.ops import texture_pallas as tx

    r = ht.Renderer(simple_scene(), simple_camera(ht, FULL),
                    simple_settings(ht))
    cap = Capture(tx, "sample_atlas_slots")
    with cap:
        cap.on = True
        for _ in range(2):
            r.render_frame()
        torch.cuda.synchronize()
    launches = texture_launches(tx, cap.calls)
    for run, slots in launches:
        got = run()
        ref = [sh.sample_atlas(*a) for a in slots]
        torch.cuda.synchronize()
        eq = words_equal(got, ref)
        print(f"kernel 14 path T {tuple(slots[0][1].shape)}, {len(slots)} "
              f"slots: equal to the plain version {eq} (need True)")
        if not eq:
            fail("kernel 14 disagrees with its plain version (path T)")
    timed = launches[-2:]
    recs = texture_records(sh, timed, device=False)
    for (_, slots), rec in zip(timed, recs):
        rec.update(name=f"texture_{'x'.join(map(str, slots[0][1].shape))}",
                   launches_per_frame=len(launches) // 2)
    return recs, lambda: texture_device(sh, timed, recs)


def ab_only(ht, build_box):
    """--ab: first the frames of paths P and D (alternately, frame by
    frame), then no-reuse, R, S, K, KR, the city, CL, T and M (eleven paths,
    each with its launch counts checked), before any check or profiler
    session; then
    kernels 8, C, 11 and 12 checked against their plain versions and timed
    on path D's calls at 1080p (frames 4 and 5 of a panning camera; C at
    960x540), kernel C timed on a synthetic 1080p field (2 channels, the
    four steps), and before those, so that their host times come before
    any profiler session, kernels 4 and B checked and timed on R's, S's,
    D's, the no-reuse frame's, P's and K's calls (light_ab), kernel 9 on
    R's, S's, D's, KR's and the city's (gather_ab), kernel 14 on path T's
    (texture_ab), kernel A on the no-reuse frame's and D's calls and
    kernel 10 on S's and D's (prepass_spatial_ab), kernel 13 on the
    city's frame-1 calls (walk_ab) and kernels 5, 6 and 7 on KR's frames 4
    and 5 (trace_ab). For timing two trees of
    the repository against each other in one call: it reaches the kernels
    only through their wrappers and plain versions, as captured. Returns
    (records, {frame median name: ms})."""
    from contextlib import ExitStack

    from hikari_tpu_torch import frame as fr
    from hikari_tpu_torch.ops import denoise as dn
    from hikari_tpu_torch.ops import denoise_fused as dnf
    from hikari_tpu_torch.ops import light_fused as lf
    from hikari_tpu_torch.ops import prepass_fused as pf
    from hikari_tpu_torch.ops import spatial_fused as sf
    from hikari_tpu_torch.ops import warp2 as w2
    from hikari_tpu_torch.ops import warp_band as wb

    med, _ = alternate_post_paths(ht, build_box, TIMED_FRAMES)
    frames = {"P_alternating": med["P"], "D_alternating": med["D"]}
    for name in PATHS:
        if name not in ("P", "D"):
            times, _ = main_path(ht, build_box, name, TIMED_FRAMES, False)
            frames[name] = float(np.median(times))
    times, refit, _ = city_path(ht, TIMED_FRAMES, False)
    frames.update(city=float(np.median(times)),
                  city_refit=float(np.median(refit)))
    times, refit, _, _ = city_lamps_path(ht, TIMED_FRAMES, False)
    frames.update(CL=float(np.median(times)),
                  CL_refit=float(np.median(refit)))
    frames["T"] = float(np.median(simple_path(ht, TIMED_FRAMES, False)[0]))
    frames["M"] = float(np.median(minimal_path(ht, TIMED_FRAMES, False)[0]))

    caps = [Capture(pf, "prepass_kernel"), Capture(pf, "prepass_quads_kernel"),
            Capture(dnf, "atrous_level"), Capture(wb, "warp_band"),
            Capture(w2, "warp_multi"), Capture(lf, "lighting_kernel"),
            Capture(pf, "pack_params"), Capture(sf, "spatial_kernel"),
            Capture(sf, "pack_params"), Capture(fr, "reproj_gather")]
    with ExitStack() as stack:
        for c in caps:
            stack.enter_context(c)
        drive(ht, build_box(), FULL, default_settings(ht), CHECK_FRAMES - 1,
              caps, (CHECK_FRAMES - 3, CHECK_FRAMES - 2))
    a_calls, q_calls, c_calls, wb_calls, wm_calls, l_calls = (
        c.calls for c in caps[:6])
    # kernels 4, B, 9, 14, A, 10, 13 and 5-7 first: their events and host
    # times
    # before any profiler session of the process, then their device times
    light_recs, light_dev = light_ab(ht, build_box, lf, l_calls)
    gather_recs, gather_dev = gather_ab(ht, build_box, caps[9].calls)
    tex_recs, tex_dev = texture_ab(ht)
    as_recs, as_dev = prepass_spatial_ab(ht, build_box, [
        a_calls, caps[6].calls, caps[7].calls, caps[8].calls])
    walk_recs, walk_dev = walk_ab(ht)
    trace_recs, trace_dev = trace_ab(ht, build_box)
    light_dev()
    gather_dev()
    tex_dev()
    as_dev()
    walk_dev()
    trace_dev()
    records = (light_recs + gather_recs + tex_recs + as_recs + walk_recs
               + trace_recs)
    quads_checks(pf, q_calls, a_calls)
    rec8 = dict(name="prepass_quads",
                **quads_times(pf, q_calls[-1][0], a_calls[-1][0]))
    levels = c_calls[-4:]
    check_levels(dnf, levels, "path D 960x540")
    rec_c = dict(name="denoise_fused_540p", **atrous_times(dnf, levels))
    irr, geo, f32s = atrous_field(*FULL, 2, torch.Generator(
        device=DEVICE).manual_seed(12))
    field = [((irr, geo, f32s), dict(step=step, nch=2, ffs=(True, True)))
             for step in dn.STEPS]
    check_levels(dnf, field, "synthetic 1080p field")
    rec_c1080 = dict(name="denoise_fused_1080p_field",
                     **atrous_times(dnf, field))
    records += [rec8, rec_c, rec_c1080]
    records += check_warps(wb, w2, wb_calls, wm_calls)
    for rec in (rec8, rec_c, rec_c1080):
        print_kernel_times(rec["name"], rec)
    return records, frames


def pct(a, b):
    """100 a / b, NaN when b is 0."""
    return float(100 * a / b) if b else float("nan")


def ab_summary(paths):
    """--ab-summary: the --ab lines of each file (one file per tree, in
    order): per frame median and kernel time, the median and interquartile
    range over the runs, and the change of each tree's median against the
    first file's."""
    runs = {}
    for path in paths:
        runs[path] = []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if line.startswith("{") and '"ab"' in line:
                    runs[path].append(json.loads(line))
    if not all(runs.values()):
        fail(f"no --ab lines in {[p for p, r in runs.items() if not r]}")

    def metrics(run):
        out = {f"frame {k}": v for k, v in run["frames_ms"].items()}
        for rec in run["ab"]:
            for key in ("ms", "device_ms", "host_us", "library_ms",
                        "bound_ms",
                        "device_ms_per_slot", "library_device_ms",
                        "library_host_us", "words_equal", "pack_host_us"):
                if rec.get(key) is not None:
                    out[f"{rec['name']} {key}"] = rec[key]
        return out

    table = {p: [metrics(r) for r in rs] for p, rs in runs.items()}
    first = next(iter(table))
    summary = {}
    for key in table[first][0]:
        row = {}
        for p, ms in table.items():
            vals = [m[key] for m in ms if key in m]
            if not vals:
                continue
            q1, q2, q3 = np.percentile(vals, [25, 50, 75])
            row[p] = dict(n=len(vals), median=float(q2), iqr=float(q3 - q1),
                          iqr_pct=pct(q3 - q1, q2))
        if first in row:
            for p in row:
                row[p]["vs_first_pct"] = pct(
                    row[p]["median"] - row[first]["median"],
                    row[first]["median"])
        summary[key] = row
        print(f"{key}: " + "; ".join(
            f"{os.path.basename(p)} {r['median']:.4f} (IQR {r['iqr']:.4f}, "
            f"{r['iqr_pct']:.1f}%, n {r['n']}, "
            f"{r.get('vs_first_pct', float('nan')):+.1f}%)"
            for p, r in row.items()))
    print(json.dumps({"ab_summary": summary,
                      "cards": sorted({r.get("card", "") for rs in
                                       runs.values() for r in rs})}))


def check_post(ht, build_box):
    """Kernels 8, 11 and 12 on the inputs the post paths give them at
    1080p with the camera panning, and kernels B, 9, 4, 10 and C at the
    960x540 render size. Returns (the records of 8, 11 and 12, {record
    name: its 960x540 numbers})."""
    from contextlib import ExitStack

    from hikari_tpu_torch import frame as fr
    from hikari_tpu_torch.ops import denoise_fused as dnf
    from hikari_tpu_torch.ops import light_fused as lf
    from hikari_tpu_torch.ops import prepass_fused as pf
    from hikari_tpu_torch.ops import reproj_gather as rg
    from hikari_tpu_torch.ops import spatial_fused as sf
    from hikari_tpu_torch.ops import warp2 as w2
    from hikari_tpu_torch.ops import warp_band as wb

    box_host = build_box()
    gpu = box_host.compile()
    caps = [Capture(pf, "prepass_kernel"), Capture(pf, "prepass_quads_kernel"),
            Capture(fr, "reproj_gather"), Capture(lf, "lighting_kernel"),
            Capture(sf, "spatial_kernel"), Capture(dnf, "atrous_level"),
            Capture(wb, "warp_band"), Capture(w2, "warp_multi")]
    keep = (CHECK_FRAMES - 3, CHECK_FRAMES - 2)      # frames 4 and 5
    with ExitStack() as stack:
        for c in caps:
            stack.enter_context(c)
        drive(ht, box_host, FULL, default_settings(ht), CHECK_FRAMES - 1,
              caps, keep)
    a_calls, q_calls, g_calls, l_calls, s_calls, c_calls, wb_calls, \
        wm_calls = (c.calls for c in caps)

    for a, _ in a_calls:
        check_prepass_call(pf, a, "path D")
    records = [check_quads(pf, q_calls, a_calls)]
    records += check_warps(wb, w2, wb_calls, wm_calls)
    check_warp_fields(wb, w2)

    # --- kernels 9, 4, 10 and C at 960x540 on path D
    label = "path D 960x540"
    check_gather_calls(rg, g_calls, label)
    extra = {}
    ms, plain_ms, _, (b_ms, _) = gather_record(rg, g_calls[-1])
    extra["reproj_gather"] = (ms, plain_ms, b_ms)
    check_lighting_calls(lf, l_calls, label)
    rec = light_record(lf, gpu, *l_calls[0])
    print_kernel_times("kernel 4 path D 960x540, track_ind", rec)
    extra["light_fused_temporal"] = (rec["ms"], rec["plain_ms"],
                                     rec["bound_ms"], rec["device_ms"],
                                     rec["host_us"])
    check_spatial_calls(sf, s_calls, label)
    ms, plain_ms, (b_ms, _) = spatial_record(sf, *s_calls[-1])
    extra["spatial_fused"] = (ms, plain_ms, b_ms)
    levels = c_calls[-4:]
    check_levels(dnf, levels, label)
    irr = levels[0][0][0]
    rec = atrous_times(dnf, levels)
    b_ms = atrous_bound(irr.shape[1] * irr.shape[2], levels[0][1]["nch"])[0]
    print_kernel_times("kernel C a-trous 960x540, per level",
                       dict(rec, bound_ms=b_ms))
    extra["denoise_fused"] = (rec["ms"], rec["plain_ms"], b_ms,
                              rec["device_ms"])

    # --- kernel B at 960x540 on path P
    cap = Capture(lf, "lighting_kernel")
    with cap:
        drive(ht, build_box(), FULL, PATHS["P"][0](ht), 3, [cap], (2,))
    a, k = cap.calls[-1]
    check_b_call(lf, a, k, "path P")
    rec = light_record(lf, gpu, a, k)
    print_kernel_times("kernel B path P 960x540", rec)
    extra["light_fused"] = (rec["ms"], rec["plain_ms"], rec["bound_ms"],
                            rec["device_ms"], rec["host_us"])
    extra = {n: dict(ms_540p=v[0], plain_ms_540p=v[1], bound_ms_540p=v[2],
                     **({} if len(v) < 4 else {"device_ms_540p": v[3]}),
                     **({} if len(v) < 5 else {"host_us_540p": v[4]}))
             for n, v in extra.items()}
    for n, v in extra.items():
        print(f"  {n} at 960x540: {v['ms_540p']:.4f} ms, plain "
              f"{v['plain_ms_540p']:.3f} ms, bound {v['bound_ms_540p']:.4f}")
    return records, extra


# the tracer kernels: (wrapper, plain version, TPU kernel it replaces,
# bytes per ray written)
TRACE_KERNELS = (
    ("trace_closest", "closest_plain", "hikari_tpu/ops/trace_pallas.py:151",
     4 * 5),
    ("trace_full", "full_plain", "hikari_tpu/ops/trace_pallas.py:88",
     4 * (1 + 1 + 3 + 2 + 1 + 1)),
    ("trace_shadow", "shadow_plain", "hikari_tpu/ops/trace_pallas.py:192",
     4 * 2),
)
# kernel 6's interpolation of the winner's normal and uv: 5 lerps of 5 flops
FLOPS_INTERP = 25


def trace_tests(tris, excl, incl, chunk=1 << 16):
    """Ray-triangle tests a tracer kernel runs on these rays: the real
    triangles each ray's instance masks accept (the loop skips the rest),
    counted `chunk` rays at a time."""
    inst = tris[:, 9][None]
    n = 0
    for i in range(0, excl.shape[0], chunk):
        ex = excl[i:i + chunk].float()[:, None]
        inc = incl[i:i + chunk].float()[:, None]
        accepted = (inst >= 0) & (inst != ex) & ((inc < 0) | (inst == inc))
        n += int(accepted.sum())
    return n


def trace_bound(tp, name, a):
    """(bound ms, by) of one tracer kernel call with the wrapper's
    arguments `a`: its tables read once, per ray 36 B in and its outputs
    out, and 60 flops per test the call's masks let through (+ kernel 6's
    interpolation per hit)."""
    out_bytes = next(b for n, _, _, b in TRACE_KERNELS if n == name)
    tris, (ro, _, _, excl, incl) = a[0], a[-5:]
    flops = trace_tests(tris, excl, incl) * FLOPS_PER_TRI_TEST
    table = sum(t.numel() for t in a[:len(a) - 5]) * 4
    if name == "trace_full":
        flops += int((getattr(tp, name)(*a)["prim"] >= 0).sum()) \
            * FLOPS_INTERP
    return bound_ms(table + ro.shape[0] * (4 * (3 + 3 + 1 + 1 + 1)
                                           + out_bytes), flops)


def trace_record(tp, name, plain, replaces, call):
    """The record of a tracer kernel from one captured call: its time by
    events, on the device and on the host (after earlier profiler
    sessions of the process), its plain version's time, and its bound."""
    a = call[0]
    n, n_tris = a[-5].shape[0], a[0].shape[0]
    fn, ref = getattr(tp, name), getattr(tp, plain)
    run = (lambda: fn(*a))
    ms = event_ms(run, REPS)
    us = host_us(run)
    dev_ms = device_ms(run, REPS, TRACE_DEVICE_NAMES[name])
    plain_ms = event_ms(lambda: ref(*a), PLAIN_REPS)
    b_ms, b_by = trace_bound(tp, name, a)
    print(f"  kernel {name} {n} rays x {n_tris} triangles: {ms:.4f} ms by "
          f"events, device {dev_ms} ms, host {us:.1f} us; plain "
          f"{plain_ms:.2f} ms, bound {b_ms:.4f} ms ({b_by})")
    return dict(name=name, route="cuda",
                source="hikari_tpu_torch/csrc/trace.cu", replaces=replaces,
                launches=None, max_abs_err=None, ms=ms, device_ms=dev_ms,
                host_us=us, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None)


# the CUDA kernel behind each tracer wrapper (the profiler's name filter)
TRACE_DEVICE_NAMES = {"trace_closest": "closest_kernel",
                      "trace_full": "full_kernel",
                      "trace_shadow": "shadow_kernel"}
# path KR's tracer calls in a frame, in order, per BruteForceTracer method
# and its kernel wrapper; a frame that validates the emissive channel
# (every 5th) traces its probe and shadow ray again
KR_TRACE_CALLS = (
    ("trace", "trace_closest", ("bounce",)),
    ("probe_info", "trace_full", ("emissive", "validation", "bounce_nee")),
    ("shadow", "trace_shadow", ("emissive", "validation", "bounce_nee")),
)


def trace_ab(ht, build_box):
    """--ab's records of kernels 5, 6 and 7: every call of path KR's frames
    4 and 5 (a panning camera; frame 5 validates), reached through
    BruteForceTracer's trace, probe_info and shadow, whose arguments every
    tree of the repository shares: each call's kernel wrapper is captured
    as that tree's tracer calls it, its outputs held word for word against
    its plain version, and timed by events and on the host (before any
    profiler session). Returns the records and the pass that adds their
    device times."""
    from hikari_tpu_torch.ops import trace as tr
    from hikari_tpu_torch.ops import trace_pallas as tp

    caps = [Capture(tr.BruteForceTracer, m) for m, *_ in KR_TRACE_CALLS]
    keep = (CHECK_FRAMES - 3, CHECK_FRAMES - 2)
    settings = PATHS["KR"][0](ht)
    with caps[0], caps[1], caps[2]:
        drive(ht, build_box(), FULL, settings, CHECK_FRAMES - 1, caps, keep)
    named = []
    for cap, (method, wrapper, calls) in zip(caps, KR_TRACE_CALLS):
        per_frame = [(f, calls if f % settings.emissive_validate_interval
                      == 0 or len(calls) == 1 else
                      tuple(c for c in calls if c != "validation"))
                     for f in keep]
        if len(cap.calls) != sum(len(c) for _, c in per_frame):
            fail(f"KR's frames {keep} called BruteForceTracer.{method} "
                 f"{len(cap.calls)} times")
        plain = getattr(tp, next(p for n, p, *_ in TRACE_KERNELS
                                 if n == wrapper))
        todo = iter(cap.calls)
        for f, names in per_frame:
            for call in names:
                a, k = next(todo)
                inner = Capture(tp, wrapper)
                with inner:
                    inner.on = True
                    cap.fn(*a, **k)
                wa = inner.calls[0][0]
                got = getattr(tp, wrapper)(*wa)
                ref = plain(*wa)
                torch.cuda.synchronize()
                keys = sorted(ref)
                if not words_equal([got[q] for q in keys],
                                   [ref[q] for q in keys]):
                    fail(f"{wrapper} (KR frame {f}, the {call} call) "
                         "disagrees with its plain version")
                b_ms, b_by = trace_bound(tp, wrapper, wa)
                run = (lambda fn=getattr(tp, wrapper), wa=wa: fn(*wa))
                named.append((dict(name=f"{wrapper}_{call}_f{f}",
                                   rays=wa[-5].shape[0],
                                   tris=wa[0].shape[0], words_equal=1.0,
                                   bound_ms=b_ms, bound_by=b_by),
                              run, TRACE_DEVICE_NAMES[wrapper]))
    for rec, run, _ in named:
        rec.update(ms=event_ms(run, REPS), host_us=host_us(run))

    def device_pass():
        for rec, run, kernel in named:
            rec["device_ms"] = device_ms(run, REPS, kernel)
            print_kernel_times(rec["name"], rec)

    return [rec for rec, *_ in named], device_pass


def adversarial_rays(tris, seed=14, origins=48):
    """Rays over the table tris [P,10] (numpy float32) that reach the cases
    a reordered or skipped nearest-hit test could get wrong, as CPU tensors
    (ro, rd, max_t, excl, incl) for the tracer wrappers:
    * aimed from seeded origins at every real triangle's vertices, at
      points on its edges (each shared with a neighbour: ties that the
      lowest index must win) and at its centroid, half of the directions
      normalized;
    * grazing each face: from points in its plane (rounded to float32, so
      det lands around 0 and eps), along its edges and with out-of-plane
      components from 1e-9 to 1e-3 of the direction;
    * from the centre of every face towards every other face's points, as
      bounce rays leave a surface.
    Masks: seeded excludes (-1 and the instances), includes (-2, -1 and
    the instances); max_t mostly F32_MAX, else +inf or a seeded distance.
    at_hit_distance() adds rays whose max_t equals the hit distance."""
    g = np.random.default_rng(seed)
    real = tris[tris[:, 9] >= 0].astype(np.float64)
    v = real[:, :9].reshape(-1, 3, 3)                      # [T, 3, 3]
    lo, hi = v.reshape(-1, 3).min(0), v.reshape(-1, 3).max(0)
    centre = v.mean(1)
    w = np.array([[1, 0, 0], [0, 1, 0], [0, 0, 1], [.5, .5, 0], [0, .5, .5],
                  [.5, 0, .5], [2 / 3, 1 / 3, 0], [0, .9, .1], [.1, 0, .9],
                  [1 / 3, 1 / 3, 1 / 3]])
    targets = np.einsum("kj,tjc->tkc", w, v).reshape(-1, 3)
    o = g.uniform(lo - 0.2, hi + 0.2, (origins, 3))
    ro = [np.repeat(o, len(targets), 0)]
    rd = [np.tile(targets, (origins, 1)) - ro[0]]
    # grazing: in each face's plane, along its edges and nearly so
    e1, e2 = v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]
    nrm = np.cross(e1, e2)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    for start in (centre, v[:, 0] - 0.5 * e1, centre + 0.25 * (e1 - e2)):
        for d in (e1, e2, e2 - e1, -e1):
            for s in (0.0, 1e-9, 1e-8, 1e-7, 1e-6, 1e-4, 1e-3, -1e-7):
                ro.append(start - d)
                rd.append(d + s * np.linalg.norm(d, axis=1,
                                                 keepdims=True) * nrm)
    # from each face's centre (nudged off it) to every other face's points
    for k in range(len(v)):
        src = centre[k] + 1e-4 * nrm[k] * g.choice((-1.0, 1.0))
        ro.append(np.repeat(src[None], len(targets), 0))
        rd.append(targets - src)
    ro, rd = np.concatenate(ro), np.concatenate(rd)
    unit = g.random(len(rd)) < 0.5
    rd[unit] /= np.linalg.norm(rd[unit], axis=1, keepdims=True)
    n = len(ro)
    inst = np.unique(real[:, 9]).astype(np.int32)
    excl = np.where(g.random(n) < 0.5, -1, g.choice(inst, n))
    incl = np.where(g.random(n) < 0.8, g.choice((-2, -1), n),
                    g.choice(inst, n))
    max_t = np.where(g.random(n) < 0.8, np.float32(3.4028235e38),
                     np.where(g.random(n) < 0.5, np.inf,
                              g.uniform(0.0, 4.0, n)))
    return (torch.from_numpy(ro.astype(np.float32)),
            torch.from_numpy(rd.astype(np.float32)),
            torch.from_numpy(max_t.astype(np.float32)),
            torch.from_numpy(excl.astype(np.int32)),
            torch.from_numpy(incl.astype(np.int32)))


def at_hit_distance(rays, t, hit):
    """The rays that hit (bool plane `hit`, t their nearest distance) three
    times over, with max_t = t (that hit fails dist < max_t, so an
    equally near later triangle must fail too) and one float32 ulp either
    side of it."""
    ro, rd, _, excl, incl = (r[hit] for r in rays)
    t = t[hit]
    max_t = torch.cat([t, torch.nextafter(t, torch.full_like(t, np.inf)),
                       torch.nextafter(t, torch.zeros_like(t))])
    return (ro.repeat(3, 1), rd.repeat(3, 1), max_t, excl.repeat(3),
            incl.repeat(3))


# a power of two that takes kernel 5 off near_rcp's fast form: directions
# (and edges) of 2^42, and with both, determinants past 2^126
HUGE = 2.0 ** 42


def closest_sets(tp, tris):
    """Kernel 5's adversarial calls over the table tris: [(what, tris, ro,
    rd, max_t, excl, incl)] on tris' device. adversarial_rays; the rays
    that hit again with max_t at their hit distance (at_hit_distance);
    the rays with every other warp's directions (64 rays) scaled by HUGE
    (those warps take the exact division); the table and the rays scaled
    by HUGE (determinants of 2^126 and more, and overflows)."""
    dev = tris.device
    rays = tuple(r.to(dev) for r in adversarial_rays(tris.cpu().numpy()))
    ref = tp.closest_plain(tris, *rays)
    near = at_hit_distance(rays, ref["t"], ref["prim"] >= 0)
    ro, rd, *rest = rays
    warp = (torch.arange(rd.shape[0], device=dev) // 64) % 2 == 1
    big = tris.clone()
    big[:, :9] *= HUGE
    return [("aimed and grazing", tris, *rays),
            ("max_t at the hit distance", tris, *near),
            ("every other warp's directions x 2^42", tris, ro,
             torch.where(warp[:, None], rd * HUGE, rd), *rest),
            ("table and rays x 2^42", big, ro * HUGE, rd * HUGE, *rest)]


def check_closest_adversarial(tp, tris):
    """Kernel 5 word for word against closest_plain on closest_sets over
    the table tris (on the card)."""
    for what, *a in closest_sets(tp, tris):
        want = tp.closest_plain(*a)
        got = tp.trace_closest(*a)
        torch.cuda.synchronize()
        keys = sorted(want)
        eq = words_equal([got[k] for k in keys], [want[k] for k in keys])
        print(f"kernel trace_closest on {a[1].shape[0]} {what} rays over "
              f"the box ({float((want['prim'] >= 0).float().mean()):.3f} "
              f"hit): {', '.join(keys)} equal to the plain version {eq} "
              "(need True)")
        if not eq:
            fail(f"trace_closest disagrees with its plain version on the "
                 f"{what} rays")


def check_checkerboard(ht, build_box):
    """Kernels 5, 6, 7 and 9 bit for bit and kernel C on the inputs path KR
    gives them at 1080p with the camera panning (an emissive validation
    frame and a frame without one), and kernel B on path K's compressed
    1080x960 domain. Returns (the records of 5, 6, 7, {record name: its
    checkerboard numbers})."""
    from contextlib import ExitStack

    from hikari_tpu_torch import frame as fr
    from hikari_tpu_torch.ops import denoise_fused as dnf
    from hikari_tpu_torch.ops import light_fused as lf
    from hikari_tpu_torch.ops import reproj_gather as rg
    from hikari_tpu_torch.ops import trace_pallas as tp

    box_host = build_box()
    gpu = box_host.compile()
    caps = [Capture(tp, name) for name, *_ in TRACE_KERNELS]
    caps += [Capture(fr, "reproj_gather"), Capture(dnf, "atrous_level")]
    settings = PATHS["KR"][0](ht)
    # frames 4 and 5: frame 5 validates the emissive channel (interval 5)
    keep = (CHECK_FRAMES - 3, CHECK_FRAMES - 2)
    with ExitStack() as stack:
        for c in caps:
            stack.enter_context(c)
        drive(ht, box_host, FULL, settings, CHECK_FRAMES - 1, caps, keep)
    *trace_calls, g_calls, c_calls = (c.calls for c in caps)

    records = []
    errs = check_trace_calls(tp, trace_calls, "KR")
    for (name, plain, replaces, _), calls, err in zip(
            TRACE_KERNELS, trace_calls, errs):
        # the record from the frame without validation: its first call
        rec = trace_record(tp, name, plain, replaces, calls[0])
        rec["max_abs_err"] = err
        records.append(rec)
    check_closest_adversarial(tp, trace_calls[0][0][0][0])
    first = COUNTERS.index("trace_closest")
    want = [kr_launches(settings, n)[first:first + 3] for n in keep]
    got_calls = [len(c) for c in trace_calls]
    if got_calls != [sum(col) for col in zip(*want)]:
        fail(f"KR's two captured frames called the tracer kernels "
             f"{got_calls} times")

    extra = {}
    if any(len(a[0]) != 2 for a, _ in g_calls):
        fail("KR's gather does not read 2 sources")
    check_gather_calls(rg, g_calls, "path KR")
    check_levels(dnf, c_calls[-4:], "path KR's reconstructed variance")

    # --- kernel B on path K's compressed domain
    cap = Capture(lf, "lighting_kernel")
    with cap:
        drive(ht, build_box(), FULL, PATHS["K"][0](ht), 3, [cap], (2,))
    a, k = cap.calls[-1]
    check_b_call(lf, a, k, "path K")
    rec = light_record(lf, gpu, a, k)
    extra["light_fused"] = {f"{key}_ckb": v for key, v in rec.items()
                            if key != "bound_by"}
    ms, plain_ms, _, (b_ms, _) = gather_record(rg, g_calls[-1])
    extra["reproj_gather"] = dict(ms_ckb_reuse=ms, plain_ms_ckb_reuse=plain_ms,
                                  bound_ms_ckb_reuse=b_ms)
    levels = c_calls[-4:]

    def cascade(level):
        return [level(*a, **k) for a, k in levels]

    irr = levels[0][0][0]
    extra["denoise_fused"] = dict(
        ms_ckb_reuse=event_ms(lambda: cascade(dnf.atrous_level), REPS)
        / len(levels),
        plain_ms_ckb_reuse=event_ms(lambda: cascade(dnf.atrous_plain),
                                    PLAIN_REPS) / len(levels),
        bound_ms_ckb_reuse=atrous_bound(irr.shape[1] * irr.shape[2],
                                        levels[0][1]["nch"])[0])
    for n, v in extra.items():
        print(f"  {n}: " + ", ".join(f"{key} {val:.4f}"
                                     for key, val in v.items()))
    return records, extra


def city_camera(ht, size):
    """bench.py's city camera: HDR, from (0, 2.5, 20) at the origin."""
    return ht.Camera.from_look_at(CITY_EYE, CITY_TARGET, width=size[1],
                                  height=size[0], hdr=True)


def city_angle(f):
    """The sphere's angle in the city's frame f (bench.py:184)."""
    return 0.2 * (f + 1) / 60.0


# kernel 13's modes: (wrapper, bytes per ray written)
WALK_MODES = {"hit": ("bvh_closest", 4 * 5),
              "full": ("bvh_full", 4 * (1 + 1 + 3 + 2 + 1 + 1)),
              "shadow": ("bvh_shadow", 4 * 2)}


def walk_plain_of(tc, mode, a, stats=None):
    """Kernel 13's plain version (the world walk over bvh_packed) on a
    captured call's arguments (scene, ro, rd, max_t, excl, incl)."""
    s = a[0]
    return tc.walk_plain(mode, s["bvh_packed"], s["tri_pos_flat"],
                         s["tri_attr"] if mode == "full" else None, *a[1:],
                         stats=stats)


def walk_work(tc, mode, a, out):
    """The work of one kernel 13 call: {walk: (slab tests, triangle tests,
    bound ms, by)} for the world walk (walk_plain over bvh_packed, the
    contract) and for the kernel's own walk of its tables
    (walk_tables_plain): ~30 flops per slab test, 60 per triangle
    test, 25 per full-mode hit's interpolation; the bytes each ray's inputs
    (36 B) and outputs once, and the tables each walk reads once."""
    s, n = a[0], a[1].shape[0]
    hits = int((out["prim"] >= 0).sum()) if mode == "full" else 0
    tables = {"world": ("bvh_packed", "tri_pos_flat", "tri_attr"),
              "tables": ("bvh_nodes", "bvh_wide", "bvh_sub_root",
                         "tri_edges", "tri_attr_pad")}
    work = {}
    for walk, keys in tables.items():
        stats = {}
        if walk == "world":
            walk_plain_of(tc, mode, a, stats)
        else:
            tc.walk_tables_plain(mode, *a, stats=stats)
        if mode != "full":
            keys = keys[:-1]
        nbytes = (sum(s[k].numel() for k in keys) * 4
                  + n * (36 + WALK_MODES[mode][1]))
        flops = (stats["nodes"] * FLOPS_PER_NODE
                 + stats["tests"] * FLOPS_PER_TRI_TEST + hits * FLOPS_INTERP)
        work[walk] = (stats["nodes"], stats["tests"],
                      *bound_ms(nbytes, flops))
    return work


def walk_record(tc, mode, a, label):
    """Kernel 13 on one call: events and device ms, the plain version's ms,
    and the work per ray and the bound of both walks (walk_work); bound_ms
    is the lesser."""
    fn = getattr(tc, WALK_MODES[mode][0])
    n = a[1].shape[0]
    ms = event_ms(lambda: fn(*a), REPS)
    dev_ms = device_ms(lambda: fn(*a), REPS, "bvh_kernel")
    plain_ms = event_ms(lambda: walk_plain_of(tc, mode, a), 1)
    work = walk_work(tc, mode, a, fn(*a))
    rec = dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms)
    for walk, (nodes, tests, b, by) in work.items():
        rec.update({f"slab_tests_per_ray_{walk}": nodes / n,
                    f"tri_tests_per_ray_{walk}": tests / n,
                    f"bound_ms_{walk}": b, f"bound_by_{walk}": by})
    best = min(work.values(), key=lambda w: w[2])
    rec.update(bound_ms=best[2], bound_by=best[3])
    print(f"  kernel 13 {mode} {label} {n} rays: {ms:.4f} ms by events, "
          f"device {dev_ms if dev_ms is None else round(dev_ms, 4)} ms, "
          f"plain {plain_ms:.1f} ms; per ray: world walk "
          f"{rec['slab_tests_per_ray_world']:.2f} slab tests, "
          f"{rec['tri_tests_per_ray_world']:.3f} triangle tests (bound "
          f"{rec['bound_ms_world']:.4f} ms, {rec['bound_by_world']}); "
          f"tables {rec['slab_tests_per_ray_tables']:.2f}, "
          f"{rec['tri_tests_per_ray_tables']:.3f} (bound "
          f"{rec['bound_ms_tables']:.4f} ms, {rec['bound_by_tables']})")
    return rec


def check_walk_calls(tc, mode, calls, label):
    """Kernel 13 against its plain version on captured calls, every output
    word; returns the max abs error."""
    fn = getattr(tc, WALK_MODES[mode][0])
    err = 0.0
    for a, _ in calls:
        got = fn(*a)
        ref = walk_plain_of(tc, mode, a)
        torch.cuda.synchronize()
        keys = sorted(ref)
        eq = words_equal([got[k] for k in keys], [ref[k] for k in keys])
        err = max(err, max_abs_err([got[k] for k in keys],
                                   [ref[k] for k in keys]))
        hits = float((got["inst"] >= 0).float().mean())
        masked = float((a[-1] >= 0).float().mean())
        print(f"kernel 13 {mode} {label} {a[1].shape[0]} rays ({hits:.3f} "
              f"hit, {masked:.3f} include-masked): {', '.join(keys)} equal "
              f"to the plain version {eq} (need True)")
        if not eq:
            fail(f"kernel 13 ({mode}) disagrees with its plain version")
    return err


def check_walk_on_box(ht, tc, tp, build_box):
    """Kernel 13 against kernels 5 (hit, and full with the winner's row)
    and 7 (shadow) on the box, 1,048,576 random rays with masks and finite
    max_t: ids equal but at ties (t within 1e-6, or a hit within 1e-5 of an
    edge two triangles share), floats equal where the ids agree."""
    dev = torch.device(DEVICE)
    scene = build_box().compile().as_pytree(dev)
    g = torch.Generator().manual_seed(13)
    n = 1 << 20
    ro = (torch.rand((n, 3), generator=g) * 1.8 - 0.9).to(dev)
    rd = torch.randn((n, 3), generator=g)
    rd = (rd / rd.norm(dim=1, keepdim=True)).to(dev)
    max_t = torch.where(torch.rand(n, generator=g) < 0.3, 0.7,
                        3.4028234663852886e38).to(dev)
    excl = torch.randint(-1, 3, (n,), generator=g, dtype=torch.int32).to(dev)
    incl = torch.where(torch.rand(n, generator=g) < 0.2, 1, -1).to(
        torch.int32).to(dev)
    rays = (ro, rd, max_t, excl, incl)
    tris, attrs = scene["tri_pos_flat"], scene["tri_attr"]
    hit5 = tp.trace_closest(tris, *rays)
    hit13 = tc.bvh_closest(scene, *rays)

    def edge(h):
        u, v = h["u"], h["v"]
        return torch.minimum(torch.minimum(u, v), 1.0 - u - v) < 1e-5

    for mode, got, ref, ids in (
            ("hit", hit13, hit5, ("prim", "inst")),
            ("full", tc.bvh_full(scene, *rays),
             tp.trace_full(tris, attrs, *rays), ("prim", "inst")),
            ("shadow", tc.bvh_shadow(scene, *rays),
             tp.trace_shadow(tris, *rays), ("inst",))):
        torch.cuda.synchronize()
        differ = torch.zeros(n, dtype=torch.bool, device=dev)
        for k in ids:
            differ |= got[k] != ref[k]
        tie = (torch.isclose(got["t"], ref["t"], rtol=1e-6, atol=0.0)
               | edge(hit5) | edge(hit13))
        same = ~differ
        floats_eq = all(torch.equal(got[k][same], ref[k][same])
                        for k in ref)
        print(f"kernel 13 {mode} vs kernel {5 if mode != 'shadow' else 7} "
              f"on the box, {n} rays: ids differ on {int(differ.sum())} "
              f"(all at ties: {not bool((differ & ~tie).any())}), outputs "
              f"equal where they agree: {floats_eq} (need both)")
        if bool((differ & ~tie).any()) or not floats_eq:
            fail(f"kernel 13 ({mode}) disagrees with the brute-force kernels")


def check_refit(ht, city):
    """The refit on CUDA against the refit on the CPU: every table within
    1e-6 * max(|ref|, 1), the BVH boxes (bvh_packed and kernel 13's
    bvh_nodes and bvh_wide) bit for bit against the CPU pyramid of the CUDA
    triangles,
    and kernel 13's tables bit for bit against those walk_tables derives
    from the CUDA refit's own bvh_packed, tri_pos_flat and tri_attr."""
    from hikari_tpu_torch.models import walk_tables as wt
    from hikari_tpu_torch.models.refit_device import DeviceRefitter

    gpu = city.build_scene(3).compile()
    sc = city.rotate_sphere(city.build_scene(3), 0.5)
    vis = [i for i in sc.instances if i.visible]
    cur = torch.from_numpy(np.stack([np.asarray(i.transform, np.float32)
                                     for i in vis]))
    prev = torch.from_numpy(np.stack([np.asarray(i.prev_transform,
                                                 np.float32)
                                      if i.prev_transform is not None else
                                      np.asarray(i.transform, np.float32)
                                      for i in vis]))
    cpu_r = DeviceRefitter(gpu, "cpu")
    ref = cpu_r.update(cur, prev)
    got = DeviceRefitter(gpu, DEVICE).update(cur.to(DEVICE),
                                             prev.to(DEVICE))
    torch.cuda.synchronize()
    worst, max_err = 1.0, 0.0
    for k in ref:
        frac, err = rel_close(got[k].cpu(), ref[k], 1e-6)
        worst, max_err = min(worst, frac), max(max_err, err)
    packed, nodes, wide = cpu_r.boxes(got["tri_pos"].cpu())
    boxes = (torch.equal(got["bvh_packed"].cpu(), packed)
             and torch.equal(got["bvh_nodes"].cpu(), nodes)
             and torch.equal(got["bvh_wide"].cpu(), wide))
    host = {k: got[k].cpu().numpy() for k in ("bvh_packed", "tri_pos_flat",
                                              "tri_attr")}
    derived = wt.tables(cpu_r.walk_plan, host["bvh_packed"],
                        host["tri_pos_flat"], host["tri_attr"])
    tables = all(np.array_equal(got[k].cpu().numpy().view(np.int32),
                                derived[k].view(np.int32))
                 for k in ("bvh_nodes", "bvh_wide", "tri_edges",
                           "tri_attr_pad"))
    print(f"refit CUDA vs CPU: {len(ref)} tables within 1e-6*max(|ref|,1) "
          f"on {worst:.6f} of values (need 1), max abs err {max_err:.3g}; "
          f"BVH boxes (bvh_packed, bvh_nodes, bvh_wide) equal to the "
          f"pyramid of the "
          f"CUDA triangles {boxes}; kernel 13's tables equal to those "
          f"derived from its bvh_packed {tables} (need both)")
    if worst < 1.0 or not boxes or not tables:
        fail("the CUDA refit disagrees with the CPU refit")


def check_city(ht, build_box):
    """Kernel 13 (each mode), 9, C, 11 and 12 on the calls the city gives
    them at 1920x1080 (a frame validating both direct channels and one
    validating neither), kernel 13 on the box against 5 and 7, and the
    refit. Returns (the records of kernel 13's full and shadow modes, the
    record of its hit mode, {record name: its city numbers})."""
    from contextlib import ExitStack

    from hikari_tpu_torch import frame as fr
    from hikari_tpu_torch.examples import city
    from hikari_tpu_torch.ops import denoise_fused as dnf
    from hikari_tpu_torch.ops import reproj_gather as rg
    from hikari_tpu_torch.ops import trace_cull as tc
    from hikari_tpu_torch.ops import trace_pallas as tp
    from hikari_tpu_torch.ops import warp2 as w2
    from hikari_tpu_torch.ops import warp_band as wb

    sc = city.build_scene(3)
    settings = ht.HikariSettings()
    r = ht.Renderer(sc, city_camera(ht, FULL), settings)
    caps = [Capture(tc, "bvh_full"), Capture(tc, "bvh_shadow"),
            Capture(fr, "reproj_gather"), Capture(dnf, "atrous_level"),
            Capture(wb, "warp_band"), Capture(w2, "warp_multi")]
    with ExitStack() as stack:
        for c in caps:
            stack.enter_context(c)
        for f in range(2):      # frame 0 validates both channels, 1 neither
            r.update_scene(city.rotate_sphere(sc, city_angle(f)), fast=True)
            for c in caps:
                c.on = True
            r.render_frame()
        torch.cuda.synchronize()
    full_calls, shadow_calls, g_calls, c_calls, wb_calls, wm_calls = (
        c.calls for c in caps)
    first = COUNTERS.index("bvh_full")
    want = [city_launches(settings, n)[first:first + 2] for n in (0, 1)]
    got_calls = [len(full_calls), len(shadow_calls)]
    if got_calls != [sum(col) for col in zip(*want)]:
        fail(f"the city's two captured frames called kernel 13 {got_calls} "
             "times")
    err_full = check_walk_calls(tc, "full", full_calls, "city")
    err_shadow = check_walk_calls(tc, "shadow", shadow_calls, "city")

    # frame 1's calls: full = primary, emissive probe, bounce, its probe;
    # shadow = sun, emissive, bounce NEE
    f1_full = full_calls[-4:]
    f1_shadow = shadow_calls[-3:]
    records = []
    for mode, calls, names, err in (
            ("full", f1_full, ("primary", "probe", "bounce", "bounce_probe"),
             err_full),
            ("shadow", f1_shadow, ("sun", "emissive", "bounce_nee"),
             err_shadow)):
        per = [walk_record(tc, mode, a, nm) for (a, _), nm in zip(calls,
                                                                  names)]
        rec = dict(name=f"trace_bvh_{mode}", route="cuda",
                   source="hikari_tpu_torch/csrc/trace_bvh.cu",
                   replaces="hikari_tpu/ops/trace_cull.py:239",
                   launches=None, max_abs_err=err, library_ms=None,
                   **per[0])
        for nm, r in zip(names[1:], per[1:]):
            rec.update({f"{key}_{nm}": v for key, v in r.items()})
        records.append(rec)
    # the hit mode, which no path calls, on the primary call's rays
    a_hit = f1_full[0][0]
    ref = walk_plain_of(tc, "hit", a_hit)
    got = tc.bvh_closest(*a_hit)
    torch.cuda.synchronize()
    if not words_equal([got[k] for k in sorted(ref)],
                       [ref[k] for k in sorted(ref)]):
        fail("kernel 13 (hit) disagrees with its plain version")
    hit_record = dict(name="trace_bvh_hit", route="cuda",
                      source="hikari_tpu_torch/csrc/trace_bvh.cu",
                      replaces="hikari_tpu/ops/trace_cull.py:239",
                      launches=0, max_abs_err=max_abs_err(
                          [got[k] for k in sorted(ref)],
                          [ref[k] for k in sorted(ref)]),
                      library_ms=None,
                      **walk_record(tc, "hit", a_hit, "primary"))
    check_walk_on_box(ht, tc, tp, build_box)

    # kernels 9 (3 sources), C, 11 and 12 on the city's calls
    extra = {}
    if any(len(a[0]) != 3 for a, _ in g_calls):
        fail("the city's gather does not read 3 sources")
    check_gather_calls(rg, g_calls, "city")
    ms, plain_ms, _, (b_ms, _) = gather_record(rg, g_calls[-1])
    extra["reproj_gather"] = dict(ms_city=ms, plain_ms_city=plain_ms,
                                  bound_ms_city=b_ms)
    levels = c_calls[-4:]
    check_levels(dnf, levels, "city")
    irr = levels[0][0][0]
    rec = atrous_times(dnf, levels)
    extra["denoise_fused"] = dict(
        ms_city=rec["ms"], device_ms_city=rec["device_ms"],
        plain_ms_city=rec["plain_ms"],
        bound_ms_city=atrous_bound(irr.shape[1] * irr.shape[2],
                                   levels[0][1]["nch"])[0])
    rec11, rec12 = check_warps(wb, w2, wb_calls, wm_calls)
    keys = ("ms", "device_ms", "host_us", "plain_ms", "bound_ms")
    extra["warp_band"] = {f"{key}_city": rec11[key] for key in keys}
    extra["warp_band"].update({f"{key}_smaa_call_city": rec11[
        f"{key}_smaa_call"] for key in keys})
    extra["warp_multi"] = {f"{key}_city": rec12[key] for key in keys}
    for n, v in extra.items():
        print(f"  {n}: " + ", ".join(
            f"{key} {'n/a' if val is None else f'{val:.4f}'}"
            for key, val in v.items()))
    check_refit(ht, city)
    return records, hit_record, extra


def check_simple_walk(ht):
    """Kernel 13 against its plain version word for word on the calls of
    path T's first frame at 1920x1080 (both direct channels validate):
    the scene with two emissive subtrees, whose probes are included to
    either sphere; and kernel 9 on the frame's gather call."""
    from hikari_tpu_torch import frame as fr
    from hikari_tpu_torch.ops import reproj_gather as rg
    from hikari_tpu_torch.ops import trace_cull as tc

    settings = simple_settings(ht)
    r = ht.Renderer(simple_scene(), simple_camera(ht, FULL), settings)
    emitters = sorted(int(i) for i in torch.nonzero(
        r.scene_dev["bvh_sub_root"] > 0).flatten())
    caps = [Capture(tc, "bvh_full"), Capture(tc, "bvh_shadow"),
            Capture(fr, "reproj_gather")]
    with caps[0], caps[1], caps[2]:
        for c in caps:
            c.on = True
        r.render_frame()
        torch.cuda.synchronize()
    first = COUNTERS.index("bvh_full")
    want = list(simple_launches(settings, 0)[first:first + 2])
    got = [len(c.calls) for c in caps[:2]]
    included = sorted({int(i) for a, _ in caps[0].calls
                       for i in torch.unique(a[-1]) if i >= 0})
    print(f"path T: emissive subtrees of instances {emitters}, probes "
          f"included to {included}; kernel 13 calls {got} (need {want})")
    if got != want or len(emitters) != 2 or included != emitters:
        fail("path T's frame does not probe its two emitters' subtrees")
    check_walk_calls(tc, "full", caps[0].calls, "T")
    check_walk_calls(tc, "shadow", caps[1].calls, "T")
    check_gather_calls(rg, caps[2].calls, "path T")


def walk_ab(ht):
    """--ab's kernel 13 records: the city's frame-1 calls at 1920x1080
    (full: primary, emissive probe, bounce, its probe; shadow: sun,
    emissive, bounce NEE), reached through BvhTracer's methods, whose
    arguments every tree of the repository shares: each call's wrapper is
    captured as that tree's BvhTracer calls it, its outputs held word for
    word against walk_plain over bvh_packed, and timed by events and on
    the host. Returns the records and the pass that adds their device
    times."""
    import inspect

    from hikari_tpu_torch.examples import city
    from hikari_tpu_torch.ops import trace as tr
    from hikari_tpu_torch.ops import trace_cull as tc

    sc = city.build_scene(3)
    r = ht.Renderer(sc, city_camera(ht, FULL), ht.HikariSettings())
    caps = [Capture(tr.BvhTracer, "with_info"),
            Capture(tr.BvhTracer, "shadow")]
    with caps[0], caps[1]:
        for f in range(2):
            r.update_scene(city.rotate_sphere(sc, city_angle(f)), fast=True)
            for c in caps:
                c.on = f == 1
            r.render_frame()
        torch.cuda.synchronize()
    named = []
    for cap, mode, names in (
            (caps[0], "full", ("primary", "probe", "bounce", "bounce_probe")),
            (caps[1], "shadow", ("sun", "emissive", "bounce_nee"))):
        wrapper = WALK_MODES[mode][0]
        for name, (a, k) in zip(names, cap.calls):
            inner = Capture(tc, wrapper)
            with inner:
                inner.on = True
                cap.fn(*a, **k)
            wa, wk = inner.calls[0]
            run = (lambda fn=getattr(tc, wrapper), wa=wa, wk=wk:
                   fn(*wa, **wk))
            arg = inspect.signature(cap.fn).bind(*a, **k)
            arg.apply_defaults()
            v = arg.arguments
            n, dev = v["ro"].shape[0], v["ro"].device
            ref = tc.walk_plain(
                mode, v["scene"]["bvh_packed"], v["scene"]["tri_pos_flat"],
                v["scene"]["tri_attr"] if mode == "full" else None, v["ro"],
                v["rd"], v["max_t"], tr._ids(v["exclude_instance"], n, dev),
                tr._ids(v["include_instance"], n, dev))
            got = run()
            torch.cuda.synchronize()
            keys = sorted(ref)
            if not words_equal([got[q] for q in keys],
                               [ref[q] for q in keys]):
                fail(f"kernel 13 ({mode}, the city's {name} call) disagrees "
                     "with its plain version")
            named.append((dict(name=f"bvh_{mode}_{name}", rays=n,
                               words_equal=1.0), run))
    for rec, run in named:
        rec.update(ms=event_ms(run, REPS), host_us=host_us(run))

    def device_pass():
        for rec, run in named:
            rec["device_ms"] = device_ms(run, REPS, "bvh_kernel")
            print_kernel_times(rec["name"], rec)

    return [rec for rec, _ in named], device_pass


def simple_scene(textured=True):
    """Path T's scene: the simple scene (BASELINE config 3) with the seeded
    procedural Earth on both spheres, or untextured."""
    from hikari_tpu_torch.examples import simple

    return simple.build_scene(simple.procedural_earth(0) if textured
                              else None)


def simple_camera(ht, size):
    """The simple example's camera (simple.py:81)."""
    from hikari_tpu_torch.examples import simple

    return ht.Camera.from_look_at(simple.EYE, simple.TARGET, width=size[1],
                                  height=size[0])


# floating-point operations of one bilinear sample: the fractional uv, the
# footprint, the wrap and the 4-tap blend of 4 channels
FLOPS_TEXEL_SAMPLE = 30


def texture_launches(tx, calls):
    """Kernel 14's launches among captured sample_atlas_slots calls, each
    as (a function that repeats it, its slots' (scene, tex_id, uv) in slot
    order)."""
    return [(lambda a=a: tx.sample_atlas_slots(*a),
             [(a[0], a[1][..., s], a[2]) for s in a[3]])
            for a, _ in calls]


def texture_records(sh, launches, device=True):
    """Records of kernel 14 launches (texture_launches): first, for every
    launch and before any profiler session (the host reads slower after
    one), its time by events and on the host, its bound, and the library
    call's time by events and on the host; then, with `device`, the device
    times (profiler; per launch and per slot) and the plain version's time
    (sample_atlas per slot; texture_device). Bytes: per pixel 8 B of uv, per slot 4 B of
    id and 16 B out, plus 16 B per texel the textured samples tap (4 each
    per slot), at most the texels of the rects they address; 30 flops per
    textured pixel and slot. Library: one grid_sample (bilinear) over the
    whole atlas at every sample of the launch's slots, the rect offsets
    folded into the grid (the wrapped border makes it the same four taps;
    it agrees to f32 round-off only, so it is a time, not a check)."""
    import torch.nn.functional as F

    recs = []
    for run, slots in launches:
        scene, tex_id, uv = slots[0]
        atlas, rects = scene["atlas"], scene["tex_rect"]
        n = tex_id.numel()
        n_tex, ids, grids = 0, [], []
        u = uv[..., 0] - torch.floor(uv[..., 0])
        v = uv[..., 1] - torch.floor(uv[..., 1])
        ah, aw = atlas.shape[:2]
        for _, tid, _ in slots:
            textured = tid >= 0
            n_tex += int(textured.sum())
            ids.append(tid[textured])
            rect = rects[torch.clamp(tid.long(), min=0)].float()
            grids.append(torch.stack(
                [2.0 * (rect[..., 0] + u * rect[..., 2]) / aw - 1.0,
                 2.0 * (rect[..., 1] + v * rect[..., 3]) / ah - 1.0],
                -1).reshape(1, -1, 1, 2))
        ids = torch.unique(torch.cat(ids)).long()
        texels = int((rects[ids, 2].long() * rects[ids, 3].long()).sum())
        nbytes = n * (8 + 20 * len(slots)) + 16 * min(4 * n_tex, texels)
        grid = torch.cat(grids, 1)
        inp = atlas.permute(2, 0, 1)[None].contiguous()

        def library(inp=inp, grid=grid):
            return F.grid_sample(inp, grid, mode="bilinear",
                                 align_corners=False)

        rec = dict(ms=event_ms(run, REPS), host_us=host_us(run),
                   library_ms=event_ms(library, REPS),
                   library_host_us=host_us(library), textured=n_tex)
        rec["bound_ms"], rec["bound_by"] = bound_ms(
            nbytes, n_tex * FLOPS_TEXEL_SAMPLE)
        rec["library"] = library
        recs.append(rec)
    if device:
        texture_device(sh, launches, recs)
    return recs


def texture_device(sh, launches, recs):
    """The device pass of texture_records."""
    for rec, (run, slots) in zip(recs, launches):
        library = rec.pop("library")
        rec["device_ms"] = device_ms(run, REPS, "sample_kernel", True)
        rec["device_ms_per_slot"] = (None if rec["device_ms"] is None
                                     else rec["device_ms"] / len(slots))
        rec["library_device_ms"] = device_ms(library, REPS, "grid_sampler",
                                             True)
        rec["plain_ms"] = event_ms(
            lambda: [sh.sample_atlas(*a) for a in slots], PLAIN_REPS)
        print_kernel_times(f"kernel 14 {tuple(slots[0][1].shape)}, "
                           f"{len(slots)} slots, {rec['textured']} textured "
                           f"samples", rec)
        print(f"    per slot on the device {rec['device_ms_per_slot']} ms; "
              f"plain {rec['plain_ms']:.3f} ms")


def check_texture_call(tx, sh, scene, tid, uv, slots, label):
    """Kernel 14 against its plain version on one launch of `slots` (tid:
    the [..., 4] texture ids, uv: [..., 2] of a [..., 4] plane): every
    slot's output bit for bit equal to sample_atlas's. Returns the max abs
    error."""
    got = tx.sample_atlas_slots(scene, tid, uv, slots)
    ref = [sh.sample_atlas(scene, tid[..., s], uv) for s in slots]
    torch.cuda.synchronize()
    eq = words_equal(got, ref)
    share = float((tid[..., list(slots)] >= 0).float().mean())
    print(f"kernel 14 {label} {tuple(tid.shape[:-1])}, slots {slots} "
          f"({share:.3f} textured): every slot equal to the plain version "
          f"{eq} (need True)")
    if not eq:
        fail(f"kernel 14 disagrees with its plain version ({label})")
    return max_abs_err(got, ref)


def synthetic_texture_scene(ht, dev):
    """A compiled scene holding the procedural Earth and three seeded
    textures (odd sizes, sRGB and linear) in its atlas, with a material
    table whose four sampled slots are all textured somewhere."""
    from hikari_tpu_torch.examples import simple
    from hikari_tpu_torch.models import mesh as shapes
    from hikari_tpu_torch.models.material import Texture

    rng = np.random.default_rng(14)
    earth = simple.procedural_earth(0)
    a = Texture(rng.integers(0, 256, (37, 53, 4), np.uint8))
    b = Texture(rng.integers(0, 256, (128, 96, 4), np.uint8), is_srgb=False)
    c = Texture(rng.random((64, 200, 4), np.float32), is_srgb=False)
    sc = ht.Scene()
    sc.spawn(sc.add_mesh(shapes.quad(1.0, 1.0)), 0)
    for m in (ht.StandardMaterial(base_color=(0.5, 0.6, 0.7, 1.0)),
              ht.StandardMaterial(base_color_texture=earth,
                                  emissive_texture=a,
                                  metallic_roughness_texture=b,
                                  occlusion_texture=c,
                                  emissive=(1.0, 0.5, 0.2, 0.8)),
              ht.StandardMaterial(base_color_texture=c,
                                  occlusion_texture=b)):
        sc.add_material(m)
    return sc.compile().as_pytree(dev)


def check_textures(ht):
    """Kernel 14 against its plain version bit for bit: on the calls path
    T gives it at 1920x1080 (the G-buffer's base colour and emissive
    slots) and 960x540 (the lighting domain's) over two frames, on a
    synthetic 1080p field (ids -1 to 3 of four textures, uv over
    [-2.5, 3.5): negative, on and across the seams) and through
    retrieve_surface's four slots on it. Returns the record of row 14."""
    from contextlib import ExitStack

    from hikari_tpu_torch.ops import shading as sh
    from hikari_tpu_torch.ops import texture_pallas as tx

    dev = torch.device(DEVICE)
    r = ht.Renderer(simple_scene(), simple_camera(ht, FULL),
                    simple_settings(ht))
    if r.gpu_scene.num_textures != 1 or r.gpu_scene.num_triangles != 2510:
        fail("path T's scene is not the 2,510-triangle textured scene")
    cap = Capture(tx, "sample_atlas_slots")
    with ExitStack() as stack:
        stack.enter_context(cap)
        cap.on = True
        for _ in range(2):
            r.render_frame()
        torch.cuda.synchronize()
    if len(cap.calls) != 4:
        fail(f"path T's two frames launched kernel 14 {len(cap.calls)} "
             "times")
    err = 0.0
    for a, _ in cap.calls:
        if tuple(a[3]) != (0, 1):
            fail(f"path T's launch sampled slots {a[3]}")
        err = max(err, check_texture_call(tx, sh, *a, "path T"))
    # the synthetic field: every slot in one launch, each slot alone
    # through the one-slot wrapper, and the four slots through
    # retrieve_surface
    scene = synthetic_texture_scene(ht, dev)
    g = torch.Generator().manual_seed(14)
    h, w = FULL
    tid = torch.randint(-1, 4, (h, w, 4), generator=g, dtype=torch.int32)
    vel = torch.rand((h, w, 4), generator=g) * 6.0 - 2.5
    vel[: h // 8] = torch.round(vel[: h // 8])
    vel[h // 8: h // 4] = torch.nextafter(torch.round(vel[h // 8: h // 4]),
                                          torch.tensor(-10.0))
    tid, vel = tid.to(dev), vel.to(dev)
    uv = vel[..., 2:4]
    err = max(err, check_texture_call(tx, sh, scene, tid, uv, (0, 1, 2, 3),
                                      "synthetic"))
    err = max(err, check_texture_call(tx, sh, scene, tid, uv, (1, 3),
                                      "synthetic"))
    for s in range(4):
        got = tx.sample_atlas_coherent(scene, tid[..., s], uv)
        ref = sh.sample_atlas(scene, tid[..., s], uv)
        torch.cuda.synchronize()
        if not words_equal([got], [ref]):
            fail(f"kernel 14's one-slot launch disagrees (slot {s})")
    print("kernel 14 synthetic, one slot a launch: each of the 4 slots "
          "equal to the plain version True (need True)")
    mat = torch.randint(-1, 3, (h, w), generator=g,
                        dtype=torch.int32).to(dev)
    got = sh.retrieve_surface(scene, mat, uv, False, coherent=True)
    ref = sh.retrieve_surface(scene, mat, uv, False)
    torch.cuda.synchronize()
    eq = words_equal([got[k] for k in sorted(ref)],
                     [ref[k] for k in sorted(ref)])
    print(f"kernel 14 through retrieve_surface, 4 slots, {h}x{w}: every "
          f"field equal to the plain gathers {eq} (need True)")
    if not eq:
        fail("retrieve_surface through kernel 14 disagrees with the plain "
             "gathers")
    # frame 1's launches: the 1080p G-buffer's, then the 960x540 domain's
    full, half = texture_records(sh, texture_launches(tx, cap.calls[-2:]))
    return dict(name="texture", route="cuda",
                source="hikari_tpu_torch/csrc/texture.cu",
                replaces="hikari_tpu/ops/texture_pallas.py:64", launches=None,
                max_abs_err=err, **full,
                **{f"{key}_540p": v for key, v in half.items()
                   if key != "bound_by"})


def simple_settings(ht):
    """The simple example's settings: HikariSettings() with emissive
    spatial reuse (simple.py:79-80)."""
    return dataclasses.replace(ht.HikariSettings(),
                               emissive_spatial_reuse=True)


def compare_simple_render(ht, size, frames, settings=None, name="T"):
    """Path T (or T's scene at other settings) at `size` on CUDA against
    the plain versions on the CPU: SSIM >= 0.98 and mean abs diff <
    1e-3."""
    images = []
    for device in (None, "cpu"):
        r = ht.Renderer(simple_scene(), simple_camera(ht, size),
                        settings or simple_settings(ht), device=device)
        images.append(r.render(frames))
    img_gpu, img_cpu = images
    s = ssim(np.clip(img_gpu[..., :3], 0, 1), np.clip(img_cpu[..., :3], 0, 1))
    mad = float(np.abs(img_gpu - img_cpu).mean())
    print(f"small render {name} {size[0]}x{size[1]}, {frames} frames, CUDA "
          f"vs CPU plain: SSIM {s:.5f} (need >= 0.98), mean abs diff "
          f"{mad:.3g} (need < 1e-3)")
    if not np.isfinite(img_gpu).all() or s < 0.98 or mad >= 1e-3:
        fail(f"the CUDA render of path {name} disagrees with the CPU plain "
             "render")


def compare_city_render(ht, size, frames, settings=None, name="city",
                        build=None, **renderer_kw):
    """The city (or the scene `build()` makes, the city's sphere in it; at
    HikariSettings() unless `settings` says otherwise; Renderer keywords
    `renderer_kw`) at `size` on CUDA against the plain versions on the
    CPU, the sphere turning between frames: SSIM >= 0.98 and mean abs
    diff < 1e-3."""
    from hikari_tpu_torch.examples import city

    images = []
    for device in (None, "cpu"):
        sc = build() if build else city.build_scene(3)
        r = ht.Renderer(sc, city_camera(ht, size),
                        settings or ht.HikariSettings(), device=device,
                        **renderer_kw)
        for f in range(frames):
            if f:
                r.update_scene(city.rotate_sphere(sc, city_angle(f)),
                               fast=True)
            img = r.render_frame()
        images.append(img.cpu().numpy())
    img_gpu, img_cpu = images
    s = ssim(np.clip(img_gpu[..., :3], 0, 1), np.clip(img_cpu[..., :3], 0, 1))
    mad = float(np.abs(img_gpu - img_cpu).mean())
    print(f"small render {name} {size[0]}x{size[1]}, {frames} frames, CUDA "
          f"vs CPU plain: SSIM {s:.5f} (need >= 0.98), mean abs diff "
          f"{mad:.3g} (need < 1e-3)")
    if not np.isfinite(img_gpu).all() or s < 0.98 or mad >= 1e-3:
        fail(f"the CUDA render of the {name} disagrees with the CPU plain "
             "render")


def sun_box(build_box):
    """The box with a sun (the directional-branch checks)."""
    sc = build_box()
    sc.directional_light = type(sc.directional_light)(
        illuminance=10000.0, direction=(0.25, -0.5, -1.0))
    return sc


def compare_renders(ht, scene_of, size, name, settings, frames,
                    min_ssim=0.98, cam=None, **renderer_kw):
    """A CUDA render against the plain versions' render on the CPU (the
    box's camera unless `cam`; Renderer keywords `renderer_kw`): SSIM >=
    min_ssim and mean abs diff < 1e-3."""
    box = load_box_module()
    h, w = size
    if cam is None:
        cam = ht.Camera.from_look_at(box.EYE, box.TARGET, width=w, height=h)
    img_gpu = ht.Renderer(scene_of(), cam, settings,
                          **renderer_kw).render(frames)
    img_cpu = ht.Renderer(scene_of(), cam, settings, device="cpu",
                          **renderer_kw).render(frames)
    s = ssim(np.clip(img_gpu[..., :3], 0, 1), np.clip(img_cpu[..., :3], 0, 1))
    mad = float(np.abs(img_gpu - img_cpu).mean())
    print(f"small render {name} {h}x{w}, {frames} frames, CUDA vs CPU "
          f"plain: SSIM {s:.5f} (need >= {min_ssim}), mean abs diff "
          f"{mad:.3g} (need < 1e-3)")
    if not np.isfinite(img_gpu).all() or s < min_ssim or mad >= 1e-3:
        fail(f"the CUDA render of {name} disagrees with the CPU plain "
             "render")


def check_small_render(ht, build_box):
    """Small CUDA renders of the seven paths against the plain versions on
    the CPU, KR on the box with a sun at 270x480 (the modular path's solar
    channel), and the city and paths CL (and CL with FXAA), T, TN and F at
    48x256."""
    for name, (settings_of, _) in PATHS.items():
        compare_renders(ht, build_box, SMALL, name, settings_of(ht),
                        3 if name == "no-reuse" else 4)
    compare_renders(ht, lambda: sun_box(build_box), SUN, "KR with a sun",
                    PATHS["KR"][0](ht), 4)
    compare_city_render(ht, CITY_SMALL, 4)
    compare_lamps_render(ht)
    compare_simple_render(ht, CITY_SMALL, 4)
    compare_simple_render(ht, CITY_SMALL, 3, flagship_settings(ht), "TN")
    compare_scene_render(ht, CITY_SMALL, 4)


def main_path(ht, build_box, name, timed, profile):
    """One path through Renderer at 1080p. Returns (frame times, launch
    counts per wrapper of COUNTERS over the timed frames)."""
    box = load_box_module()
    settings_of, per_frame = PATHS[name]
    h, w = FULL
    cam = ht.Camera.from_look_at(box.EYE, box.TARGET, width=w, height=h)
    r = ht.Renderer(build_box(), cam, settings_of(ht))
    for _ in range(WARMUP_FRAMES):
        r.render_frame()
    torch.cuda.synchronize()
    times, counts = time_frames(r, name, per_frame, timed, WARMUP_FRAMES)
    if profile:
        profile_frames(r.render_frame)
    return times, counts


def check_run(name, counts, expected, img, timed):
    """Exact launch counts over the timed frames; a finite, not black
    1080p image."""
    print(f"path {name}: launches over {timed} frames "
          f"({', '.join(COUNTERS)}): {counts} (need {expected})")
    if counts != expected:
        fail(f"path {name} did not launch each kernel as expected")
    out = img.cpu()
    if tuple(out.shape) != FULL + (4,) or not torch.isfinite(out).all():
        fail(f"bad image on path {name}: shape {tuple(out.shape)}")
    mean = float(out[..., :3].mean())
    if mean <= 0.01:
        fail(f"image of path {name} is black (mean {mean})")
    print(f"  image {tuple(out.shape)} finite, mean rgb {mean:.4f}")


def profile_frames(step):
    """Device time by kernel over two steps (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile as prof_

    with prof_(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            step()
        torch.cuda.synchronize()
    print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=25))


def city_path(ht, timed, profile):
    """The city through Renderer at 1920x1080, HikariSettings() (SMAA 2.0),
    the HDR camera: each frame update_scene(rotate_sphere(...),
    fast=True) + render_frame(), as bench.py:159-196. Returns (frame times
    with the refit, refit times up to a synchronize, launch counts per
    wrapper of COUNTERS over the timed frames)."""
    from hikari_tpu_torch.examples import city

    sc = city.build_scene(3)
    settings = ht.HikariSettings()
    r = ht.Renderer(sc, city_camera(ht, FULL), settings)
    if (r.gpu_scene.num_instances, r.gpu_scene.num_triangles) != (122, 2618):
        fail("the city is not the 122-instance, 2,618-triangle scene")
    r.update_scene(city.rotate_sphere(sc, 0.001), fast=True)
    r.render_frame()
    f = 0

    def step():
        nonlocal f
        r.update_scene(city.rotate_sphere(sc, city_angle(f)), fast=True)
        f += 1
        return r.render_frame()

    for _ in range(WARMUP_FRAMES):
        step()
    torch.cuda.synchronize()
    wrappers = counter_wrappers()
    for fn in wrappers:
        fn.launches = 0
    times, refit = [], []
    img = None
    for _ in range(timed):
        t = time.perf_counter()
        r.update_scene(city.rotate_sphere(sc, city_angle(f)), fast=True)
        torch.cuda.synchronize()
        refit.append((time.perf_counter() - t) * 1e3)
        img = r.render_frame()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
        f += 1
    counts = [fn.launches for fn in wrappers]
    first = 1 + WARMUP_FRAMES       # the frame number of the first timed
    expected = [sum(col) for col in zip(*(
        city_launches(settings, n) for n in range(first, first + timed)))]
    check_run("city", counts, expected, img, timed)
    if profile:
        profile_frames(step)
    return times, refit, counts


SPHERES = (6, 7)    # path T's sphere instances (spawned last)


def simple_path(ht, timed, profile, noreuse=False):
    """Path T through Renderer at 1920x1080: the textured simple scene at
    the example's settings and camera, static; or with `noreuse` path TN,
    the same scene and camera at the flagship settings. Checks the launch
    counts and, on path T, that the spheres' pixels differ from the same
    frame of the untextured scene (the texture is sampled). Returns (frame
    times, launch counts per wrapper of COUNTERS over the timed frames)."""
    settings = flagship_settings(ht) if noreuse else simple_settings(ht)
    launches_of = simple_noreuse_launches if noreuse else simple_launches
    r = ht.Renderer(simple_scene(), simple_camera(ht, FULL), settings)
    for _ in range(WARMUP_FRAMES):
        r.render_frame()
    torch.cuda.synchronize()
    wrappers = counter_wrappers()
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
    expected = [sum(col) for col in zip(*(
        launches_of(settings, n)
        for n in range(WARMUP_FRAMES, WARMUP_FRAMES + timed)))]
    check_run("TN" if noreuse else "T", counts, expected, img, timed)
    if noreuse:
        if profile:
            profile_frames(r.render_frame)
        return times, counts
    inst = torch.floor(r.carry["prev_gbuffer"]["instance_material"][..., 0])
    spheres = (inst == SPHERES[0]) | (inst == SPHERES[1])
    plain = ht.Renderer(simple_scene(False), simple_camera(ht, FULL),
                        settings)
    for _ in range(WARMUP_FRAMES + timed):
        untextured = plain.render_frame()
    diff = (img[..., :3] - untextured[..., :3]).abs().amax(-1)
    n_sph = int(spheres.sum())
    on = float(diff[spheres].mean()) if n_sph else 0.0
    changed = float((diff[spheres] > 0.02).float().mean()) if n_sph else 0.0
    print(f"  path T vs the untextured scene, same frame: {n_sph} sphere "
          f"pixels, mean max-channel diff {on:.4f} there, {changed:.3f} of "
          f"them differ by > 0.02 (need > 0.25); elsewhere "
          f"{float(diff[~spheres].mean()):.4g}")
    if n_sph < 1000 or changed <= 0.25:
        fail("path T's spheres do not show their texture")
    if profile:
        profile_frames(r.render_frame)
    return times, counts


def alternate_post_paths(ht, build_box, timed):
    """Paths P and D timed alternately, frame by frame, in one process
    (one P frame, then one D frame): the medians of each."""
    box = load_box_module()
    h, w = FULL
    cam = ht.Camera.from_look_at(box.EYE, box.TARGET, width=w, height=h)
    rs = {name: ht.Renderer(build_box(), cam, PATHS[name][0](ht))
          for name in ("P", "D")}
    for r in rs.values():
        for _ in range(WARMUP_FRAMES):
            r.render_frame()
    torch.cuda.synchronize()
    times = {name: [] for name in rs}
    for _ in range(timed):
        for name, r in rs.items():
            t = time.perf_counter()
            r.render_frame()
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t) * 1e3)
    med = {name: float(np.median(v)) for name, v in times.items()}
    print(f"P and D alternating, {timed} frames each: P median "
          f"{med['P']:.2f} ms, D median {med['D']:.2f} ms")
    return med, times


def scene_camera(ht, size):
    """examples/scene.py's camera at `size` (height, width)."""
    from hikari_tpu_torch.examples import scene

    return ht.Camera.from_look_at(scene.EYE, scene.TARGET, width=size[1],
                                  height=size[0])


def scene_renderer(ht, size, device=None):
    """Path F: the scene of examples/scene.py (BASELINE config 4, without
    its absent FlightHelmet model) at its settings and camera."""
    from hikari_tpu_torch.examples import scene

    r = ht.Renderer(scene.build_scene(), scene_camera(ht, size),
                    scene.settings(), device=device)
    if r.gpu_scene.num_triangles != 1226:
        fail("path F's scene is not the 1,226-triangle scene")
    return r


def compare_scene_render(ht, size, frames):
    """Path F at `size` on CUDA against the plain versions on the CPU:
    SSIM >= 0.98 and mean abs diff < 1e-3."""
    img_gpu, img_cpu = (scene_renderer(ht, size, device).render(frames)
                        for device in (None, "cpu"))
    s = ssim(np.clip(img_gpu[..., :3], 0, 1), np.clip(img_cpu[..., :3], 0, 1))
    mad = float(np.abs(img_gpu - img_cpu).mean())
    print(f"small render F {size[0]}x{size[1]}, {frames} frames, CUDA vs "
          f"CPU plain: SSIM {s:.5f} (need >= 0.98), mean abs diff {mad:.3g} "
          f"(need < 1e-3)")
    if not np.isfinite(img_gpu).all() or s < 0.98 or mad >= 1e-3:
        fail("the CUDA render of path F disagrees with the CPU plain render")


def check_scene(ht):
    """Kernels 13 (full, shadow), 9, C and 11 on the calls path F gives
    them at 1920x1080 (frame 0 validates both direct channels, frame 1
    neither): kernel 13 on the 1080p primary rays and on 4 bounces of rays
    at 960x540, 9 with 3 sources at 960x540, C at 960x540, 11 TAA's fetch
    at the 960x540 render size (7.5 groups of 128 columns). Returns {record
    name: its path F numbers}."""
    from contextlib import ExitStack

    from hikari_tpu_torch import frame as fr
    from hikari_tpu_torch.ops import denoise_fused as dnf
    from hikari_tpu_torch.ops import reproj_gather as rg
    from hikari_tpu_torch.ops import trace_cull as tc
    from hikari_tpu_torch.ops import warp_band as wb

    r = scene_renderer(ht, FULL)
    caps = [Capture(tc, "bvh_full"), Capture(tc, "bvh_shadow"),
            Capture(fr, "reproj_gather"), Capture(dnf, "atrous_level"),
            Capture(wb, "warp_band")]
    with ExitStack() as stack:
        for c in caps:
            stack.enter_context(c)
            c.on = True
        for _ in range(2):
            r.render_frame()
        torch.cuda.synchronize()
    full_calls, shadow_calls, g_calls, c_calls, wb_calls = (
        c.calls for c in caps)
    first = COUNTERS.index("bvh_full")
    want = [sum(col) for col in zip(*(
        scene_launches(r.settings, n)[first:first + 2] for n in (0, 1)))]
    if [len(full_calls), len(shadow_calls)] != want:
        fail(f"path F's two frames called kernel 13 {len(full_calls)} / "
             f"{len(shadow_calls)} times (need {want})")
    check_walk_calls(tc, "full", full_calls, "path F")
    check_walk_calls(tc, "shadow", shadow_calls, "path F")
    if any(len(a[0]) != 3 for a, _ in g_calls):
        fail("path F's gather does not read 3 sources")
    check_gather_calls(rg, g_calls, "path F")
    check_levels(dnf, c_calls[-4:], "path F 960x540")
    check_band_calls(wb, wb_calls)
    if any(tuple(a[2].shape) != (FULL[0] // 2, FULL[1] // 2)
           for a, _ in wb_calls):
        fail("path F's TAA does not run at the render size")
    taa = wb_calls[-1][0]
    extra = {"warp_band": dict(
        ms_scene=event_ms(lambda: wb.warp_band(*taa), REPS),
        plain_ms_scene=event_ms(lambda: wb.band_plain(*taa), PLAIN_REPS),
        bound_ms_scene=warp_band_bound(wb_calls[-1])[0])}
    # frame 1's last bounce (no validation): the full-mode bounce rays
    a = full_calls[-2][0]
    extra["trace_bvh_full"] = {
        f"{k}_scene_bounce4": v for k, v in walk_record(
            tc, "full", a, "path F bounce 4").items()
        if k in ("ms", "device_ms", "plain_ms", "bound_ms")}
    return extra


def box_upscale_cases(ht):
    """The box's upscale settings beyond SMAA 2.0: {name: (settings, size,
    small render size)} (check_box_upscale; replayed in the compiled
    check)."""
    return {
        "fsr1_1.5": (flagship_settings(ht, upscale=ht.Upscale.fsr1(1.5)),
                     FULL, SMALL),
        "smaa_1.0": (dataclasses.replace(
            ht.HikariSettings(), upscale=ht.Upscale.smaa_tu4x(1.0)), FULL,
            SMALL),
        "smaa_1.5": (dataclasses.replace(
            ht.HikariSettings(), upscale=ht.Upscale.smaa_tu4x(1.5)), FULL,
            SMALL),
        "odd_2.0": (ht.HikariSettings(), ODD, (47, 63)),
        "ckb_smaa_2.0": (flagship_settings(
            ht, taa=ht.Taa.JASMINE, upscale=ht.Upscale.smaa_tu4x(2.0),
            checkerboard_lighting=True), FULL, SMALL),
        # the small render's width 66 keeps its render width (44) even
        "ckb_fsr1_1.5": (flagship_settings(
            ht, taa=ht.Taa.JASMINE, upscale=ht.Upscale.fsr1(1.5),
            checkerboard_lighting=True), FULL, (48, 66)),
    }


def check_box_upscale(ht, build_box):
    """The box at 1080p on the upscale settings beyond SMAA 2.0, three
    frames each with the camera panning, every kernel call of the last two
    frames against its plain version, and a small CUDA render of each
    against the CPU: the flagship with FSR 1.0 at ratio 1.5 (kernel A's
    full-only call, B and C at 1280x720); HikariSettings() with SMAA at
    ratios 1 and 1.5 (11 and 12 at their new shapes); HikariSettings() at
    1081x1919 (ratio 2 at an odd size: A's full-only call at that size, no
    kernel 8); checkerboard lighting with SMAA at ratio 2 (B over the
    540x480 compressed domain, 8 and A) and with FSR 1.0 at ratio 1.5 (B
    over the 720x640 compressed domain of A's full-only call, no 8)."""
    from contextlib import ExitStack

    from hikari_tpu_torch import frame as fr
    from hikari_tpu_torch.ops import denoise_fused as dnf
    from hikari_tpu_torch.ops import light_fused as lf
    from hikari_tpu_torch.ops import prepass_fused as pf
    from hikari_tpu_torch.ops import reproj_gather as rg
    from hikari_tpu_torch.ops import spatial_fused as sf
    from hikari_tpu_torch.ops import warp2 as w2
    from hikari_tpu_torch.ops import warp_band as wb

    cases = box_upscale_cases(ht)
    for name, (settings, size, small) in cases.items():
        caps = [Capture(pf, "prepass_kernel"),
                Capture(pf, "prepass_quads_kernel"),
                Capture(fr, "reproj_gather"), Capture(lf, "lighting_kernel"),
                Capture(sf, "spatial_kernel"), Capture(dnf, "atrous_level"),
                Capture(wb, "warp_band"), Capture(w2, "warp_multi")]
        with ExitStack() as stack:
            for c in caps:
                stack.enter_context(c)
            drive(ht, build_box(), size, settings, 3, caps, (1, 2))
        a_calls, q_calls, g_calls, l_calls, s_calls, c_calls, wb_calls, \
            wm_calls = (c.calls for c in caps)
        render = fr.scaled_size(size, settings.upscale_ratio)
        exact_half = tuple(size) == (2 * render[0], 2 * render[1])
        print(f"box {name} at {size[0]}x{size[1]} (render {render[0]}x"
              f"{render[1]}): {len(a_calls)} kernel A, {len(q_calls)} "
              f"kernel 8, {len(l_calls)} B/4, {len(g_calls)} 9, "
              f"{len(s_calls)} 10, {len(c_calls)} C, {len(wb_calls)} 11, "
              f"{len(wm_calls)} 12 calls in 2 frames")
        if len(a_calls) != 2 or any(a[5] != tuple(size) for a, _ in a_calls):
            fail(f"box {name}: kernel A did not run once a frame at the "
                 "output size")
        smaa = settings.upscale.mode == ht.UpscaleMode.SMAA_TU4X
        if len(q_calls) != (2 if smaa and exact_half else 0):
            fail(f"box {name}: kernel 8 ran {len(q_calls)} times")
        if settings.checkerboard_lighting and not any(
                tuple(a[6].shape[:2]) == (render[0], render[1] // 2)
                for a, _ in l_calls):
            fail(f"box {name}: kernel B did not light the compressed "
                 "domain")
        check_prepass_call(pf, a_calls[-1][0], f"box {name}")
        if q_calls:
            quads_checks(pf, q_calls, a_calls)
        for a, k in l_calls:
            if k.get("temporal"):
                check_lighting_calls(lf, [(a, k)], f"box {name}")
            else:
                check_b_call(lf, a, k, f"box {name}")
        if g_calls:
            check_gather_calls(rg, g_calls, f"box {name}")
        if s_calls:
            check_spatial_calls(sf, s_calls, f"box {name}")
        check_levels(dnf, c_calls[-4:], f"box {name}")
        check_band_calls(wb, wb_calls)
        check_multi_calls(w2, wm_calls)
        compare_renders(ht, build_box, small, f"box {name}", settings, 4)


def check_trace_calls(tp, calls_by_kernel, label):
    """Kernels 5, 6 and 7 against their plain versions on captured calls
    (one list per row of TRACE_KERNELS), every output word. Returns the
    max abs error of each."""
    errs = []
    for (name, plain, _, _), calls in zip(TRACE_KERNELS, calls_by_kernel):
        err = 0.0
        for a, _ in calls:
            got = getattr(tp, name)(*a)
            ref = getattr(tp, plain)(*a)
            torch.cuda.synchronize()
            keys = sorted(ref)
            eq = words_equal([got[k] for k in keys], [ref[k] for k in keys])
            err = max(err, max_abs_err([got[k] for k in keys],
                                       [ref[k] for k in keys]))
            hits = float((got["inst"] >= 0).float().mean())
            print(f"kernel {name} {label} {a[-5].shape[0]} rays x "
                  f"{a[0].shape[0]} triangles ({hits:.3f} hit): "
                  f"{', '.join(keys)} equal to the plain version {eq} "
                  f"(need True)")
            if not eq:
                fail(f"{name} disagrees with its plain version ({label})")
        errs.append(err)
    return errs


def check_simple_noreuse(ht):
    """Every kernel call of path TN (path T's textured scene at the
    flagship settings: the modular path without reuse, hikari_tpu's
    no-reuse specializations) over two 1920x1080 frames against its plain
    version: kernel 13 full (the primary rays, the emissive probe, the
    bounce and its probe) and shadow (sun, emissive, bounce NEE) bit for
    bit, kernel 14 on its one 1080p launch a frame bit for bit, C on the
    second frame's levels. Returns {record name: its path TN numbers}."""
    from contextlib import ExitStack

    from hikari_tpu_torch.ops import denoise_fused as dnf
    from hikari_tpu_torch.ops import shading as sh
    from hikari_tpu_torch.ops import texture_pallas as tx
    from hikari_tpu_torch.ops import trace_cull as tc

    settings = flagship_settings(ht)
    r = ht.Renderer(simple_scene(), simple_camera(ht, FULL), settings)
    caps = [Capture(tc, "bvh_full"), Capture(tc, "bvh_shadow"),
            Capture(tx, "sample_atlas_slots"), Capture(dnf, "atrous_level")]
    with ExitStack() as stack:
        for c in caps:
            stack.enter_context(c)
            c.on = True
        for _ in range(2):
            r.render_frame()
        torch.cuda.synchronize()
    full_calls, shadow_calls, t_calls, c_calls = (c.calls for c in caps)
    first = COUNTERS.index("bvh_full")
    want = [sum(col) for col in zip(*(
        simple_noreuse_launches(settings, n)[first:] for n in (0, 1)))]
    got = [len(full_calls), len(shadow_calls), len(t_calls)]
    print(f"path TN's two frames: {got[0]} kernel 13 full, {got[1]} shadow, "
          f"{got[2]} kernel 14, {len(c_calls)} C calls (need {want}, 8)")
    if got != want or len(c_calls) != 8:
        fail("path TN's two frames did not call its kernels as expected")
    check_walk_calls(tc, "full", full_calls, "path TN")
    check_walk_calls(tc, "shadow", shadow_calls, "path TN")
    for a, _ in t_calls:
        if tuple(a[1].shape[:2]) != FULL:
            fail("path TN's kernel 14 does not sample the 1080p G-buffer")
        check_texture_call(tx, sh, *a, "path TN")
    check_levels(dnf, c_calls[-4:], "path TN")
    # frame 1's bounce (full) and its NEE shadow rays at 1080p
    extra = {}
    for key, mode, a in (("trace_bvh_full", "full", full_calls[-2][0]),
                         ("trace_bvh_shadow", "shadow",
                          shadow_calls[-1][0])):
        extra[key] = {f"{k}_tn_bounce": v for k, v in walk_record(
            tc, mode, a, "path TN bounce").items()
            if k in ("ms", "device_ms", "plain_ms", "bound_ms")}
    return extra


def check_city_spatial_noreuse(ht):
    """The city at HikariSettings() without temporal reuse (indirect
    spatial reuse alone, the modular spatial pass at 960x540), 1920x1080,
    three frames, static camera: every kernel call of the last two
    against its plain version (kernel 13 full and shadow bit for bit, C,
    11 and 12; no gather, no kernel 10), and a small CUDA render against
    the CPU."""
    from contextlib import ExitStack

    from hikari_tpu_torch import frame as fr
    from hikari_tpu_torch.examples import city
    from hikari_tpu_torch.ops import denoise_fused as dnf
    from hikari_tpu_torch.ops import spatial_fused as sf
    from hikari_tpu_torch.ops import trace_cull as tc
    from hikari_tpu_torch.ops import warp2 as w2
    from hikari_tpu_torch.ops import warp_band as wb

    settings = dataclasses.replace(ht.HikariSettings(), temporal_reuse=False)
    r = ht.Renderer(city.build_scene(3), city_camera(ht, FULL), settings)
    caps = [Capture(tc, "bvh_full"), Capture(tc, "bvh_shadow"),
            Capture(fr, "reproj_gather"), Capture(sf, "spatial_kernel"),
            Capture(dnf, "atrous_level"), Capture(wb, "warp_band"),
            Capture(w2, "warp_multi")]
    with ExitStack() as stack:
        for c in caps:
            stack.enter_context(c)
        for i in range(3):
            for c in caps:
                c.on = i > 0
            r.render_frame()
        torch.cuda.synchronize()
    full_calls, shadow_calls, g_calls, s_calls, c_calls, wb_calls, \
        wm_calls = (c.calls for c in caps)
    counts = [len(c.calls) for c in caps]
    print(f"city without temporal reuse, 2 frames: kernel 13 full, shadow, "
          f"9, 10, C, 11, 12 calls {counts} (need [8, 6, 0, 0, 8, 4, 2])")
    if counts != [8, 6, 0, 0, 8, 4, 2]:
        fail("the city without temporal reuse did not call its kernels as "
             "expected")
    if "spatial_indirect" not in r.carry or "indirect_temporal" in r.carry:
        fail("the city without temporal reuse does not carry the spatial "
             "reservoirs alone")
    check_walk_calls(tc, "full", full_calls, "city no temporal reuse")
    check_walk_calls(tc, "shadow", shadow_calls, "city no temporal reuse")
    check_levels(dnf, c_calls[-4:], "city no temporal reuse 960x540")
    check_band_calls(wb, wb_calls)
    check_multi_calls(w2, wm_calls)
    compare_city_render(ht, CITY_SMALL, 3, settings,
                        "city without temporal reuse")


def check_box_scramble(ht, build_box):
    """The box at HikariSettings() with the spatial tap scramble, 1080p
    (lighting at 960x540), three frames with the camera panning: the
    modular path with temporal and indirect spatial reuse (no kernel 4 or
    10), every kernel call of the last two frames against its plain
    version (A, 8, 9, 5, 6, 7, C, 11, 12), and a small CUDA render
    against the CPU."""
    from contextlib import ExitStack

    from hikari_tpu_torch import frame as fr
    from hikari_tpu_torch.ops import denoise_fused as dnf
    from hikari_tpu_torch.ops import light_fused as lf
    from hikari_tpu_torch.ops import prepass_fused as pf
    from hikari_tpu_torch.ops import reproj_gather as rg
    from hikari_tpu_torch.ops import spatial_fused as sf
    from hikari_tpu_torch.ops import trace_pallas as tp
    from hikari_tpu_torch.ops import warp2 as w2
    from hikari_tpu_torch.ops import warp_band as wb

    settings = dataclasses.replace(ht.HikariSettings(),
                                   spatial_tap_scramble=True)
    caps = [Capture(tp, name) for name, *_ in TRACE_KERNELS]
    caps += [Capture(pf, "prepass_kernel"),
             Capture(pf, "prepass_quads_kernel"),
             Capture(fr, "reproj_gather"), Capture(lf, "lighting_kernel"),
             Capture(sf, "spatial_kernel"), Capture(dnf, "atrous_level"),
             Capture(wb, "warp_band"), Capture(w2, "warp_multi")]
    with ExitStack() as stack:
        for c in caps:
            stack.enter_context(c)
        r = drive(ht, build_box(), FULL, settings, 3, caps, (1, 2))
    *trace_calls, a_calls, q_calls, g_calls, l_calls, s_calls, c_calls, \
        wb_calls, wm_calls = (c.calls for c in caps)
    counts = [len(c.calls) for c in caps]
    # per frame: kernel 5 the bounce, 6 and 7 the emissive probe and
    # shadow ray and the bounce's (frame 0 alone validates in 0-2)
    print(f"box with the tap scramble, 2 frames: kernels 5, 6, 7, A, 8, 9, "
          f"B/4, 10, C, 11, 12 calls {counts} (need [2, 4, 4, 2, 2, 2, 0, "
          f"0, 8, 4, 2])")
    if counts != [2, 4, 4, 2, 2, 2, 0, 0, 8, 4, 2]:
        fail("the box with the tap scramble did not call its kernels as "
             "expected")
    if "spatial_indirect" not in r.carry:
        fail("the box with the tap scramble carries no spatial reservoirs")
    check_trace_calls(tp, trace_calls, "box scramble")
    check_prepass_call(pf, a_calls[-1][0], "box scramble")
    quads_checks(pf, q_calls, a_calls)
    check_gather_calls(rg, g_calls, "box scramble")
    check_levels(dnf, c_calls[-4:], "box scramble 960x540")
    check_band_calls(wb, wb_calls)
    check_multi_calls(w2, wm_calls)
    compare_renders(ht, build_box, SMALL, "box with the tap scramble",
                    settings, 4)


def load_lamps_module():
    """tests/city_lamps.py by path (as load_box_module)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "city_lamps", os.path.join(HERE, "tests", "city_lamps.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def lamps_scene():
    """Path CL's scene: the city after its three waves with 16 street
    lamps (154 instances, 3,002 triangles, 17 emissives)."""
    return load_lamps_module().build_city_lamps("hikari_tpu_torch")


def lamps_renderer(ht, size, device=None, fxaa=False):
    """(Renderer, host scene) of path CL at `size`: HikariSettings() (SMAA
    2.0), the city's HDR camera and BloomSettings()."""
    from hikari_tpu_torch.ops.bloom import BloomSettings

    sc = lamps_scene()
    r = ht.Renderer(sc, city_camera(ht, size), ht.HikariSettings(),
                    device=device, bloom_settings=BloomSettings(), fxaa=fxaa)
    return r, sc


def compare_lamps_render(ht):
    """Path CL at 48x256 on CUDA against the CPU, 4 frames (the host refit
    between them), and CL with FXAA, 3 frames: SSIM >= 0.98 and mean abs
    diff < 1e-3."""
    from hikari_tpu_torch.ops.bloom import BloomSettings

    compare_city_render(ht, CITY_SMALL, 4, name="CL", build=lamps_scene,
                        bloom_settings=BloomSettings())
    compare_city_render(ht, CITY_SMALL, 3, name="CL with FXAA",
                        build=lamps_scene, bloom_settings=BloomSettings(),
                        fxaa=True)


def host_refit_reference(angles):
    """Path CL's compiled scene after host refits to the sphere angles
    `angles`, on the host alone: {name: numpy array} of every array and
    kernel 13 table the Renderer uploads."""
    from hikari_tpu_torch.examples import city

    sc = lamps_scene()
    gpu = sc.compile()
    for a in angles:
        gpu = gpu.update_transforms(city.rotate_sphere(sc, a))
    return {**gpu.arrays, **gpu.tables}


def check_city_lamps(ht):
    """Path CL's calls at 1920x1080 over two frames, each after
    update_scene(rotate_sphere(...), fast=True), the host refit (frame 0
    validates both direct channels, frame 1 neither): kernel 13 full and
    shadow (the probes in the 17 emitters' subtrees), 9 (3 sources), C,
    11 and 12 against their plain versions; the uploaded scene after the
    refits against the host refit's arrays word for word. Returns
    {record name: its path CL numbers}."""
    from contextlib import ExitStack

    from hikari_tpu_torch import frame as fr
    from hikari_tpu_torch.examples import city
    from hikari_tpu_torch.ops import denoise_fused as dnf
    from hikari_tpu_torch.ops import reproj_gather as rg
    from hikari_tpu_torch.ops import trace_cull as tc
    from hikari_tpu_torch.ops import warp2 as w2
    from hikari_tpu_torch.ops import warp_band as wb

    r, sc = lamps_renderer(ht, FULL)
    settings = r.settings
    emitters = sorted(int(i) for i in torch.nonzero(
        r.scene_dev["bvh_sub_root"] > 0).flatten())
    caps = [Capture(tc, "bvh_full"), Capture(tc, "bvh_shadow"),
            Capture(fr, "reproj_gather"), Capture(dnf, "atrous_level"),
            Capture(wb, "warp_band"), Capture(w2, "warp_multi")]
    angles = [city_angle(f) for f in range(2)]
    with ExitStack() as stack:
        for c in caps:
            stack.enter_context(c)
            c.on = True
        for a in angles:
            r.update_scene(city.rotate_sphere(sc, a), fast=True)
            r.render_frame()
        torch.cuda.synchronize()
    full_calls, shadow_calls, g_calls, c_calls, wb_calls, wm_calls = (
        c.calls for c in caps)
    first = COUNTERS.index("bvh_full")
    want = [sum(col) for col in zip(*(
        cl_launches(settings, n)[first:first + 2] for n in (0, 1)))]
    got = [len(full_calls), len(shadow_calls)]
    included = sorted({int(i) for a, _ in full_calls
                       for i in torch.unique(a[-1]) if i >= 0})
    others = [len(g_calls), len(c_calls), len(wb_calls), len(wm_calls)]
    print(f"path CL's two frames: kernel 13 calls {got} (need {want}), "
          f"9, C, 11, 12 calls {others} (need [2, 8, 4, 2]); emissive "
          f"subtrees of {len(emitters)} instances, probes included to "
          f"{len(included)} of them")
    if (got != want or others != [2, 8, 4, 2] or len(emitters) != 17
            or not set(included) <= set(emitters) or len(included) < 3):
        fail("path CL's two frames did not call its kernels as expected")
    if r._refitter is not None:
        fail("path CL's update_scene(fast=True) did not take the host refit")
    check_walk_calls(tc, "full", full_calls, "path CL")
    check_walk_calls(tc, "shadow", shadow_calls, "path CL")
    if any(len(a[0]) != 3 for a, _ in g_calls):
        fail("path CL's gather does not read 3 sources")
    check_gather_calls(rg, g_calls, "path CL")
    check_levels(dnf, c_calls[-4:], "path CL")
    check_band_calls(wb, wb_calls)
    check_multi_calls(w2, wm_calls)

    host = host_refit_reference(angles)
    dev = {k: v.cpu().numpy() for k, v in r.scene_dev.items()}
    differ = sorted(k for k in set(dev) | set(host)
                    if k not in dev or k not in host or not np.array_equal(
                        np.ascontiguousarray(dev[k]).view(np.uint8),
                        np.ascontiguousarray(host[k]).view(np.uint8)))
    print(f"path CL's uploaded scene after two host refits: {len(dev)} "
          f"tensors, equal word for word to the host refit's arrays but "
          f"{differ} (need none)")
    if differ:
        fail("path CL's uploaded scene differs from the host refit's")

    # frame 1's emissive probe (17 subtrees) and emissive shadow rays
    extra = {}
    for key, mode, a, name in (
            ("trace_bvh_full", "full", full_calls[-3][0], "cl_probe"),
            ("trace_bvh_shadow", "shadow", shadow_calls[-2][0],
             "cl_emissive")):
        extra[key] = {f"{k}_{name}": v for k, v in walk_record(
            tc, mode, a, f"path CL {name}").items()
            if k in ("ms", "device_ms", "plain_ms", "bound_ms")}
    return extra


def walk_profile(step):
    """The emissive walk's share of one step (--profile): its calls and
    host milliseconds (the wrapper's time, no synchronize) in one step,
    and its calls and PyTorch ops (aten ops, views included) in the
    next."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from hikari_tpu_torch.ops import sampling

    inner = sampling.walk_emissive_bvh
    stats = dict(calls=0, host_ms=0.0, op_calls=0, ops=0)
    counting = False

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            stats["ops"] += 1
            return func(*args, **(kwargs or {}))

    def wrapper(*a, **k):
        if counting:
            stats["op_calls"] += 1
            with Count():
                return inner(*a, **k)
        t = time.perf_counter()
        out = inner(*a, **k)
        stats["host_ms"] += (time.perf_counter() - t) * 1e3
        stats["calls"] += 1
        return out

    sampling.walk_emissive_bvh = wrapper
    try:
        step()
        torch.cuda.synchronize()
        counting = True
        step()
        torch.cuda.synchronize()
    finally:
        sampling.walk_emissive_bvh = inner
    return stats


def bloom_share(r, step):
    """Bloom's share of a step's device time (--profile): bloom on the
    overlay output the frame hands it, against the whole step (the host
    refit's uploads and the frame), each by device_total_ms."""
    from hikari_tpu_torch import renderer as ren

    cap = Capture(ren, "bloom")
    with cap:
        cap.on = True
        step()
    (img, settings), _ = cap.calls[-1]
    b_ms, b_n = device_total_ms(lambda: ren.bloom(img, settings))
    frame_ms, frame_n = device_total_ms(step)
    print(f"  path CL bloom ({img.shape[0]}x{img.shape[1]}): {b_ms:.4f} ms "
          f"of device time, {b_n:.0f} device kernels; the frame "
          f"{frame_ms:.4f} ms, {frame_n:.0f} kernels: bloom's share "
          f"{b_ms / frame_ms:.4f}")
    return dict(bloom_device_ms=b_ms, bloom_kernels=b_n,
                frame_device_ms=frame_ms, frame_kernels=frame_n,
                bloom_share=b_ms / frame_ms)


def city_lamps_path(ht, timed, profile):
    """Path CL through Renderer at 1920x1080 as the city's timing
    (bench.py:159-196): each frame update_scene(rotate_sphere(...),
    fast=True), the host refit above 8 emissives, + render_frame() with
    bloom. Returns (frame times with the refit, refit times up to a
    synchronize, launch counts per wrapper of COUNTERS over the timed
    frames, with --profile bloom's device share and the emissive walk's
    ops and host time per frame beside the city's, else None)."""
    from hikari_tpu_torch.examples import city

    r, sc = lamps_renderer(ht, FULL)
    gpu = r.gpu_scene
    if (gpu.num_instances, gpu.num_triangles, gpu.num_emissives) != (
            154, 3002, 17):
        fail("path CL is not the 154-instance, 3,002-triangle, "
             "17-emissive scene")
    r.update_scene(city.rotate_sphere(sc, 0.001), fast=True)
    r.render_frame()
    f = 0

    def step():
        nonlocal f
        r.update_scene(city.rotate_sphere(sc, city_angle(f)), fast=True)
        f += 1
        return r.render_frame()

    for _ in range(WARMUP_FRAMES):
        step()
    torch.cuda.synchronize()
    wrappers = counter_wrappers()
    for fn in wrappers:
        fn.launches = 0
    times, refit = [], []
    img = None
    for _ in range(timed):
        t = time.perf_counter()
        r.update_scene(city.rotate_sphere(sc, city_angle(f)), fast=True)
        torch.cuda.synchronize()
        refit.append((time.perf_counter() - t) * 1e3)
        img = r.render_frame()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
        f += 1
    counts = [fn.launches for fn in wrappers]
    first = 1 + WARMUP_FRAMES
    expected = [sum(col) for col in zip(*(
        cl_launches(r.settings, n) for n in range(first, first + timed)))]
    check_run("CL", counts, expected, img, timed)
    if r._refitter is not None:
        fail("path CL's update_scene(fast=True) did not take the host refit")
    extra = None
    if profile:
        profile_frames(step)
        extra = bloom_share(r, step)
        extra["walk"] = walk_profile(step)
        csc = city.build_scene(3)
        cr = ht.Renderer(csc, city_camera(ht, FULL), ht.HikariSettings())
        extra["walk_city"] = walk_profile(lambda: cr.update_scene(
            city.rotate_sphere(csc, 0.1), fast=True) or cr.render_frame())
        print(f"  emissive walk per frame: path CL {extra['walk']}, the "
              f"city {extra['walk_city']}")
    return times, refit, counts, extra


def device_total_ms(fn, reps=2):
    """The device time in ms of everything fn() launches (kernels, copies
    and fills), per run over `reps` runs, and the number of device
    kernels per run, from torch.profiler's trace."""
    from torch.profiler import ProfilerActivity, profile as prof_

    fn()
    torch.cuda.synchronize()
    with prof_(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA]
    return (sum(e.device_time_total for e in ev) / reps / 1e3,
            len(ev) / reps)


def fsr_share(r):
    """FSR's share of path F's device time (--profile): EASU + RCAS on
    the input the frame hands them, against the whole frame, each by
    device_total_ms."""
    from hikari_tpu_torch.ops import fsr, post

    cap = Capture(post, "easu")
    with cap:
        cap.on = True
        r.render_frame()
    (cur, size), _ = cap.calls[-1]
    ones = torch.ones(tuple(size) + (1,), device=cur.device)
    sharp = r.settings.upscale.sharpness

    def step():
        return fsr.rcas(torch.cat([fsr.easu(cur, size), ones], -1), sharp)

    f_ms, f_n = device_total_ms(step)
    frame_ms, frame_n = device_total_ms(r.render_frame)
    print(f"  path F FSR (EASU + RCAS, {cur.shape[0]}x{cur.shape[1]} -> "
          f"{size[0]}x{size[1]}): {f_ms:.4f} ms of device time, {f_n:.0f} "
          f"device kernels; the frame {frame_ms:.4f} ms, {frame_n:.0f} "
          f"kernels: FSR's share {f_ms / frame_ms:.4f}")
    return dict(fsr_device_ms=f_ms, fsr_kernels=f_n,
                frame_device_ms=frame_ms, frame_kernels=frame_n,
                fsr_share=f_ms / frame_ms)


def scene_path(ht, timed, profile):
    """Path F through Renderer at 1920x1080: the scene of
    examples/scene.py at its settings (4 bounces, FSR 1.0 at ratio 2) and
    camera, static. Returns (frame times, launch counts per wrapper of
    COUNTERS over the timed frames, FSR's device share with --profile or
    None)."""
    r = scene_renderer(ht, FULL)
    for _ in range(WARMUP_FRAMES):
        r.render_frame()
    torch.cuda.synchronize()
    wrappers = counter_wrappers()
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
    expected = [sum(col) for col in zip(*(
        scene_launches(r.settings, n)
        for n in range(WARMUP_FRAMES, WARMUP_FRAMES + timed)))]
    check_run("F", counts, expected, img, timed)
    share = None
    if profile:
        profile_frames(r.render_frame)
        share = fsr_share(r)
    return times, counts, share


# --- paths M and G and check U -------------------------------------------

# where the examples write their images and path G finds its GLB: a
# temporary directory main() makes and removes
WORK = {"dir": None}


def work_dir(*parts):
    return os.path.join(WORK["dir"], *parts)


def minimal_launches(settings, number):
    """Path M's launches in frame `number` (examples/minimal.py: a cube on
    a plane, 14 triangles, a sun and no emissive, at HikariSettings()):
    hikari_tpu's gates take the fused kernels for a scene of at most 768
    triangles without textures, so kernel A once (its decimated call at
    ratio 2), 8 once (SMAA's parity quads), the gather once (3 sources:
    the direct and indirect temporal carries, the emissive channel tracing
    nothing without an emissive, and the indirect spatial carry), kernel 4
    once (the sun's and the indirect channels), 10 once (indirect spatial
    reuse), a-trous 4 (both channels in one pass a level), SMAA's two
    warps and TAA's; no validation frame launches more. Path D's counts:
    the box swaps the sun for an emissive."""
    return (1, 1, 1, 1, 1, 4, 2, 1, 0, 0, 0, 0, 0, 0, 0)


def dissection_launches(settings, number):
    """The launches of one render_dissection of the box at HikariSettings()
    (the modular lighting and spatial paths, hikari_tpu's debug frame):
    kernel A once, 8 once, the gather once (the emissive and indirect
    temporal carries; the spatial carry is the modular pass's), kernel 5
    for the bounce, 6 and 7 for the emissive channel's probe and shadow
    ray and the bounce's, both again on the emissive channel's validation
    frames, a-trous 4, SMAA's two warps and TAA's; no 4 or 10."""
    v = int(number % settings.emissive_validate_interval == 0)
    return (1, 1, 1, 0, 0, 4, 2, 1, 1, 2 + v, 2 + v, 0, 0, 0, 0)


def example_renderer(name, frames):
    """The example `name`'s main at FULL (CUDA, its own settings) for
    `frames` frames, its image written to the work directory. Returns its
    (renderer, last image)."""
    import importlib

    mod = importlib.import_module(f"hikari_tpu_torch.examples.{name}")
    h, w = FULL
    return mod.main(["--width", str(w), "--height", str(h), "--frames",
                     str(frames), "--out", work_dir(f"{name}.png")])


def write_cornell_asset():
    """tests/torch_glb.py's GLB of the procedural box at
    <work>/assets/models/cornell.glb, with HIKARI_ASSETS pointing there
    (examples/cornell.py reads it at call time)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "torch_glb", os.path.join(HERE, "tests", "torch_glb.py"))
    glb = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(glb)
    path = glb.write_cornell_glb(work_dir("assets", "models", "cornell.glb"))
    os.environ["HIKARI_ASSETS"] = work_dir("assets")
    return path


def frame_captures():
    """Captures of every kernel wrapper a box frame reaches, in the order
    of COUNTERS' first eight (A, 8, 9, B/4, 10, C, 11, 12), then 5, 6,
    7."""
    from hikari_tpu_torch import frame as fr
    from hikari_tpu_torch.ops import denoise_fused as dnf
    from hikari_tpu_torch.ops import light_fused as lf
    from hikari_tpu_torch.ops import prepass_fused as pf
    from hikari_tpu_torch.ops import spatial_fused as sf
    from hikari_tpu_torch.ops import trace_pallas as tp
    from hikari_tpu_torch.ops import warp2 as w2
    from hikari_tpu_torch.ops import warp_band as wb

    return ([Capture(pf, "prepass_kernel"),
             Capture(pf, "prepass_quads_kernel"),
             Capture(fr, "reproj_gather"), Capture(lf, "lighting_kernel"),
             Capture(sf, "spatial_kernel"), Capture(dnf, "atrous_level"),
             Capture(wb, "warp_band"), Capture(w2, "warp_multi")]
            + [Capture(tp, name) for name, *_ in TRACE_KERNELS])


def captured(step, caps):
    """Runs step() with the captures installed and on. Returns the calls
    of each."""
    from contextlib import ExitStack

    with ExitStack() as stack:
        for c in caps:
            stack.enter_context(c)
            c.on = True
        step()
        torch.cuda.synchronize()
    return [c.calls for c in caps]


def check_frame_calls(calls, label, spatial_label=None):
    """Every captured call of frame_captures() against its plain version
    (kernel A and 4 / 10 within their tolerances, the others bit for
    bit). Returns the max abs error of kernels 5, 6, 7."""
    from hikari_tpu_torch.ops import denoise_fused as dnf
    from hikari_tpu_torch.ops import light_fused as lf
    from hikari_tpu_torch.ops import prepass_fused as pf
    from hikari_tpu_torch.ops import reproj_gather as rg
    from hikari_tpu_torch.ops import spatial_fused as sf
    from hikari_tpu_torch.ops import trace_pallas as tp
    from hikari_tpu_torch.ops import warp2 as w2
    from hikari_tpu_torch.ops import warp_band as wb

    a_calls, q_calls, g_calls, l_calls, s_calls, c_calls, wb_calls, \
        wm_calls, *trace_calls = calls
    for a, _ in a_calls:
        check_prepass_call(pf, a, label)
    quads_checks(pf, q_calls, a_calls)
    check_gather_calls(rg, g_calls, label)
    check_lighting_calls(lf, l_calls, label)
    check_spatial_calls(sf, s_calls, spatial_label or label)
    for i in range(0, len(c_calls), 4):
        check_levels(dnf, c_calls[i:i + 4], label)
    check_band_calls(wb, wb_calls)
    check_multi_calls(w2, wm_calls)
    return check_trace_calls(tp, trace_calls, label)


def check_call_counts(label, calls, per_frame):
    """The captured calls of frame_captures() (with a ray, for 5, 6 and 7)
    against `per_frame` summed: A, 8, 9, B/4, 10, C, 11, 12, 5, 6, 7."""
    counts = [len(c) for c in calls[:8]] + [
        sum(1 for a, _ in c if a[-5].shape[0]) for c in calls[8:]]
    need = [sum(col) for col in zip(*per_frame)]
    need = need[:8] + need[8:11]
    print(f"{label}: kernels A, 8, 9, B/4, 10, C, 11, 12, 5, 6, 7 calls "
          f"{counts} (need {need})")
    if counts != need:
        fail(f"{label} did not call its kernels as expected")


def check_minimal(ht):
    """Path M's first frame through examples/minimal.py's main at
    1920x1080, then every kernel call of its next two frames (A, 8, 9, 4
    with the sun's and the indirect channels, 10, C, 11, 12) against its
    plain version, and a small CUDA render against the CPU."""
    from hikari_tpu_torch.examples import minimal

    r, _ = example_renderer("minimal", 1)
    settings = r.settings

    def step():
        for _ in range(2):
            r.render_frame()

    calls = captured(step, frame_captures())
    # the column order of COUNTERS' first eight, then 5-7
    check_call_counts("path M, 2 frames", calls,
                      [minimal_launches(settings, n) for n in (1, 2)])
    if not r.gpu_scene.has_sun or r.gpu_scene.num_emissives:
        fail("the minimal scene is not a sun-lit scene without emissives")
    check_frame_calls(calls, "path M")
    h, w = SMALL
    cam = ht.Camera.from_look_at(minimal.EYE, minimal.TARGET, width=w,
                                 height=h)
    compare_renders(ht, minimal.build_scene, SMALL, "M", settings, 4,
                    cam=cam)


def time_frames(r, name, per_frame, timed, first):
    """`timed` frames of renderer r, each timed to a synchronize, with the
    launch counters set to 0 before them; their counts must equal
    per_frame's for frame numbers first.. (check_run). Returns (frame
    times, counts)."""
    wrappers = counter_wrappers()
    for fn in wrappers:
        fn.launches = 0
    times, img = [], None
    for _ in range(timed):
        t = time.perf_counter()
        img = r.render_frame()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    counts = [fn.launches for fn in wrappers]
    expected = [sum(col) for col in zip(*(
        per_frame(r.settings, n) for n in range(first, first + timed)))]
    check_run(name, counts, expected, img, timed)
    return times, counts


def minimal_path(ht, timed, profile):
    """Path M: examples/minimal.py's main at 1920x1080 for WARMUP_FRAMES
    frames, then `timed` frames of its renderer. Returns (frame times,
    launch counts of COUNTERS)."""
    r, _ = example_renderer("minimal", WARMUP_FRAMES)
    times, counts = time_frames(r, "M", minimal_launches, timed,
                                WARMUP_FRAMES)
    if profile:
        profile_frames(r.render_frame)
    return times, counts


def cornell_path(ht, timed, profile):
    """Path G: examples/cornell.py's main (the box from its GLB through
    the glTF loader, HikariSettings() with a black clear colour) at
    1920x1080 for WARMUP_FRAMES frames, then `timed` frames (D's
    launches), then render_dissection() three times (timed to its numpy
    planes), every kernel call of a fourth against its plain version with
    its launches, and a render_frame after it with D's launches. Returns
    (frame times, launch counts, dissection times)."""
    r, _ = example_renderer("cornell", WARMUP_FRAMES)
    if (r.gpu_scene.num_triangles, r.gpu_scene.num_emissives,
            r.settings.clear_color) != (36, 1, (0.0, 0.0, 0.0, 1.0)):
        fail("path G is not the box from its GLB at cornell's settings")
    # the box read from its GLB is the procedural box (36 triangles, one
    # emissive, no sun): path D's launches
    d_launches = PATHS["D"][1]
    times, counts = time_frames(r, "G", d_launches, timed, WARMUP_FRAMES)
    dissection = []
    for _ in range(3):
        t = time.perf_counter()
        planes = r.render_dissection()
        dissection.append((time.perf_counter() - t) * 1e3)
    print(f"path G dissection: {len(planes)} planes, "
          f"{float(np.median(dissection)):.2f} ms median of {dissection}")
    number = r._frame_index
    out = {}
    calls = captured(lambda: out.update(r.render_dissection()),
                     frame_captures())
    check_call_counts(f"path G dissection (frame {number})", calls,
                      [dissection_launches(r.settings, number)])
    check_frame_calls(calls, "path G dissection")
    tone = out["tone_mapping"]
    render = (FULL[0] // 2, FULL[1] // 2)
    if not np.isfinite(tone).all() or tone.shape != render + (4,):
        fail(f"the dissection's tone_mapping is not a finite {render} "
             "image")
    if not np.isfinite(out["final"]).all():
        fail("the dissection's final image is not finite")
    print(f"  dissection tone_mapping {tone.shape} finite, mean "
          f"{float(tone[..., :3].mean()):.4f}")
    time_frames(r, "G after the dissections", d_launches, 1, r._frame_index)
    if profile:
        profile_frames(r.render_frame)
        # the dissection's device work and its device-to-host copies
        profile_frames(r.render_dissection)
    return times, counts, dissection


U_SIZE = (540, 960)
U_FRAMES = 2
U_TRIS = 2618


def check_universal(ht, build_box):
    """Check U: (a) the city (2,618 triangles) compiled without the mesh
    acceleration structure and rendered with brute_force_max=4096 at
    960x540, HikariSettings(), the city's HDR camera: kernels 5, 6 and 7
    over the whole table (and the 1,224-row emissive table), every call of
    two frames word for word against its plain version, and kernel 6 on
    the first frame's primary rays with the scene's 2,618 attribute rows;
    one record each (events, device, host, bound, launches over the two
    frames); (b) the box at HikariSettings() with brute_force_max=0:
    kernel 13 and the non-fused prepass, every kernel call of its second
    1080p frame against its plain version; (c) small CUDA renders of both
    against the CPU at SSIM >= 0.9999. Returns the records."""
    from hikari_tpu_torch.examples import city
    from hikari_tpu_torch.ops import trace_cull as tc
    from hikari_tpu_torch.ops import trace_pallas as tp

    uni = ht.HikariUniversalSettings(build_mesh_acceleration_structure=False)

    def city_gpu():
        return city.build_scene(3).compile(uni)

    gpu = city_gpu()
    if (gpu.num_triangles, gpu.num_nodes) != (U_TRIS, 1):
        fail("check U's city is not the 2,618-triangle single-leaf scene")
    r = ht.Renderer(gpu, city_camera(ht, U_SIZE), ht.HikariSettings(),
                    brute_force_max=4096)
    if r.tracer.kind != "brute_force_pallas":
        fail("brute_force_max=4096 did not take the brute-force engine")
    caps = [Capture(tp, name) for name, *_ in TRACE_KERNELS]
    launches = []

    def step():
        for _ in range(U_FRAMES):
            r.render_frame()
        launches.extend(getattr(tp, name).launches
                        for name, *_ in TRACE_KERNELS)

    trace_calls = captured(step, caps)
    rows = [sorted({a[0].shape[0] for a, _ in c}) for c in trace_calls]
    with_rays = [sum(1 for a, _ in c if a[-5].shape[0]) for c in trace_calls]
    print(f"check U (a): kernels 5, 6, 7 launched {launches} times over "
          f"{U_FRAMES} frames ({with_rays} calls with rays), tables of "
          f"{rows} rows")
    if rows[0] != [2624] or rows[2] != [2624] or min(with_rays) == 0:
        fail("check U's kernels 5 and 7 did not trace the whole table")
    # (a CPU rehearsal of this script runs the plain versions, which
    # launch nothing)
    if DEVICE == "cuda" and launches != with_rays:
        fail("check U's kernels 5, 6 and 7 did not launch once a call")
    errs = check_trace_calls(tp, trace_calls, "U (a)")
    # kernel 6 over the scene table: the first frame's primary rays
    a5 = trace_calls[0][0][0]
    a6 = ((a5[0], r.scene_dev["tri_attr"], *a5[1:]), {})
    errs[1] = max(errs[1], check_trace_calls(
        tp, [[], [a6], []], "U (a) primary rays, scene table")[1])
    records = []
    for (name, plain, replaces, _), call, err, n in zip(
            TRACE_KERNELS, (trace_calls[0][0], a6, trace_calls[2][0]), errs,
            launches):
        rec = trace_record(tp, name, plain, replaces, call)
        rec.update(name=f"{name}_{U_TRIS}_rows", max_abs_err=err,
                   launches=n, table_rows=call[0][0].shape[0])
        records.append(rec)

    # (b) the box through kernel 13
    box_r = ht.Renderer(build_box(), ht.Camera.from_look_at(
        load_box_module().EYE, load_box_module().TARGET, width=FULL[1],
        height=FULL[0]), ht.HikariSettings(), brute_force_max=0)
    if box_r.tracer.kind != "cull":
        fail("brute_force_max=0 did not take kernel 13 on the box")
    box_r.render_frame()
    caps = frame_captures() + [Capture(tc, "bvh_full"),
                               Capture(tc, "bvh_shadow")]
    calls = captured(box_r.render_frame, caps)
    counts = [len(c) for c in calls]
    # A, 8, 9, B/4, 10, C, 11, 12, 5, 6, 7, 13 full, 13 shadow: the
    # primary rays, the emissive probe and the bounce and its probe (13
    # full), the emissive and bounce NEE shadow rays (13 shadow); frame 1
    # validates nothing
    need = [0, 0, 1, 0, 0, 4, 2, 1, 0, 0, 0, 4, 2]
    print(f"check U (b), the box at brute_force_max=0, frame 1: kernels A, "
          f"8, 9, B/4, 10, C, 11, 12, 5, 6, 7, 13 full, 13 shadow calls "
          f"{counts} (need {need})")
    if counts != need:
        fail("the box at brute_force_max=0 did not call its kernels as "
             "expected")
    check_frame_calls(calls[:11], "U (b)")
    check_walk_calls(tc, "full", calls[11], "U (b)")
    check_walk_calls(tc, "shadow", calls[12], "U (b)")

    # (c) small renders against the CPU
    compare_renders(ht, city_gpu, CITY_SMALL, "U (a)", ht.HikariSettings(),
                    U_FRAMES, min_ssim=0.9999,
                    cam=city_camera(ht, CITY_SMALL), brute_force_max=4096)
    compare_renders(ht, build_box, SMALL, "U (b)", ht.HikariSettings(), 4,
                    min_ssim=0.9999, brute_force_max=0)
    for rec in records:
        print(f"  {rec['name']}: {rec['ms']:.4f} ms per launch, device "
              f"{rec['device_ms']} ms, host {rec['host_us']:.1f} us, plain "
              f"{rec['plain_ms']:.3f} ms, bound {rec['bound_ms']:.4f} ms "
              f"({rec['bound_by']}), {rec['launches']} launches")
    return records


# ------------------------------------------------------------------ path SM

SB_FRAMES = 3
SM_CAPTURED = 2           # frames whose island calls are checked
SM_TIMEOUT_S = 900        # a collective that waits longer fails the rank


def sharded_layout():
    """(ranks, backend, devices) of path SM: one rank per card over NCCL;
    on a machine with one card two ranks on it over gloo, whose
    collectives the port stages through the host (NCCL takes one rank a
    card)."""
    cards = torch.cuda.device_count()
    if cards > 1:
        return cards, "nccl", [f"cuda:{r}" for r in range(cards)]
    return 2, "gloo", ["cuda:0", "cuda:0"]


def frame_program(ht, scene_host, cam, settings, dev):
    """What a user of the row mesh builds (hikari_tpu_torch.frame
    build_render_frame, as for hikari_tpu's shard_frame): (frame function,
    scene, view, noise, carry) on `dev`, the carry's previous view seeded
    with the camera's (Renderer's first frame)."""
    from hikari_tpu_torch.camera import view_to_device
    from hikari_tpu_torch.frame import build_render_frame, init_carry
    from hikari_tpu_torch.ops.noise import noise_constant
    from hikari_tpu_torch.ops.trace import make_tracer

    gpu = scene_host.compile()
    scene = gpu.as_pytree(dev)
    size = (cam.height, cam.width)
    fn = build_render_frame(settings, size, scene,
                            make_tracer(gpu.num_triangles),
                            gpu.num_textures == 0,
                            num_emissives=gpu.num_emissives,
                            has_sun=gpu.has_sun)
    view = view_to_device(cam.view_uniform(), dev)
    carry = init_carry(size, settings, dev)
    carry["prev_view_proj"] = view["view_proj"].clone()
    carry["prev_inverse_view_proj"] = view["inverse_view_proj"].clone()
    return fn, scene, view, noise_constant(dev), carry


def carry_leaves(carry, prefix=""):
    out = {}
    for k, v in carry.items():
        if isinstance(v, dict):
            out.update(carry_leaves(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def same_words(a, b):
    return (a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8)))


def word_digest(t):
    """An int64 digest of a float32 tensor's words (position-weighted)."""
    w = t.contiguous().view(-1).view(torch.int32).to(torch.int64)
    return (w * (torch.arange(w.numel(), device=w.device) % 65521 + 1)).sum()


def island_captures():
    """Captures of the wrappers the islands call on their rank's block (A,
    8, 9, B / 4, 10 (whole), C, 11, 12, then 5, 6, 7), in the order of
    frame_captures(). The post chain calls 11 and 12 through the same
    module names with its mesh: those outer calls are dropped
    (island_calls)."""
    from hikari_tpu_torch.ops import denoise_fused as dnf
    from hikari_tpu_torch.ops import light_fused as lf
    from hikari_tpu_torch.ops import prepass_fused as pf
    from hikari_tpu_torch.ops import reproj_gather as rg
    from hikari_tpu_torch.ops import spatial_fused as sf
    from hikari_tpu_torch.ops import trace_pallas as tp
    from hikari_tpu_torch.ops import warp2 as w2
    from hikari_tpu_torch.ops import warp_band as wb

    return ([Capture(pf, "prepass_kernel"),
             Capture(pf, "prepass_quads_kernel"),
             Capture(rg, "reproj_gather"), Capture(lf, "lighting_kernel"),
             Capture(sf, "spatial_kernel"), Capture(dnf, "atrous_level"),
             Capture(wb, "warp_band"), Capture(w2, "warp_multi")]
            + [Capture(tp, name) for name, *_ in TRACE_KERNELS])


def island_calls(calls):
    return [[(a, k) for a, k in c if k.get("mesh") is None] for c in calls]


class WireBytes:
    """Counts the bytes a rank receives by the port's collectives while
    installed: all_gather and all_gather_into_tensor (every rank's block)
    and point-to-point halo receives. Calls only: a replayed graph's
    collectives are counted at its capture."""

    def __init__(self):
        import torch.distributed as dist

        self.dist = dist
        self.gathered = self.halo = 0

    def __enter__(self):
        dist = self.dist
        self.all_gather, self.batch = dist.all_gather, dist.batch_isend_irecv
        self.into = dist.all_gather_into_tensor

        def all_gather(parts, t, *a, **k):
            self.gathered += sum(p.numel() * p.element_size() for p in parts)
            return self.all_gather(parts, t, *a, **k)

        def into(out, t, *a, **k):
            self.gathered += out.numel() * out.element_size()
            return self.into(out, t, *a, **k)

        def batch(ops):
            self.halo += sum(o.tensor.numel() * o.tensor.element_size()
                             for o in ops if o.op is dist.irecv)
            return self.batch(ops)

        dist.all_gather, dist.batch_isend_irecv = all_gather, batch
        dist.all_gather_into_tensor = into
        return self

    def __exit__(self, *exc):
        self.dist.all_gather = self.all_gather
        self.dist.batch_isend_irecv = self.batch
        self.dist.all_gather_into_tensor = self.into


def sharded_frames(fn, state, settings, first, frames, mesh, times=None):
    """`frames` frames (numbers first..) of a shard_frame'd frame function
    over `mesh`, each to a synchronize (and timed into `times`). Returns
    [(image, albedo)] and the carry."""
    from hikari_tpu_torch.config import make_frame_uniform

    scene, view, noise, carry = state
    outs = []
    for i in range(first, first + frames):
        t = time.perf_counter()
        image, albedo, carry = fn(scene, view,
                                  make_frame_uniform(settings, i), noise,
                                  carry)
        torch.cuda.synchronize()
        if times is not None:
            times.append((time.perf_counter() - t) * 1e3)
        outs.append((image, albedo))
    return outs, carry


def sharded_program(ht, scene_of, cam, settings, mesh):
    """frame_program under shard_frame over `mesh`: (fn, (scene, view,
    noise, carry))."""
    from hikari_tpu_torch.config import make_frame_uniform
    from hikari_tpu_torch.parallel import shard_frame

    fn, scene, view, noise, carry = frame_program(ht, scene_of(), cam,
                                                  settings, mesh.device)
    fn, (scene, view, _, noise, carry) = shard_frame(
        fn, mesh, scene, view, make_frame_uniform(settings, 0), noise, carry,
        {cam.height})
    return fn, (scene, view, noise, carry)


def minimal_camera(ht):
    from hikari_tpu_torch.examples import minimal

    h, w = FULL
    return ht.Camera.from_look_at(minimal.EYE, minimal.TARGET, width=w,
                                  height=h)


def box_camera(ht):
    box = load_box_module()
    h, w = FULL
    return ht.Camera.from_look_at(box.EYE, box.TARGET, width=w, height=h)


def sb_cases(ht):
    """Check SB's configurations: (name, scene_of, camera, settings,
    launches per frame)."""
    box = load_box_module()

    def scene_of():
        return box.build_cornell_box("hikari_tpu_torch")

    return [("SB no-reuse", scene_of, box_camera(ht), flagship_settings(ht),
             PATHS["no-reuse"][1]),
            ("SB KR", scene_of, box_camera(ht), PATHS["KR"][0](ht),
             kr_launches)]


def sm_rank_work(ht, mesh):
    """Path SM and check SB on this rank. Returns (result for the parent,
    [(name, scene_of, camera, settings, sharded outputs, final carry)]
    for the single-card comparison)."""
    from hikari_tpu_torch.examples import minimal

    label = f"rank {mesh.rank}"
    settings = minimal.settings()
    cam = minimal_camera(ht)
    fn, state = sharded_program(ht, minimal.build_scene, cam, settings, mesh)
    wrappers = counter_wrappers()
    outs, carry = sharded_frames(fn, state, settings, 0, WARMUP_FRAMES,
                                 mesh)
    for w in wrappers:
        w.launches = 0
    times = []
    with WireBytes() as wire:
        timed, carry = sharded_frames(fn, (*state[:3], carry), settings,
                                      WARMUP_FRAMES, TIMED_FRAMES, mesh,
                                      times)
    outs += timed
    counts = [w.launches for w in wrappers]
    expected = [sum(col) for col in zip(*(
        minimal_launches(settings, i)
        for i in range(WARMUP_FRAMES, WARMUP_FRAMES + TIMED_FRAMES)))]
    print(f"path SM {label}: launches over {TIMED_FRAMES} frames "
          f"({', '.join(COUNTERS)}): {counts} (need {expected})")
    if counts != expected:
        fail(f"path SM {label} did not launch each kernel as expected")
    first = WARMUP_FRAMES + TIMED_FRAMES
    caps = island_captures()

    def step():
        nonlocal carry
        more, carry = sharded_frames(fn, (*state[:3], carry), settings,
                                     first, SM_CAPTURED, mesh)
        outs.extend(more)

    calls = island_calls(captured(step, caps))
    check_call_counts(f"path SM {label}, {SM_CAPTURED} frames", calls,
                      [minimal_launches(settings, i)
                       for i in range(first, first + SM_CAPTURED)])
    runs = [("SM", minimal.build_scene, cam, settings, outs, carry)]
    sb_counts = {}
    for name, scene_of, cam_b, settings_b, per_frame in sb_cases(ht):
        fn_b, state_b = sharded_program(ht, scene_of, cam_b, settings_b,
                                        mesh)
        for w in wrappers:
            w.launches = 0
        outs_b, carry_b = sharded_frames(fn_b, state_b, settings_b, 0,
                                         SB_FRAMES, mesh)
        got = [w.launches for w in wrappers]
        need = [sum(col) for col in zip(*(per_frame(settings_b, i)
                                          for i in range(SB_FRAMES)))]
        print(f"check {name} {label}: launches {got} (need {need})")
        if got != need:
            fail(f"check {name} {label} did not launch as expected")
        sb_counts[name] = got
        runs.append((name, scene_of, cam_b, settings_b, outs_b, carry_b))
    # every rank holds the same words: a digest of each run's last image
    # and albedo and its carry, gathered
    import torch.distributed as dist

    digest = torch.stack([word_digest(t) for run in runs for t in [
        *run[4][-1], *carry_leaves(run[5]).values()]])
    sent = digest.cpu() if mesh.staged else digest
    parts = [torch.empty_like(sent) for _ in range(mesh.n)]
    dist.all_gather(parts, sent)
    if any(not torch.equal(p.cpu(), digest.cpu()) for p in parts):
        fail(f"path SM {label}: the ranks hold different words")
    # every island call of the captured frames against its plain version
    check_frame_calls(calls, f"path SM {label}")
    result = {"times": times, "counts": counts,
              "gathered_bytes_per_frame": wire.gathered / TIMED_FRAMES,
              "halo_bytes_per_frame": wire.halo / TIMED_FRAMES,
              "sb_counts": sb_counts,
              "calls": [len(c) for c in calls]}
    return result, runs


def compare_single_card(ht, runs, dev):
    """Each sharded run against the same frames on one card without the
    mesh, word for word: every frame's image and albedo, and the carry
    after the last."""
    for name, scene_of, cam, settings, outs, carry in runs:
        fn, scene, view, noise, c1 = frame_program(ht, scene_of(), cam,
                                                   settings, dev)
        from hikari_tpu_torch.config import make_frame_uniform

        for i, (image, albedo) in enumerate(outs):
            img1, alb1, c1 = fn(scene, view, make_frame_uniform(settings, i),
                                noise, c1)
            if not (same_words(img1, image) and same_words(alb1, albedo)):
                fail(f"{name}: sharded frame {i} differs from the single "
                     "card's")
        leaves, leaves1 = carry_leaves(carry), carry_leaves(c1)
        bad = [k for k in leaves1 if not same_words(leaves[k], leaves1[k])]
        if set(leaves) != set(leaves1) or bad:
            fail(f"{name}: sharded carry differs from the single card's: "
                 f"{bad}")
        img = outs[-1][0].cpu()
        if not torch.isfinite(img).all() or float(img[..., :3].mean()) \
                <= 0.01:
            fail(f"{name}: bad image")
        print(f"{name}: {len(outs)} sharded frames equal the single card's "
              f"word for word (image, albedo; the carry's "
              f"{len(leaves)} tensors after the last)")


def sm_rank(rank, n, backend, devices, store, out_dir):
    """One rank of path SM (spawned): joins the process group, runs
    sm_rank_work, rank 0 then compares with the single card, and writes
    its result to out_dir/rank<r>.json."""
    import datetime

    import torch.distributed as dist

    sys.path.insert(0, HERE)
    import hikari_tpu_torch as ht
    from hikari_tpu_torch.parallel import make_mesh

    dev = torch.device(devices[rank])
    torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method="file://" + store,
                            rank=rank, world_size=n,
                            timeout=datetime.timedelta(seconds=SM_TIMEOUT_S))
    try:
        mesh = make_mesh(n, device=None if backend == "nccl" else dev)
        if mesh.device != dev:
            fail(f"rank {rank} on {mesh.device}, expected {dev}")
        # the eager sharded frame (sharded_replay holds the replayed one
        # against it)
        with ht.renderer.eager():
            result, runs = sm_rank_work(ht, mesh)
        dist.barrier(device_ids=[dev.index] if backend == "nccl" else None)
    finally:
        dist.destroy_process_group()
    if rank == 0:
        compare_single_card(ht, runs, dev)
        result["single_card_equal"] = True
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(result, f)


def sharded_path(ht, card):
    """Path SM (examples/minimal.py's scene, settings and camera at
    1920x1080 under shard_frame over every card) and check SB (the box
    without reuse, and with checkerboard + temporal reuse, 3 frames each),
    one spawned process a rank. Returns the SM line's record and the
    launches of COUNTERS over its timed frames, summed over the ranks."""
    import torch.multiprocessing as mp

    n, backend, devices = sharded_layout()
    how = ("one rank per card over NCCL" if backend == "nccl" else
           f"{n} ranks on one card over gloo, collectives staged through "
           "the host")
    # the frames here run eagerly (sm_rank); over NCCL sharded_replay holds
    # the captured graphs against them
    route = ("eager here; replayed as captured graphs in path SM replayed"
             if backend == "nccl" else
             "eager by rule: gloo stages CUDA tensors through the host, "
             "which no CUDA graph can capture (path SM replayed runs a "
             "one-rank NCCL mesh instead)")
    print(f"path SM: {n} ranks ({how}) on {devices}; {route}")
    out_dir = work_dir("sm")
    os.makedirs(out_dir, exist_ok=True)
    t0 = time.perf_counter()
    mp.spawn(sm_rank, args=(n, backend, devices, work_dir("sm_store"),
                            out_dir), nprocs=n, join=True)
    res = []
    for r in range(n):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            res.append(json.load(f))
    if not res[0].get("single_card_equal"):
        fail("path SM was not compared with the single card")
    print(f"path SM and check SB took {time.perf_counter() - t0:.1f} s")
    times = res[0]["times"]
    return {"frame_ms_minimal_sharded": float(np.median(times)),
            "reps_ms": times, "ranks": n, "backend": backend,
            "placement": how, "route": route, "devices": devices,
            "card": card,
            "gathered_bytes_per_frame": res[0]["gathered_bytes_per_frame"],
            "halo_bytes_per_frame": res[0]["halo_bytes_per_frame"],
            "launches_per_rank": [dict(zip(COUNTERS, r["counts"]))
                                  for r in res],
            "sb_launches_per_rank": [r["sb_counts"] for r in res],
            "minimal_triangles": 14}, [
                sum(col) for col in zip(*(r["counts"] for r in res))]


# ---------------------------------------------------------------------------
# path SM replayed: the sharded frame's captured graphs over NCCL
# ---------------------------------------------------------------------------

def sm_replay_work(ht, mesh):
    """Path SM's sharded frame (shard_frame over `mesh`) from one fresh
    state twice in lockstep, inside compiled.eager() and replayed (one
    graph per frame key on every rank), until every key has come twice:
    the image, the albedo and every carry tensor equal word for word on
    this rank. Returns (record, the replayed run for compare_single_card:
    (name, scene_of, camera, settings, outputs, final carry))."""
    from hikari_tpu_torch import compiled
    from hikari_tpu_torch.config import make_frame_uniform
    from hikari_tpu_torch.examples import minimal

    label = f"rank {mesh.rank}"
    settings = minimal.settings()
    cam = minimal_camera(ht)
    fn_e, (scene_e, view_e, noise_e, carry_e) = sharded_program(
        ht, minimal.build_scene, cam, settings, mesh)
    fn_c, (scene_c, view_c, noise_c, carry_c) = sharded_program(
        ht, minimal.build_scene, cam, settings, mesh)
    period = 2 * settings.direct_validate_interval \
        * settings.emissive_validate_interval
    keys = {fn_c.frame_fn.key(make_frame_uniform(settings, n))
            for n in range(period)}
    seen, outs, t_e, t_c, t_cap = {}, [], [], [], []
    i = 0
    while any(seen.get(k, 0) < 2 for k in keys):
        frame = make_frame_uniform(settings, i)
        k = fn_c.frame_fn.key(frame)
        seen[k] = seen.get(k, 0) + 1
        t = time.perf_counter()
        with compiled.eager():
            img_e, alb_e, carry_e = fn_e(scene_e, view_e, frame, noise_e,
                                         carry_e)
        torch.cuda.synchronize()
        de = (time.perf_counter() - t) * 1e3
        before = len(fn_c.graph_keys())
        t = time.perf_counter()
        img_c, alb_c, carry_c = fn_c(scene_c, view_c, frame, noise_c,
                                     carry_c)
        torch.cuda.synchronize()
        dc = (time.perf_counter() - t) * 1e3
        pairs = [("image", img_e, img_c), ("albedo", alb_e, alb_c)]
        ce, cc = carry_leaves(carry_e), carry_leaves(carry_c)
        pairs += [(f"carry {k}", ce[k], cc[k]) for k in ce]
        for what, a, b in pairs:
            if not same_words(a, b):
                fail(f"path SM replayed {label}: frame {i} {what} differs "
                     "from the eager sharded frame's words")
        if len(fn_c.graph_keys()) > before:
            t_cap.append(dc)
        else:
            t_e.append(de)
            t_c.append(dc)
        outs.append((img_c, alb_c))
        i += 1
    if sorted(map(str, fn_c.graph_keys())) != sorted(map(str, keys)):
        fail(f"path SM replayed {label}: captured {fn_c.graph_keys()}, "
             f"keys {keys}")
    rec = {"frames": i, "keys": len(keys),
           "replay_ms": float(np.median(t_c)), "eager_ms": float(np.median(t_e)),
           "replay_reps_ms": t_c, "eager_reps_ms": t_e,
           "capture_ms": float(np.median(t_cap))}
    print(f"path SM replayed {label}: {i} frames, {len(keys)} keys, words "
          f"equal to the eager sharded frames; replayed "
          f"{rec['replay_ms']:.3f} ms, eager {rec['eager_ms']:.3f} ms, "
          f"capture {rec['capture_ms']:.1f} ms")
    return rec, ("SM replayed", minimal.build_scene, cam, settings, outs,
                 carry_c)


def sm_replay_rank(rank, n, devices, store, out_dir):
    """One rank of the replayed path SM over NCCL (spawned): joins the
    process group, runs sm_replay_work, rank 0 then compares the replayed
    frames with the single card's, and writes its result to
    out_dir/rank<r>.json."""
    import datetime

    import torch.distributed as dist

    sys.path.insert(0, HERE)
    import hikari_tpu_torch as ht
    from hikari_tpu_torch.parallel import make_mesh

    dev = torch.device(devices[rank])
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", init_method="file://" + store,
                            rank=rank, world_size=n,
                            timeout=datetime.timedelta(seconds=SM_TIMEOUT_S))
    try:
        mesh = make_mesh(n)
        if mesh.device != dev:
            fail(f"rank {rank} on {mesh.device}, expected {dev}")
        result, run = sm_replay_work(ht, mesh)
        dist.barrier(device_ids=[dev.index])
    finally:
        dist.destroy_process_group()
    if rank == 0:
        compare_single_card(ht, [run], dev)
        result["single_card_equal"] = True
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(result, f)


def sharded_replay(ht, card):
    """Path SM replayed (sm_replay_rank, one spawned process a rank): over
    NCCL on every card when there are several; on a machine with one card
    path SM runs two gloo ranks, whose frames run eagerly by rule (gloo
    stages CUDA tensors through the host, which no graph can capture), so
    the sharded frame replays over a one-rank NCCL mesh on that card
    instead: its islands' NCCL all-gathers are captured, its halo exchange
    (none with one rank) only with two or more cards. Returns the SM
    replayed line's record."""
    import torch.multiprocessing as mp

    n, backend, devices = sharded_layout()
    if backend == "nccl":
        how = f"{n} ranks, one a card over NCCL: all-gathers and halo " \
              "exchanges captured"
    else:
        n, devices = 1, devices[:1]
        how = ("a one-rank NCCL mesh on the one card (path SM's two gloo "
               "ranks run eagerly by rule: gloo stages CUDA tensors through "
               "the host, which no graph can capture); its islands' NCCL "
               "all-gathers are captured, the halo exchange only with two "
               "or more cards")
    print(f"path SM replayed: {how}")
    out_dir = work_dir("sm_replay")
    os.makedirs(out_dir, exist_ok=True)
    t0 = time.perf_counter()
    mp.spawn(sm_replay_rank, args=(n, devices, work_dir("sm_replay_store"),
                                   out_dir), nprocs=n, join=True)
    res = []
    for r in range(n):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            res.append(json.load(f))
    if not res[0].get("single_card_equal"):
        fail("path SM replayed was not compared with the single card")
    rec = {"frame_ms_minimal_sharded_replayed": res[0]["replay_ms"],
           "frame_ms_minimal_sharded_eager": res[0]["eager_ms"],
           "replay_reps_ms": res[0]["replay_reps_ms"],
           "eager_reps_ms": res[0]["eager_reps_ms"],
           "capture_ms": res[0]["capture_ms"], "frames": res[0]["frames"],
           "keys": res[0]["keys"], "ranks": n, "devices": devices,
           "placement": how, "seconds": time.perf_counter() - t0,
           "card": card}
    print(f"path SM replayed: {rec['frames']} frames on every rank equal "
          "to the eager sharded frames and rank 0's to the single card's, "
          f"word for word; frame_ms_minimal_sharded replayed "
          f"{rec['frame_ms_minimal_sharded_replayed']:.3f} ms beside eager "
          f"{rec['frame_ms_minimal_sharded_eager']:.3f} ms ({n} ranks)")
    return rec


# ---------------------------------------------------------------------------
# the compiled frame: Renderer's captured CUDA graphs against its eager frame
# ---------------------------------------------------------------------------

# every single-card path; with --profile the replayed frames' device idle
# share of these
COMPILED_PATHS = ("no-reuse", "R", "S", "P", "D", "K", "KR", "city", "CL",
                  "T", "TN", "F", "M", "G")
PROFILED_COMPILED = ("D", "city", "F")
# at least this many frames without a capture are timed on each path
COMPILED_TIMED = 8
# the camera's sideways motion per frame in world units, off the box
COMPILED_PAN = 0.02


def panned(ht, eye, target, size, i, step, hdr=False):
    """Camera.from_look_at(eye, target) moved sideways by i * step."""
    d = np.array([step * i, 0.0, 0.0])
    return ht.Camera.from_look_at(tuple(np.add(eye, d)),
                                  tuple(np.add(target, d)), width=size[1],
                                  height=size[0], hdr=hdr)


def compiled_case(ht, build_box, name):
    """Path `name` at FULL for the compiled check: (make() -> (a fresh
    Renderer, its own host scene), camera(i), step(renderer, host scene,
    i) run before frame i or None, launches(settings, number)). Each
    renderer moves a host scene of its own: city.rotate_sphere moves the
    scene it is given in place."""
    from hikari_tpu_torch.examples import city, cornell, minimal, scene
    from hikari_tpu_torch.examples import simple
    from hikari_tpu_torch.ops.bloom import BloomSettings

    if name in PATHS:
        box = load_box_module()
        settings_of, launches = PATHS[name]
        step = PAN_PX * 2.0 * 3.2 * np.tan(np.pi / 8.0) / FULL[0]
        return (lambda: (ht.Renderer(build_box(), panned(
                    ht, box.EYE, box.TARGET, FULL, 0, step),
                    settings_of(ht)), None),
                lambda i: panned(ht, box.EYE, box.TARGET, FULL, i, step),
                None, launches)
    if name in ("city", "CL"):
        kw = (dict(bloom_settings=BloomSettings()) if name == "CL"
              else {})

        def cam(i):
            return panned(ht, CITY_EYE, CITY_TARGET, FULL, i, COMPILED_PAN,
                          hdr=True)

        def make():
            sc = city.build_scene(3) if name == "city" else lamps_scene()
            return ht.Renderer(sc, cam(0), ht.HikariSettings(), **kw), sc

        def step(r, sc, i):
            r.update_scene(city.rotate_sphere(sc, city_angle(i)), fast=True)

        return (make, cam, step,
                city_launches if name == "city" else cl_launches)
    mods = {"T": (simple, simple_settings(ht), simple_launches),
            "TN": (simple, flagship_settings(ht), simple_noreuse_launches),
            "F": (scene, scene.settings(), scene_launches),
            "M": (minimal, minimal.settings(), minimal_launches),
            "G": (cornell, cornell.settings(), PATHS["D"][1])}
    mod, settings, launches = mods[name]
    sc = simple_scene() if name in ("T", "TN") else mod.build_scene()

    def cam(i):
        return panned(ht, mod.EYE, mod.TARGET, FULL, i, COMPILED_PAN)

    return (lambda: (ht.Renderer(sc, cam(0), settings), None), cam, None,
            launches)


def compiled_frames(r, times=2):
    """The fewest frames 0.. in which every key of r's frame program
    comes at least `times` times (its keys repeat every 30 frames at
    most: the parity, the validate intervals 3 and 5), and the number of
    keys."""
    period = 2 * r.settings.direct_validate_interval \
        * r.settings.emissive_validate_interval
    keys = {r.frame_key(n) for n in range(period)}
    seen, n = {}, 0
    while any(seen.get(k, 0) < times for k in keys):
        k = r.frame_key(n)
        seen[k] = seen.get(k, 0) + 1
        n += 1
    return n, len(keys)


class CaptureCounts:
    """Entered around each capture (compiled.Graphs.capture_context): the
    launch counts of COUNTERS that the capture made, in capture order."""

    def __init__(self):
        self.wrappers = counter_wrappers()
        self.counts = []

    def __call__(self):
        return self

    def __enter__(self):
        self.before = [fn.launches for fn in self.wrappers]
        return self

    def __exit__(self, *exc):
        self.counts.append([fn.launches - b for fn, b in
                            zip(self.wrappers, self.before)])


def iqr(times):
    q1, q3 = np.percentile(times, [25, 75])
    return float(q3 - q1)


def compiled_path(ht, build_box, name, profile):
    """Path `name` from one fresh state twice in lockstep, eagerly (inside
    compiled.eager()) and replayed (Renderer's default on CUDA), the
    camera panning and, on the city and CL, update_scene(fast=True)
    before every frame (the device refit, its own graph; the host refit):
    over compiled_frames() frames the image, the albedo and every carry
    tensor equal word for word (NaNs as words); each frame key's capture
    launches exactly the path's launches of its frame number; a replayed
    frame launches nothing from Python. Returns the path's record: keys,
    frames, eager and replayed frame medians and IQRs (frames without a
    capture), capture times, and with --profile the replayed frames'
    device time and idle share."""
    make, cam, step, launches = compiled_case(ht, build_box, name)
    (r_e, sc_e), (r_c, sc_c) = make(), make()
    frames, n_keys = compiled_frames(r_c)
    frames = max(frames, n_keys + COMPILED_TIMED)
    counts = CaptureCounts()
    r_c._graphs.capture_context = counts
    wrappers = counts.wrappers
    t_eager, t_replay, t_capture, keys = [], [], [], []
    # host time to return from update_scene + render_frame, unsynchronized
    h_eager, h_replay = [], []
    for i in range(frames):
        r_e.camera = r_c.camera = cam(i)
        t = time.perf_counter()
        with ht.renderer.eager():
            if step is not None:
                step(r_e, sc_e, i)
            img_e = r_e.render_frame()
        he = (time.perf_counter() - t) * 1e3
        torch.cuda.synchronize()
        dt_e = (time.perf_counter() - t) * 1e3
        before = r_c.graph_keys()
        for fn in wrappers:
            fn.launches = 0
        t = time.perf_counter()
        if step is not None:
            step(r_c, sc_c, i)
        img_c = r_c.render_frame()
        hc = (time.perf_counter() - t) * 1e3
        torch.cuda.synchronize()
        dt_c = (time.perf_counter() - t) * 1e3
        new = r_c.graph_keys()[len(before):]
        caps, counts.counts = counts.counts, []
        for key, got in zip(new, caps):
            need = ([0] * len(COUNTERS) if key == "refit"
                    else list(launches(r_c.settings, i)))
            if got != need:
                fail(f"compiled {name}: the capture of {key} at frame {i} "
                     f"launched {got}, need {need}")
            keys.append((i, key))
        if not new and any(fn.launches for fn in wrappers):
            fail(f"compiled {name}: replayed frame {i} launched "
                 f"{[fn.launches for fn in wrappers]} from Python")
        if new:
            t_capture.append(dt_c)
        else:
            t_eager.append(dt_e)
            t_replay.append(dt_c)
            h_eager.append(he)
            h_replay.append(hc)
        pairs = [("image", img_e, img_c), ("albedo", r_e.albedo, r_c.albedo)]
        ce, cc = carry_leaves(r_e.carry), carry_leaves(r_c.carry)
        if set(ce) != set(cc):
            fail(f"compiled {name}: carries of other keys")
        pairs += [(f"carry {k}", ce[k], cc[k]) for k in ce]
        for what, a, b in pairs:
            if not same_words(a, b):
                fail(f"compiled {name}: frame {i} {what} differs from the "
                     "eager frame's words")
    frame_keys = [k for _, k in keys if k != "refit"]
    if len(frame_keys) != n_keys or len(set(frame_keys)) != n_keys:
        fail(f"compiled {name}: captured {frame_keys}, {n_keys} keys")
    rec = {"path": name, "keys": n_keys, "frames": frames,
           "graphs": [str(k) for _, k in keys],
           "eager_ms": float(np.median(t_eager)), "eager_iqr_ms": iqr(t_eager),
           "replay_ms": float(np.median(t_replay)),
           "replay_iqr_ms": iqr(t_replay), "timed_frames": len(t_replay),
           "eager_host_ms": float(np.median(h_eager)),
           "replay_host_ms": float(np.median(h_replay)),
           "capture_ms": float(np.median(t_capture))}
    if profile and name in PROFILED_COMPILED:
        f = frames

        def replayed():
            nonlocal f
            r_c.camera = cam(f)
            if step is not None:
                step(r_c, sc_c, f)
            f += 1
            return r_c.render_frame()

        device_ms, kernels = device_total_ms(replayed, reps=4)
        rec.update(replay_device_ms=device_ms, replay_device_kernels=kernels,
                   replay_idle_share=1.0 - device_ms / rec["replay_ms"])
    print(f"compiled {name}: {frames} frames, {n_keys} keys, words equal "
          f"to the eager frames; eager {rec['eager_ms']:.3f} ms (IQR "
          f"{rec['eager_iqr_ms']:.3f}), replayed {rec['replay_ms']:.3f} ms "
          f"(IQR {rec['replay_iqr_ms']:.3f}) over {len(t_replay)} frames, "
          f"host {rec['eager_host_ms']:.3f} / {rec['replay_host_ms']:.3f} "
          f"ms a frame, capture {rec['capture_ms']:.1f} ms"
          + (f", replayed device {rec['replay_device_ms']:.3f} ms, idle "
             f"{rec['replay_idle_share']:.3f}" if "replay_device_ms" in rec
             else ""))
    del r_e, r_c
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return rec


def replay_equal(name, i, r_e, r_c, out_e, out_c):
    """Fails unless frame i's outputs of the eager renderer r_e and the
    replayed r_c hold the same words: the image (or a dissection's planes
    and final image), the albedo and every carry tensor."""
    if isinstance(out_e, dict):
        pairs = [(f"plane {k}", torch.from_numpy(np.ascontiguousarray(v)),
                  torch.from_numpy(np.ascontiguousarray(out_c[k])))
                 for k, v in out_e.items()]
        if set(out_e) != set(out_c):
            fail(f"{name}: frame {i} planes {sorted(out_c)}, eager "
                 f"{sorted(out_e)}")
    else:
        pairs = [("image", out_e, out_c), ("albedo", r_e.albedo, r_c.albedo)]
    ce, cc = carry_leaves(r_e.carry), carry_leaves(r_c.carry)
    if set(ce) != set(cc):
        fail(f"{name}: carries of other keys")
    pairs += [(f"carry {k}", ce[k], cc[k]) for k in ce]
    for what, a, b in pairs:
        if not same_words(a, b):
            fail(f"{name}: frame {i} {what} differs from the eager frame's "
                 "words")


def lockstep_frame(name, pair, cam, step, i, render="render_frame"):
    """Frame i of a (eager, replayed) pair of (renderer, host scene): the
    camera cam(i), step(renderer, host scene, i) first (if any), then
    `render` on the first inside compiled.eager() and on the second
    replayed; their words equal (replay_equal). Returns (eager ms,
    replayed ms, the keys the replayed frame captured)."""
    import hikari_tpu_torch as ht

    (r_e, sc_e), (r_c, sc_c) = pair
    r_e.camera = r_c.camera = cam(i)
    t = time.perf_counter()
    with ht.renderer.eager():
        if step is not None:
            step(r_e, sc_e, i)
        out_e = getattr(r_e, render)()
    torch.cuda.synchronize()
    dt_e = (time.perf_counter() - t) * 1e3
    before = len(r_c.graph_keys())
    t = time.perf_counter()
    if step is not None:
        step(r_c, sc_c, i)
    out_c = getattr(r_c, render)()
    torch.cuda.synchronize()
    dt_c = (time.perf_counter() - t) * 1e3
    replay_equal(name, i, r_e, r_c, out_e, out_c)
    return dt_e, dt_c, r_c.graph_keys()[before:]


# the retune phase: each dynamic field in turn (both validation intervals
# so that old and new keys cross), applied to both renderers before a
# frame, RETUNE_FRAMES frames apart, after every key of the old intervals
# has been captured
RETUNES = (("emissive_validate_interval", 3), ("direct_validate_interval", 2),
           ("solar_angle", 0.2), ("max_indirect_luminance", 2.0),
           ("clear_color", (0.1, 0.2, 0.3, 1.0)),
           ("max_temporal_reuse_count", 20), ("max_spatial_reuse_count", 300),
           ("max_reservoir_lifetime", 4.0))
RETUNE_FRAMES = 2
# the paths retuned: D (the fused kernels) and the city (the modular path,
# a sun and emissives: both intervals pick branches)
RETUNED_PATHS = ("D", "city")


def retune_path(ht, build_box, name):
    """Path `name` eager and replayed in lockstep (lockstep_frame) until
    every key of its frame program has been captured, then each field of
    RETUNES retuned by update_settings on both renderers with
    RETUNE_FRAMES frames after it: every frame's words equal; each retune
    keeps the frame index, the carry's tensors and every captured graph,
    and captures no key that was already captured. Returns the record:
    frames, keys, captures after the retunes, the median of the first
    replayed frame after each retune beside the median capture and
    replayed frame."""
    make, cam, step, _ = compiled_case(ht, build_box, name)
    pair = (make(), make())
    r_c = pair[1][0]
    first, n_keys = compiled_frames(r_c, times=1)
    t_capture, t_replay, t_retuned, late = [], [], [], []
    for i in range(first):
        _, dt, new = lockstep_frame(f"retune {name}", pair, cam, step, i)
        (t_capture if new else t_replay).append(dt)
    captured = r_c.graph_keys()
    i = first
    for field, value in RETUNES:
        index = r_c._frame_index
        ptrs = {k: v.data_ptr() for k, v in carry_leaves(r_c.carry).items()}
        keys = r_c.graph_keys()
        for r, _ in pair:
            r.update_settings(**{field: value})
        if (r_c._frame_index != index or r_c.graph_keys() != keys
                or {k: v.data_ptr() for k, v in carry_leaves(
                    r_c.carry).items()} != ptrs):
            fail(f"retune {name}: update_settings({field}=...) dropped the "
                 "graphs, the carry or the frame index")
        for j in range(RETUNE_FRAMES):
            _, dt, new = lockstep_frame(f"retune {name} ({field})", pair,
                                        cam, step, i)
            stale = [k for k in new if k in captured]
            if stale:
                fail(f"retune {name}: frame {i} captured {stale} again")
            late += [str(k) for k in new]
            (t_retuned if j == 0 else t_replay).append(dt)
            i += 1
    rec = {"path": name, "frames": i, "keys": n_keys,
           "retuned": [f for f, _ in RETUNES],
           "captures_after_retunes": late,
           "retuned_ms": float(np.median(t_retuned)),
           "retuned_reps_ms": t_retuned,
           "replay_ms": float(np.median(t_replay)),
           "capture_ms": float(np.median(t_capture))}
    print(f"compiled retune {name}: {i} frames, {n_keys} keys captured "
          f"before the retunes of {', '.join(rec['retuned'])}; every frame "
          f"equal to the eager frame word for word; {len(late)} captures "
          f"after the retunes {late}; retuned frame {rec['retuned_ms']:.3f} "
          f"ms (replayed {rec['replay_ms']:.3f}, capture "
          f"{rec['capture_ms']:.1f})")
    del pair, r_c
    torch.cuda.empty_cache()
    return rec


def untimed_cases(ht, build_box):
    """The settings of the untimed checks, for replaying: [(name, make()
    -> ((renderer, None), (renderer, None)) factory, camera(i))]: the box's
    upscale settings (box_upscale_cases), the city without temporal reuse,
    the box with the tap scramble, check U's city at brute_force_max=4096
    (960x540, universal-off) and box at brute_force_max=0, and the box at
    HikariSettings() with FXAA."""
    from hikari_tpu_torch.examples import city

    box = load_box_module()
    cases = []

    def box_case(name, settings, size, **kw):
        step = PAN_PX * 2.0 * 3.2 * np.tan(np.pi / 8.0) / size[0]
        cases.append((name, lambda: ht.Renderer(build_box(), panned(
            ht, box.EYE, box.TARGET, size, 0, step), settings, **kw),
            lambda i: panned(ht, box.EYE, box.TARGET, size, i, step)))

    for name, (settings, size, _) in box_upscale_cases(ht).items():
        box_case(name, settings, size)
    cases.append((
        "city no temporal reuse",
        lambda: ht.Renderer(city.build_scene(3), city_camera(ht, FULL),
                            dataclasses.replace(ht.HikariSettings(),
                                                temporal_reuse=False)),
        lambda i: panned(ht, CITY_EYE, CITY_TARGET, FULL, i, COMPILED_PAN,
                         hdr=True)))
    box_case("scramble", dataclasses.replace(ht.HikariSettings(),
                                             spatial_tap_scramble=True), FULL)
    uni = ht.HikariUniversalSettings(build_mesh_acceleration_structure=False)
    cases.append((
        "U brute_force_max=4096",
        lambda: ht.Renderer(city.build_scene(3).compile(uni),
                            city_camera(ht, U_SIZE), ht.HikariSettings(),
                            brute_force_max=4096),
        lambda i: panned(ht, CITY_EYE, CITY_TARGET, U_SIZE, i, COMPILED_PAN,
                         hdr=True)))
    box_case("U brute_force_max=0", ht.HikariSettings(), FULL,
             brute_force_max=0)
    box_case("FXAA", ht.HikariSettings(), FULL, fxaa=True)
    return cases


def untimed_replays(ht, build_box):
    """Each of untimed_cases eager and replayed in lockstep until every
    key has come once, then 2 frames more: every frame's words equal.
    Returns {name: [frames, keys]}."""
    out = {}
    for name, make, cam in untimed_cases(ht, build_box):
        pair = ((make(), None), (make(), None))
        frames, n_keys = compiled_frames(pair[1][0], times=1)
        for i in range(frames + 2):
            lockstep_frame(f"replayed {name}", pair, cam, None, i)
        out[name] = [frames + 2, n_keys]
        print(f"compiled {name}: {frames + 2} frames, {n_keys} keys, words "
              "equal to the eager frames")
        del pair
        torch.cuda.empty_cache()
    return out


def dissection_replay(ht, build_box):
    """Path G's render_dissection eager and replayed in lockstep until
    every key of its debug frame has come twice: every dissection's planes,
    final image and carry equal word for word. Returns the record: the
    eager and replayed dissection_ms medians (dissections without a
    capture) and the capture times."""
    make, cam, _, _ = compiled_case(ht, build_box, "G")
    pair = (make(), make())
    frames, n_keys = compiled_frames(pair[1][0])
    t_e, t_c, t_cap = [], [], []
    for i in range(frames):
        de, dc, new = lockstep_frame("dissection G", pair, cam, None, i,
                                     render="render_dissection")
        if new:
            t_cap.append(dc)
        else:
            t_e.append(de)
            t_c.append(dc)
    rec = {"frames": frames, "keys": n_keys,
           "graphs": [str(k) for k in pair[1][0].graph_keys()],
           "dissection_ms_eager": float(np.median(t_e)),
           "dissection_ms_replayed": float(np.median(t_c)),
           "eager_reps_ms": t_e, "replayed_reps_ms": t_c,
           "capture_ms": float(np.median(t_cap))}
    print(f"compiled dissection G: {frames} dissections, {n_keys} keys, "
          f"planes and carry equal to the eager ones word for word; "
          f"dissection_ms replayed {rec['dissection_ms_replayed']:.2f} "
          f"beside eager {rec['dissection_ms_eager']:.2f} (capture "
          f"{rec['capture_ms']:.1f})")
    del pair
    torch.cuda.empty_cache()
    return rec



def compiled_check(ht, build_box, card, profile):
    """compiled_path over COMPILED_PATHS, retune_path over RETUNED_PATHS,
    untimed_replays, dissection_replay and sharded_replay (path SM
    replayed); prints and returns their records."""
    t0 = time.perf_counter()
    recs = [compiled_path(ht, build_box, name, profile)
            for name in COMPILED_PATHS]
    retunes = [retune_path(ht, build_box, name) for name in RETUNED_PATHS]
    untimed = untimed_replays(ht, build_box)
    dissection = dissection_replay(ht, build_box)
    sharded = sharded_replay(ht, card)
    out = {"compiled_frame": recs, "retune": retunes, "untimed": untimed,
           "dissection": dissection, "sharded": sharded, "card": card,
           "seconds": time.perf_counter() - t0}
    print(json.dumps(out))
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also print device time by kernel over 2 frames "
                    "of each path")
    ap.add_argument("--ab", action="store_true",
                    help="only time the frames of paths P and D "
                    "(alternately), no-reuse, R, S, K, KR, the city, CL, T "
                    "and M, then "
                    "check and time kernels 8, C, 11 and 12 on path D's "
                    "calls, 4 and B on R's, S's, D's, the no-reuse "
                    "frame's, P's and K's, 9 on R's, S's, D's, KR's and "
                    "the city's, 14 on T's, A on the no-reuse frame's and "
                    "D's, "
                    "10 on S's and D's, 13 on the city's, 5, 6 and 7 on "
                    "KR's (to time two trees "
                    "of the repository in one call); prints their records "
                    "and no ok line")
    ap.add_argument("--sharded", action="store_true",
                    help="only build the kernels and run path SM and check "
                    "SB (the row-sharded frame over every card), then path "
                    "SM replayed; prints their lines and no ok line")
    ap.add_argument("--compiled", action="store_true",
                    help="only build the kernels and run the compiled-frame "
                    "check (every single-card path's replayed frames against "
                    "its eager frames, the retunes, the untimed settings, "
                    "the dissection and path SM replayed); prints its line "
                    "and no ok line")
    ap.add_argument("--ab-summary", nargs="+", metavar="FILE",
                    help="summarise the --ab lines of FILEs, one per tree "
                    "(medians, interquartile ranges; runs on any host)")
    args = ap.parse_args()
    if args.ab_summary:
        ab_summary(args.ab_summary)
        return 0
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import shutil
    import tempfile

    WORK["dir"] = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        return run(args)
    finally:
        shutil.rmtree(WORK["dir"], ignore_errors=True)


def run(args):
    """main() on a machine with CUDA, WORK["dir"] made."""
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

    instances = light_instances()
    instances_a10 = {name: kernel_instances(name)
                     for name in ("prepass_fused", "spatial_fused",
                                  "trace_bvh", "trace")}
    write_cornell_asset()
    if args.sharded:
        print(json.dumps(sharded_path(ht, card)[0]))
        print(json.dumps(sharded_replay(ht, card)))
        return 0
    if args.compiled:
        compiled_check(ht, build_box, card, args.profile)
        return 0
    if args.ab:
        with ht.renderer.eager():
            records, frames = ab_only(ht, build_box)
        print(json.dumps({"ab": list(records), "frames_ms": frames,
                          "light_instances": instances,
                          "kernel_instances": instances_a10, "card": card}))
        return 0
    # the checks and the timed paths hold the kernels' calls against their
    # plain versions and count their launches: their frames run eagerly
    # (compiled_check holds the replayed frames against these)
    with ht.renderer.eager():
        t0 = time.perf_counter()
        # path T's checks first: kernel 14's host time before any profiler
        # session of the process (the host reads slower after one)
        records = [check_textures(ht)]
        records += check_kernels(ht, build_box())
        records += check_reuse(ht, build_box)
        post_records, at_540p = check_post(ht, build_box)
        records += post_records
        ckb_records, at_ckb = check_checkerboard(ht, build_box)
        records += ckb_records
        city_records, hit_record, at_city = check_city(ht, build_box)
        records += city_records
        check_simple_walk(ht)
        at_scene = check_scene(ht)
        at_tn = check_simple_noreuse(ht)
        check_box_upscale(ht, build_box)
        check_city_spatial_noreuse(ht)
        check_box_scramble(ht, build_box)
        at_cl = check_city_lamps(ht)
        check_minimal(ht)
        u_records = check_universal(ht, build_box)
        for rec in records + [hit_record]:
            for extra in (at_540p, at_ckb, at_city, at_scene, at_tn, at_cl):
                rec.update(extra.get(rec["name"], {}))
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
            launches[name] = dict(zip(COUNTERS, counts))
        times, refit, counts = city_path(ht, TIMED_FRAMES, args.profile)
        frame_ms["city"] = (float(np.median(times)), times)
        launches["city"] = dict(zip(COUNTERS, counts))
        times, cl_refit, counts, cl_extra = city_lamps_path(ht, TIMED_FRAMES,
                                                            args.profile)
        frame_ms["CL"] = (float(np.median(times)), times)
        launches["CL"] = dict(zip(COUNTERS, counts))
        times, counts = simple_path(ht, TIMED_FRAMES, args.profile)
        frame_ms["T"] = (float(np.median(times)), times)
        launches["T"] = dict(zip(COUNTERS, counts))
        times, counts = simple_path(ht, TIMED_FRAMES, args.profile,
                                    noreuse=True)
        frame_ms["TN"] = (float(np.median(times)), times)
        launches["TN"] = dict(zip(COUNTERS, counts))
        times, counts, fsr = scene_path(ht, TIMED_FRAMES, args.profile)
        frame_ms["F"] = (float(np.median(times)), times)
        launches["F"] = dict(zip(COUNTERS, counts))
        times, counts = minimal_path(ht, TIMED_FRAMES, args.profile)
        frame_ms["M"] = (float(np.median(times)), times)
        launches["M"] = dict(zip(COUNTERS, counts))
        times, counts, dissection = cornell_path(ht, TIMED_FRAMES,
                                                 args.profile)
        frame_ms["G"] = (float(np.median(times)), times)
        launches["G"] = dict(zip(COUNTERS, counts))
        alt_ms, alt_times = alternate_post_paths(ht, build_box, TIMED_FRAMES)
        sm_record, sm_counts = sharded_path(ht, card)
        launches["SM"] = dict(zip(COUNTERS, sm_counts))

    compiled = compiled_check(ht, build_box, card, args.profile)

    def total(counter, paths=tuple(launches)):
        return sum(launches[p][counter] for p in paths)

    # launches over the timed frames of the paths running each kernel:
    # B runs on no-reuse, P and K, kernel 4 on R, S, D, M, G and SM (every
    # rank's), 13 on the city, CL, T, TN and F, 14 on T and TN
    by_name = {
        "prepass_fused": total("prepass"),
        "light_fused": total("lighting", ("no-reuse", "P", "K")),
        "denoise_fused": total("a-trous"),
        "reproj_gather": total("gather"),
        "light_fused_temporal": total("lighting",
                                      ("R", "S", "D", "M", "G", "SM")),
        "spatial_fused": total("spatial"),
        "prepass_quads": total("quads"),
        "warp_band": total("warp_band"),
        "warp_multi": total("warp_multi"),
        "trace_closest": total("trace_closest"),
        "trace_full": total("trace_full"),
        "trace_shadow": total("trace_shadow"),
        "trace_bvh_full": total("bvh_full"),
        "trace_bvh_shadow": total("bvh_shadow"),
        "texture": total("sample_atlas")}
    for rec in records:
        rec["launches"] = by_name[rec["name"]]

    rays = FULL[0] * FULL[1] * (1 + 1 + 2 + 3)
    m = frame_ms["no-reuse"][0]
    print(json.dumps({
        "frame_ms_1080p": m, "mrays_per_s": rays / m / 1e3,
        "frames": TIMED_FRAMES, "reps_ms": frame_ms["no-reuse"][1],
        "card": card}))
    for key, name in (("frame_ms_reuse", "R"), ("frame_ms_spatial", "S"),
                      ("frame_ms_smaa2", "P"), ("frame_ms_default", "D"),
                      ("frame_ms_ckb", "K"), ("frame_ms_ckb_reuse", "KR")):
        print(json.dumps({key: frame_ms[name][0],
                          "reps_ms": frame_ms[name][1], "card": card}))
    print(json.dumps({
        "frame_ms_city": frame_ms["city"][0],
        "city_refit_ms": float(np.median(refit)), "city_instances": 122,
        "city_triangles": 2618, "reps_ms": frame_ms["city"][1],
        "refit_reps_ms": refit, "card": card}))
    print(json.dumps({
        "frame_ms_city_lamps": frame_ms["CL"][0],
        "city_lamps_refit_ms": float(np.median(cl_refit)),
        "city_lamps_instances": 154, "city_lamps_triangles": 3002,
        "city_lamps_emissives": 17, "reps_ms": frame_ms["CL"][1],
        "refit_reps_ms": cl_refit, "profile": cl_extra, "card": card}))
    print(json.dumps({
        "frame_ms_simple": frame_ms["T"][0], "simple_triangles": 2510,
        "reps_ms": frame_ms["T"][1], "card": card}))
    print(json.dumps({
        "frame_ms_simple_noreuse": frame_ms["TN"][0],
        "simple_triangles": 2510, "reps_ms": frame_ms["TN"][1],
        "card": card}))
    print(json.dumps({
        "frame_ms_scene": frame_ms["F"][0], "scene_triangles": 1226,
        "reps_ms": frame_ms["F"][1], "fsr": fsr, "card": card}))
    print(json.dumps({
        "frame_ms_minimal": frame_ms["M"][0], "minimal_triangles": 14,
        "reps_ms": frame_ms["M"][1], "launches": launches["M"],
        "card": card}))
    print(json.dumps({
        "frame_ms_cornell": frame_ms["G"][0], "cornell_triangles": 36,
        "reps_ms": frame_ms["G"][1],
        "dissection_ms": float(np.median(dissection)),
        "dissection_reps_ms": dissection, "card": card}))
    print(json.dumps({
        "frame_ms_smaa2_alternating": alt_ms["P"],
        "frame_ms_default_alternating": alt_ms["D"],
        "reps_ms_smaa2": alt_times["P"], "reps_ms_default": alt_times["D"],
        "card": card}))
    print(json.dumps(sm_record))
    # the compiled check's medians again, near the end of the output
    cols = ("keys", "eager_ms", "replay_ms", "replay_host_ms")
    print(json.dumps({"compiled_frame_ms": {
        rec["path"]: [rec[c] for c in cols]
        for rec in compiled["compiled_frame"]}, "columns": cols,
        "card": card}))
    print(json.dumps({
        "retuned_frame_ms": {rec["path"]: [rec["retuned_ms"],
                                           rec["capture_ms"]]
                             for rec in compiled["retune"]},
        "retuned_columns": ("retuned_ms", "capture_ms"),
        "dissection_ms_replayed":
            compiled["dissection"]["dissection_ms_replayed"],
        "dissection_ms_eager": compiled["dissection"]["dissection_ms_eager"],
        "frame_ms_minimal_sharded_replayed":
            compiled["sharded"]["frame_ms_minimal_sharded_replayed"],
        "sharded_replayed_ranks": compiled["sharded"]["ranks"],
        "card": card}))
    print(json.dumps({"kernel_off_path": hit_record}))
    print(json.dumps({"light_instances": instances,
                      "kernel_instances": instances_a10}))
    print(json.dumps({"kernels": records + u_records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
