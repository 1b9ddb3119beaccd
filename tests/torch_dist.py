"""Row-sharded runs of the port on the CPU: gloo ranks spawned with
torch.multiprocessing, the process group made from a FileStore (no port),
and the rank functions the tests of hikari_tpu_torch/parallel/ run. Imports
no JAX: with the spawn start method each child imports this module again.

    results = run_ranks("frames", 4, tmp_dir, configs)

runs frames(mesh, configs) on every rank and returns each rank's result
(rank order), each written with torch.save to `tmp_dir`.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

SCENE_EYE, SCENE_TARGET = (-2.0, 2.5, 5.0), (0.0, 0.0, 0.0)


def _entry(rank, n, tmp_dir, name, args):
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method="file://" + os.path.join(tmp_dir, "store"),
        rank=rank, world_size=n)
    try:
        from hikari_tpu_torch.parallel import make_mesh

        mesh = make_mesh(n, device="cpu")
        out = globals()[name](mesh, *args)
        torch.save(out, os.path.join(tmp_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def start_ranks(name, n, tmp_dir, *args):
    """Spawns n gloo ranks running `name`(mesh, *args); returns the
    context to pass to `join_ranks` (the caller works meanwhile)."""
    tmp_dir = str(tmp_dir)
    os.makedirs(tmp_dir, exist_ok=True)
    return mp.spawn(_entry, args=(n, tmp_dir, name, args), nprocs=n,
                    join=False), n, tmp_dir


def join_ranks(started):
    """Waits for the ranks of start_ranks; returns their results."""
    ctx, n, tmp_dir = started
    while not ctx.join():
        pass
    return [torch.load(os.path.join(tmp_dir, f"rank{r}.pt"),
                       weights_only=False) for r in range(n)]


def run_ranks(name, n, tmp_dir, *args):
    return join_ranks(start_ranks(name, n, tmp_dir, *args))


# ---------------------------------------------------------------- shards


def halo_pad(mesh, x, y, mult):
    """halo_rows of this rank's block of x's rows (x: numpy [n * hl, a, b]):
    2 rows up and 3 down at both edges, and along axis 1 of its transpose;
    and pad_rows_to of y (numpy) to a multiple of `mult` rows in both
    modes."""
    from hikari_tpu_torch.parallel import shard as sh

    blk = sh.local_rows(torch.from_numpy(x), mesh, x.shape[0] // mesh.n)
    rows = -(-y.shape[0] // mult) * mult
    t = torch.from_numpy(y)
    return {"zero": sh.halo_rows(blk, 2, 3, mesh).numpy(),
            "replicate": sh.halo_rows(blk, 2, 3, mesh,
                                      edge="replicate").numpy(),
            "axis1": sh.halo_rows(blk.transpose(0, 1), 2, 3, mesh,
                                  axis=1).numpy(),
            "edge": sh.pad_rows_to(t, rows, mode="edge")[0].numpy(),
            "constant": sh.pad_rows_to(t, rows, value=-1.0)[0].numpy()}


# ---------------------------------------------------------------- islands


def _gen(seed):
    return np.random.default_rng(seed)


def _words(a, b):
    """Whether two tensors (or lists / dicts of them) hold the same
    words."""
    if isinstance(a, dict):
        return set(a) == set(b) and all(_words(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_words(x, y) for x, y in zip(a, b))
    return (a.shape == b.shape and a.dtype == b.dtype
            and torch.equal(a.contiguous().view(torch.uint8),
                            b.contiguous().view(torch.uint8)))


def minimal_box():
    from hikari_tpu_torch.examples.minimal import build_scene

    return build_scene().compile()


def _camera(size):
    from hikari_tpu_torch import Camera

    return Camera.from_look_at(SCENE_EYE, SCENE_TARGET, width=size[1],
                               height=size[0])


def islands(mesh, cases):
    """Each island of `cases` against the whole call of the same plain
    version on the same inputs (made from a seed on every rank): {case:
    True where every output word is equal}."""
    from hikari_tpu_torch.parallel import shard as sh

    out = {}
    for case in cases:
        whole, sharded = ISLANDS[case]()
        with sh.row_mesh(mesh):
            got = sharded()
        out[case] = _words(got, whole())
    return out


def _prepass_case(size, parity):
    from hikari_tpu_torch.camera import view_to_device
    from hikari_tpu_torch.ops import prepass_fused as pf

    gpu = minimal_box()
    scene = gpu.as_pytree("cpu")
    view = view_to_device(_camera(size).view_uniform(), "cpu")
    prev = {"view_proj": view["view_proj"] * 1.001,
            "inverse_view_proj": view["inverse_view_proj"]}

    def run(mesh=None):
        return pf.prepass_fused(scene, view, prev, (0.25, -0.375), size,
                                dec_parity=parity, mesh=mesh)

    def quads(mesh=None):
        gbuf = run(mesh)[0]
        return pf.prepass_fused_quads(gbuf, mesh=mesh)

    return run, quads


def _case_prepass(parity):
    def case():
        run, quads = _prepass_case((26, 36), parity)
        from hikari_tpu_torch.parallel import shard as sh

        return ((lambda: (run(), quads())),
                lambda: (run(sh.active_mesh()), quads(sh.active_mesh())))
    return case


def _lighting_inputs(size, temporal):
    """Kernel B / 4's inputs on the minimal scene: its G-buffer from the
    plain prepass, seeded blue noise and (temporal) seeded previous
    reservoirs of the sun's and the indirect channels."""
    from hikari_tpu_torch.camera import view_to_device
    from hikari_tpu_torch.config import HikariSettings, make_frame_uniform
    from hikari_tpu_torch.ops import prepass_fused as pf
    from hikari_tpu_torch.ops import reservoir as rsv

    gpu = minimal_box()
    scene = gpu.as_pytree("cpu")
    view = view_to_device(_camera(size).view_uniform(), "cpu")
    g, _ = pf.prepass_fused(scene, view, view, (0.0, 0.0), size)
    gen = _gen(5)
    rand = torch.from_numpy(gen.random(size + (4,), np.float32))
    settings = HikariSettings(temporal_reuse=temporal)
    frame = make_frame_uniform(settings, 5)
    prev = []
    if temporal:
        for _ in range(2):
            r = rsv.empty_reservoir(size, "cpu")
            r = {k: v for k, v in r.items()}
            r["count"] = torch.from_numpy(
                gen.integers(0, 8, size).astype(np.float32))
            r["w"] = torch.from_numpy(gen.random(size, np.float32))
            prev.append(rsv.pack_reservoir_planes(r))
    return scene, g, view, frame, rand, prev


def _case_lighting(temporal):
    def case():
        from hikari_tpu_torch.ops import light_fused as lf

        size = (22, 30)
        scene, g, view, frame, rand, prev = _lighting_inputs(size, temporal)

        def run():
            return lf.fused_lighting(
                scene, g, view, frame, rand, has_sun=True, num_emissives=0,
                bounces=1, render_size=size, temporal=temporal,
                prev_planes=prev)
        return run, run
    return case


def _case_denoise():
    """test_parallel.py's flat geometry at 42 rows (4 ranks do not divide
    them), three channels, the last two with the firefly clamp."""
    from hikari_tpu_torch.ops.denoise import STEPS
    from hikari_tpu_torch.ops.denoise_fused import denoise_levels_fused

    h, w, nch = 42, 64, 3
    gen = _gen(11)
    normal = torch.zeros((h, w, 3))
    normal[..., 2] = 1.0
    depth = (0.5 + 0.001 * torch.arange(h, dtype=torch.float32))[:, None] \
        .expand(h, w).contiguous()
    grad = torch.full((h, w, 2), 0.001)
    inst = torch.full((h, w), 2.5)
    irrs = [torch.from_numpy(gen.uniform(0.0, 3.0, (h, w, 3)).astype(
        np.float32)) for _ in range(nch)]
    irrs[1][5, 7] = float("inf")
    irrs[2][30, 40] = 1e4
    variances = [torch.from_numpy(gen.uniform(0.0, 0.5, (h, w)).astype(
        np.float32)) for _ in range(nch)]
    ffs = [c > 0 for c in range(nch)]

    def run():
        return denoise_levels_fused(irrs, variances, normal, grad, depth,
                                    inst, ffs, STEPS)
    return run, run


def _gather_inputs(h, w, nsrc, seed):
    """test_reproj_gather_sharded_matches_single's field: sources of random
    words, a motion of up to +-6 rows and +-9 columns (inside the 16-row
    halo), rejected pixels at -1."""
    gen = _gen(seed)
    srcs = [torch.from_numpy(gen.integers(0, 2 ** 32, (h, 16, w),
                                          dtype=np.uint32).view(np.float32))
            for _ in range(nsrc)]
    ys = np.arange(h)[:, None] + gen.integers(-6, 7, (h, w))
    xs = np.arange(w)[None, :] + gen.integers(-9, 10, (h, w))
    ys[gen.random((h, w)) < 0.1] = -1
    piy = torch.from_numpy(ys.astype(np.int32))
    pix = torch.from_numpy(xs.astype(np.int32))
    return srcs, piy, pix


def _case_gather():
    from hikari_tpu_torch.ops.reproj_gather import reproj_gather
    from hikari_tpu_torch.parallel import shard as sh

    srcs, piy, pix = _gather_inputs(75, 40, 3, 7)
    return (lambda: reproj_gather(srcs, piy, pix),
            lambda: reproj_gather(srcs, piy, pix, mesh=sh.active_mesh()))


def _warp_coords(gen, h, w, hs, ws, reach):
    """Source coords of an [h, w] output over an [hs, ws] source: the
    proportional pixel plus up to `reach` pixels of motion, with .5 ties,
    integers and coords past every edge."""
    ys = ((np.arange(h)[:, None] + 0.5) * (hs / h) - 0.5
          + gen.uniform(-reach, reach, (h, w)))
    xs = ((np.arange(w)[None, :] + 0.5) * (ws / w) - 0.5
          + gen.uniform(-reach, reach, (h, w)))
    ys[::7] = np.round(ys[::7]) + 0.5
    xs[:, ::5] = np.round(xs[:, ::5])
    ys[0, :] = -3.0
    ys[-1, :] = hs + 2.0
    xs[:, 0] = -2.5
    return (torch.from_numpy(ys.astype(np.float32)),
            torch.from_numpy(xs.astype(np.float32)))


def _case_band():
    """Kernel 11 in TAA's form (Catmull-Rom RGB of a stride-4 source and
    nearest aux channels) at 50 rows, motion inside the 16-row halo."""
    from hikari_tpu_torch.ops.warp_band import warp_band
    from hikari_tpu_torch.parallel import shard as sh

    h, w = 50, 36
    gen = _gen(3)
    rgba = torch.from_numpy(gen.random((h, w, 4), np.float32))
    aux = torch.from_numpy(gen.random((h, w, 6), np.float32))
    sy, sx = _warp_coords(gen, h, w, h, w, 5.0)
    kinds = ("catmull", "nearest")
    return (lambda: warp_band([rgba[..., :3], aux], kinds, sy, sx),
            lambda: warp_band([rgba[..., :3], aux], kinds, sy, sx,
                              mesh=sh.active_mesh()))


def _case_multi():
    """Kernel 12 in SMAA's form (bf16 window, one nearest reduce of 4
    channels) from a source of twice the output's rows, a bilinear reduce
    with a column offset, and one with a row offset (which runs whole)."""
    from hikari_tpu_torch.ops.warp2 import warp_multi
    from hikari_tpu_torch.parallel import shard as sh

    h, w = 27, 20
    gen = _gen(4)
    src = torch.from_numpy(gen.random((2 * h, 2 * w, 5), np.float32))
    sy, sx = _warp_coords(gen, h, w, 2 * h, 2 * w, 10.0)
    reduces = [("nearest", (0.0, 0.0), (0, 4)),
               ("bilinear", (0.0, -0.5), (2, 5)),
               ("catmull", (0.25, 0.0), (0, 3))]

    def run(mesh=None):
        return (warp_multi(src, sy, sx, reduces[:1], dtype=torch.bfloat16,
                           mesh=mesh),
                warp_multi(src, sy, sx, reduces[1:2], mesh=mesh),
                warp_multi(src, sy, sx, reduces[1:], mesh=mesh))
    return run, lambda: run(sh.active_mesh())


ISLANDS = {
    "A even": _case_prepass(0),
    "A odd": _case_prepass(1),
    "B": _case_lighting(False),
    "4": _case_lighting(True),
    "C": _case_denoise,
    "9": _case_gather,
    "11": _case_band,
    "12": _case_multi,
}


def fake_row_launches(mesh, size):
    """Kernel A's island and kernel C's cascade island over `size` with
    their CUDA branches taken and the kernel library replaced by a
    recorder: each launch's name, block rows and width, and first image
    row (kernel A: read from its parameters at the call) and image rows
    (kernel C)."""
    import ctypes

    from hikari_tpu_torch import build
    from hikari_tpu_torch.camera import view_to_device
    from hikari_tpu_torch.ops import denoise_fused, prepass_fused

    calls = []

    class Recorder:
        def __getattr__(self, name):
            def fn(*args):
                if name == "hk_prepass_fused":
                    p = ctypes.cast(args[0], ctypes.POINTER(ctypes.c_float))
                    calls.append((name, args[8], args[9],
                                  int(p[prepass_fused._P_ROW0])))
                else:
                    calls.append((name, args[6], args[7], args[8], args[9]))
                return 0
            return fn

    build.load_cuda = lambda name: Recorder()
    for mod in (prepass_fused, denoise_fused):
        mod.on_cpu = lambda t: False
        mod.stream = lambda dev: ctypes.c_void_p(0)
    scene = minimal_box().as_pytree("cpu")
    view = view_to_device(_camera(size).view_uniform(), "cpu")
    prepass_fused.prepass_fused(scene, view, view, (0.0, 0.0), size,
                                mesh=mesh)
    h, w = size
    denoise_fused.levels_island(
        torch.zeros((3, h, w), dtype=torch.bfloat16),
        torch.zeros((3, h, w), dtype=torch.bfloat16),
        torch.zeros((5, h, w)), nch=1, ffs=(True,), steps=(8, 4, 2, 1),
        mesh=mesh)
    return calls


# ---------------------------------------------------------------- frames


def frame_settings(config):
    """The configurations of tests/test_parallel.py, by name."""
    from hikari_tpu_torch.config import HikariSettings, Taa, Upscale

    base = HikariSettings()
    if config == "plain":
        return dataclasses.replace(base, denoise=False, taa=Taa.NONE,
                                   upscale=Upscale.none(),
                                   indirect_bounces=0)
    if config == "default":
        return dataclasses.replace(
            base, temporal_reuse=True, emissive_spatial_reuse=True,
            indirect_spatial_reuse=True, denoise=True, taa=Taa.JASMINE,
            upscale=Upscale.smaa_tu4x(2.0), checkerboard_lighting=False)
    if config == "ckb":
        return dataclasses.replace(
            base, temporal_reuse=True, denoise=True, taa=Taa.NONE,
            upscale=Upscale.none(), checkerboard_lighting=True)
    if config == "reuse":
        return dataclasses.replace(
            base, temporal_reuse=True, denoise=True, taa=Taa.NONE,
            upscale=Upscale.none(), checkerboard_lighting=False)
    if config == "fused":
        return dataclasses.replace(
            base, temporal_reuse=True, denoise=False, taa=Taa.NONE,
            upscale=Upscale.none(), checkerboard_lighting=False)
    raise ValueError(config)


def frame_setup(config, size, modular=False):
    """(frame function, scene, view, noise, carry, settings) of the
    minimal scene (the cube on a plane with a sun) at `size` on the CPU.
    The port's tracer of this 14-triangle scene takes the fused kernels'
    gates (A, B / 4, 10); modular=True gives it another kind, so the
    frame takes the non-fused prepass and the modular lighting path, as
    hikari_tpu's CPU tracer does."""
    from hikari_tpu_torch.camera import view_to_device
    from hikari_tpu_torch.frame import build_render_frame, init_carry
    from hikari_tpu_torch.ops.noise import noise_constant
    from hikari_tpu_torch.ops.trace import make_tracer

    settings = frame_settings(config)
    gpu = minimal_box()
    scene = gpu.as_pytree("cpu")
    tracer = make_tracer(gpu.num_triangles)
    if modular:
        tracer.kind = "brute_force"
    fn = build_render_frame(settings, size, scene, tracer, True,
                            num_emissives=gpu.num_emissives,
                            has_sun=gpu.has_sun)
    view = view_to_device(_camera(size).view_uniform(), "cpu")
    carry = init_carry(size, settings, "cpu")
    # the first frame's previous view is the current one (Renderer's rule)
    carry["prev_view_proj"] = view["view_proj"].clone()
    carry["prev_inverse_view_proj"] = view["inverse_view_proj"].clone()
    return fn, scene, view, noise_constant("cpu"), carry, settings


def _snapshot(tree):
    if isinstance(tree, dict):
        return {k: _snapshot(v) for k, v in tree.items()}
    return tree.clone()


def render_frames(config, size, frames, mesh=None, modular=False):
    """`frames` frames (numbers 1..) of the configuration, under shard_frame
    over `mesh` when given. Returns [(image, albedo, carry)] per frame (a
    copy of each frame's carry: the sharded frame rewrites its static
    carry in place, as hikari_tpu donates it)."""
    from hikari_tpu_torch.config import make_frame_uniform
    from hikari_tpu_torch.parallel import shard_frame

    fn, scene, view, noise, carry, settings = frame_setup(config, size,
                                                          modular)
    if mesh is not None:
        fn, (scene, view, _, noise, carry) = shard_frame(
            fn, mesh, scene, view, make_frame_uniform(settings, 1), noise,
            carry, {size[0]})
    out = []
    for i in range(1, frames + 1):
        image, albedo, carry = fn(scene, view, make_frame_uniform(settings, i),
                                  noise, carry)
        out.append((image, albedo, _snapshot(carry)))
    return out


def frames(mesh, runs):
    """render_frames of each (config, size, frames, modular) of `runs`
    over the mesh: {(config, size, modular): that list}."""
    return {(cfg, tuple(size), mod): render_frames(cfg, tuple(size), n, mesh,
                                                   mod)
            for cfg, size, n, mod in runs}



# ---------------------------------------------------------------- the
# sharded frame's static inputs (parallel/mesh.py ShardedFrame)

# the dynamic fields retuned before the third frame (the intervals so that
# old and new validation frames cross)
RETUNE = dict(direct_validate_interval=2, emissive_validate_interval=3,
              max_temporal_reuse_count=20, max_spatial_reuse_count=300,
              max_reservoir_lifetime=4.0, solar_angle=0.2,
              max_indirect_luminance=2.0, clear_color=(0.1, 0.2, 0.3, 1.0))


def _settings_at(settings, i):
    return dataclasses.replace(settings, **RETUNE) if i >= 3 else settings


def static_against_fresh(mesh, runs):
    """Frames 1.. of each (config, size, frames, modular) of `runs` through
    shard_frame's function (the frame's words staged into its static
    inputs, the static carry written in place) and, beside it, through the
    frame function under row_mesh on fresh inputs (a frame dict without
    device words, the carry returned), the dynamic fields retuned before
    frame 3: {(config, size, modular): [names of the image, albedo and
    carry leaves that differ, per frame]}."""
    from hikari_tpu_torch.config import make_frame_uniform
    from hikari_tpu_torch.parallel import shard as sh
    from hikari_tpu_torch.parallel import shard_frame

    out = {}
    for cfg, size, frames, modular in runs:
        size = tuple(size)
        fn, scene, view, noise, carry, settings = frame_setup(cfg, size,
                                                              modular)
        sfn, (s_scene, s_view, _, s_noise, s_carry) = shard_frame(
            fn, mesh, scene, view, make_frame_uniform(settings, 1), noise,
            _snapshot(carry), {size[0]})
        diffs = []
        for i in range(1, frames + 1):
            frame = make_frame_uniform(_settings_at(settings, i), i)
            image, albedo, s_carry = sfn(s_scene, s_view, frame, s_noise,
                                         s_carry)
            with sh.row_mesh(mesh):
                f_image, f_albedo, carry = fn(scene, view, dict(frame),
                                              noise, carry)
            got = {"image": image, "albedo": albedo,
                   **_flat_leaves(s_carry)}
            want = {"image": f_image, "albedo": f_albedo,
                    **_flat_leaves(carry)}
            diffs.append(sorted(k for k in want if k not in got
                                or not _words(got[k], want[k])))
        out[(cfg, size, modular)] = diffs
    return out


def _flat_leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_leaves(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def sharded_trace(mesh, config, size, modular):
    """The operations that frame 11, then the next frame of its key after
    a retune of every dynamic field (RETUNE), then a frame of another key
    dispatch through shard_frame's function, recorded after three
    unrecorded frames (tests/torch_recorder.py: each kernel's plain
    version one opaque call; the collectives recorded as c10d
    operations): the three frames' keys, whether the first two dispatch
    the same operations (else their first difference), whether the third
    dispatches others, the first's operation names and the host reads."""
    from hikari_tpu_torch.config import make_frame_uniform
    from hikari_tpu_torch.parallel import shard_frame
    from tests.torch_recorder import (Recorder, first_difference, host_reads,
                                      install_opaque)

    rec = Recorder()
    install_opaque(rec, setattr)
    size = tuple(size)
    fn, scene, view, noise, carry, settings = frame_setup(config, size,
                                                          modular)
    sfn, (scene, view, _, noise, carry) = shard_frame(
        fn, mesh, scene, view, make_frame_uniform(settings, 0), noise, carry,
        {size[0]})
    for i in range(3):
        sfn(scene, view, make_frame_uniform(settings, i), noise, carry)
    retuned = dataclasses.replace(settings, **RETUNE)
    first = make_frame_uniform(settings, 11)
    key = fn.key(first)
    frames = [first] + [next(f for f in (make_frame_uniform(retuned, n)
                                         for n in range(12, 60))
                             if (fn.key(f) == key) == same)
                        for same in (True, False)]
    records = []
    for frame in frames:
        rec.ops = []
        with rec:
            sfn(scene, view, frame, noise, carry)
        records.append(rec.ops)
    a, b, c = records
    # a summary (the records hold the process group, which cannot be saved)
    return {"keys": [fn.key(f) for f in frames], "same": a == b,
            "difference": None if a == b else repr(first_difference(a, b)),
            "other_differs": a != c, "ops": [op for op, _, _ in a],
            "host_reads": host_reads(a + c)}
