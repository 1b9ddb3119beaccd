"""Where the box's upscale frames part from hikari_tpu's under camera motion.

Renders the frames of one case of tests/test_torch_frame_upscale.py
off the exact half (default fsr1_1.3; also smaa_1.0 or ckb_fsr1_1.5)
through both stacks, as that file does, under each of
these set-ups, and prints the last frame's mean abs difference and SSIM
(and every frame's with --all), with the pixels the last frame has off by
more than 0.1 and their columns:

  static       the camera still
  taa_pan      the pan of tests/test_torch_frame_upscale.py: one pixel of
               TAA's grid per frame
  out_pan      one output pixel per frame
  out_pan_gbuf out_pan, the port fed hikari_tpu's G-buffer (its kernel A,
               compiled, on the port's views) in place of its own
  out_pan_exact
               out_pan_gbuf with hikari_tpu's two multiply-adds that XLA's
               CPU compiler contracts into one FMA inside the jitted frame
               evaluated as written: the generic resample's index map
               (restir.py:117-119, built with numpy) and the post chain
               (taa.py:97-98's history coordinate; run eagerly through a
               host callback); test_torch_frame_upscale.py's exact check
  out_pan_own  out_pan_exact with the port's own G-buffer

Also prints the share of G-buffer words in which kernel A's plain version
and hikari_tpu's kernel A differ on the first panned frame, per plane and
in all, with hikari_tpu jitted and under jax.disable_jit (its Pallas
interpreter runs the kernel body as one compiled program in both), and
again with the port's torch.rsqrt replaced by XLA's (lax.rsqrt on the
same inputs): what is left is the multiply-adds XLA's CPU compiler
contracts into FMAs in that program (|d|^2 of the camera ray, for one,
is fma(dz, dz, fma(dx, dx, dy * dy)) there). It prints how often XLA's
rsqrt differs from 1 / sqrt on 2^20 seeded floats, and how many of the
indices of hikari_tpu's own generic resample change under jit on an even
frame.

Run from the repository root, on the CPU:
    JAX_PLATFORMS=cpu python -m tests.torch_pan_witness [case] [--all]
    JAX_PLATFORMS=cpu python -m tests.torch_pan_witness [case] --words
(--words: the G-buffer words and the rsqrt share only, ~1 min).
"""

from __future__ import annotations

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hikari_tpu as hj
import hikari_tpu.ops.prepass_fused as pf_ref
import hikari_tpu_torch as ht
from hikari_tpu.utils.image import ssim
from hikari_tpu_torch.camera import view_to_device
from hikari_tpu_torch.ops import prepass_fused as pf
from tests.cornell_box import build_cornell_box
from tests.test_torch_frame_upscale import (_RESAMPLE, CASES, FRAMES,
                                            camera, case_settings,
                                            reference_gbuffer,
                                            reference_renderer, taa_rows)

_PREPASS = pf.prepass_fused


def run(ref_r, case, rows, gbuf_from_ref):
    """FRAMES frames through both stacks: ([(mean abs diff, SSIM)], the
    last frame's largest abs diff over RGB per pixel)."""
    pf.prepass_fused = reference_gbuffer(ref_r) if gbuf_from_ref else _PREPASS
    ref_r.reset()
    port_r = ht.Renderer(build_cornell_box("hikari_tpu_torch"),
                         camera(ht, case, 0, rows), case_settings(ht, case),
                         device="cpu")
    out = []
    try:
        for i in range(FRAMES):
            ref_r.camera = camera(hj, case, i, rows)
            port_r.camera = camera(ht, case, i, rows)
            ref = np.asarray(ref_r.render_frame())
            got = port_r.render_frame().numpy()
            s = ssim(np.clip(got[..., :3], 0, 1), np.clip(ref[..., :3], 0, 1))
            out.append((float(np.abs(got - ref).mean()), float(s)))
    finally:
        pf.prepass_fused = _PREPASS
    return out, np.abs(got - ref)[..., :3].max(-1)


def xla_rsqrt(x):
    """XLA's CPU rsqrt of a CPU float32 tensor (lax.rsqrt on its values)."""
    return torch.from_numpy(np.array(jax.lax.rsqrt(jnp.asarray(x.numpy()))))


def gbuffer_words(case, rows, refs=("jit", "disable_jit"),
                  ports=("torch_rsqrt", "xla_rsqrt")):
    """Share of G-buffer words that differ between kernel A's plain version
    and hikari_tpu's kernel A on the first panned frame's views: {(port,
    reference): {plane: share, "all": share}} for the port as it is and
    with XLA's rsqrt (`ports`), against hikari_tpu jitted and under
    disable_jit (`refs`)."""
    size = CASES[case][3]
    views = [camera(ht, case, i, rows).view_uniform() for i in (1, 0)]
    jitter = (0.25, -0.125)
    args = (build_cornell_box("hikari_tpu").compile().as_pytree(),
            *[{k: jnp.asarray(a) for k, a in v.items()} for v in views],
            jnp.asarray(np.float32(jitter)), size)
    wanted, refs = refs, {}
    if "jit" in wanted:
        refs["jit"] = jax.jit(pf_ref.prepass_fused,
                              static_argnums=(4,))(*args)[0]
    if "disable_jit" in wanted:
        with jax.disable_jit():
            refs["disable_jit"] = pf_ref.prepass_fused(*args)[0]
    out = {}
    for port in ports:
        mp = pytest.MonkeyPatch()
        if port == "xla_rsqrt":
            mp.setattr(torch, "rsqrt", xla_rsqrt)
        try:
            got, _ = pf.prepass_fused(
                build_cornell_box("hikari_tpu_torch").compile()
                .as_pytree("cpu"),
                *[view_to_device(v, "cpu") for v in views], jitter, size)
        finally:
            mp.undo()
        for name, ref in refs.items():
            diff = {k: (got[k].numpy().view(np.uint32)
                        != np.asarray(ref[k]).view(np.uint32)) for k in got}
            shares = {k: float(d.mean()) for k, d in diff.items()}
            shares["all"] = (sum(int(d.sum()) for d in diff.values())
                             / sum(d.size for d in diff.values()))
            out[(port, name)] = shares
    return out


def rsqrt_share(n=1 << 20, seed=0):
    """How often XLA's CPU rsqrt differs from torch.rsqrt (1 / sqrt,
    each rounded) on n seeded floats in [0, 10)."""
    x = np.random.default_rng(seed).random(n, dtype=np.float32) * 10
    t = torch.from_numpy(x)
    return float((xla_rsqrt(t) != torch.rsqrt(t)).float().mean())


def jit_changes(case):
    """Whether hikari_tpu's generic resample changes under jit (the count
    of differing indices), on an even frame of the case's sizes."""
    size = CASES[case][3]
    render = ht.frame.scaled_size(size, CASES[case][1])
    img = jnp.arange(size[0] * size[1], dtype=jnp.float32).reshape(size)
    eager = _RESAMPLE(img, render, jnp.uint32(0), CASES[case][1])
    jitted = jax.jit(lambda a, n: _RESAMPLE(a, render, n, CASES[case][1]))(
        img, jnp.uint32(0))
    return int((np.asarray(eager) != np.asarray(jitted)).sum())


def main(argv):
    case = next((a for a in argv if not a.startswith("-")), "fsr1_1.3")
    every = "--all" in argv
    size = CASES[case][3]
    if "--words" in argv:
        print_words(case, size)
        return
    rows = []
    for exact, setups in ((False, (("static", 0, False),
                                   ("taa_pan", taa_rows(case), False),
                                   ("out_pan", size[0], False),
                                   ("out_pan_gbuf", size[0], True))),
                          (True, (("out_pan_exact", size[0], True),
                                  ("out_pan_own", size[0], False)))):
        mp = pytest.MonkeyPatch()
        ref_r = reference_renderer(mp, case, exact)
        for name, pan, gb in setups:
            rows.append((name, run(ref_r, case, pan, gb)))
        mp.undo()
    print(f"case {case}: output {size}, TAA grid {taa_rows(case)} rows, "
          f"{FRAMES} frames")
    for name, (frames, diff) in rows:
        shown = frames if every else frames[-1:]
        print(f"{name:14s} " + "  ".join(
            f"mean_abs {d!r} ssim {s!r}" for d, s in shown))
        big = diff > 0.1
        print(f"{'':14s} pixels off by > 0.1: {float(big.mean())!r}, in "
              "columns "
              f"{np.nonzero(big.any(0))[0].tolist()}")
    print_words(case, size)
    print("resample indices changed by jit (even frame):", jit_changes(case))


def print_words(case, size):
    print("gbuffer words differing, first panned frame (port, hikari_tpu):")
    for key, shares in gbuffer_words(case, size[0]).items():
        print(f"  {key}: " + ", ".join(f"{k} {v!r}" for k, v in
                                       shares.items()))
    print("XLA's rsqrt differs from 1 / sqrt on", rsqrt_share(),
          "of 2^20 floats in [0, 10)")


if __name__ == "__main__":
    main(sys.argv[1:])
