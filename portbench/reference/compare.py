"""The comparison that decides `correct`. The reference (the frozen copy
`hk`, plain PyTorch, eager) renders the cell's frames from frame 0, from
the same scene arrays, camera poses and instance transforms, and works out
again everything the port derives: the compiled scene and its BVH (an
LBVH here, where the port builds a binned SAH), the refit, the carry of
every frame, the post chain. It takes nothing the port made. The final
images of the compared frames are held against the port's.

hk is the port's own plain path as it was when the benchmark was written,
so `correct` is a regression check: the timed path (kernels, captured
graphs, frames in flight) still computes what that plain path computed.
A fault the plain path already carried passes it; portbench/witness ties
the plain path to hikari_tpu, the renderer the port was written from.

The control (`control=True`) is the reference with its image-space
passes and its final image in bfloat16 (`bf16_image_planes`), the
precision below the float32 that the configurations state."""

from __future__ import annotations

import contextlib

import numpy as np
import torch

def _round(t):
    """float32 tensors (also inside tuples, lists and dicts) rounded to
    bfloat16 and held as float32."""
    if isinstance(t, torch.Tensor) and t.dtype == torch.float32:
        return t.to(torch.bfloat16).to(torch.float32)
    if isinstance(t, (tuple, list)):
        return type(t)(_round(x) for x in t)
    if isinstance(t, dict):
        return {k: _round(v) for k, v in t.items()}
    return t


# the image-space passes whose colour planes the control stores in
# bfloat16: (module of hk, name) of each function the frame calls
BF16_PASSES = (("frame", "denoise_channels"), ("frame", "tone_mapping"),
               ("ops.post", "smaa_tu4x"), ("ops.post", "taa_jasmine"))


@contextlib.contextmanager
def bf16_image_planes():
    """The control's precision: while open, the reference's image-space
    passes (the denoiser, tone mapping, SMAA and TAA, whose outputs are
    also the next frame's histories) return their colour planes rounded
    to bfloat16, as half-precision render targets would hold them.
    Geometry, ids and packed reservoir words stay float32: bfloat16 holds
    neither a 1080p pixel index nor a packed word."""
    import importlib

    saved = []
    for mod_name, fn_name in BF16_PASSES:
        mod = importlib.import_module(f"portbench.reference.hk.{mod_name}")
        fn = getattr(mod, fn_name)
        saved.append((mod, fn_name, fn))

        def rounded(*a, __fn=fn, **k):
            return _round(__fn(*a, **k))

        setattr(mod, fn_name, rounded)
    try:
        yield
    finally:
        for mod, fn_name, fn in saved:
            setattr(mod, fn_name, fn)


def reference_images(config, desc, traffic, frames, device,
                     control: bool = False) -> dict:
    """{frame number: [H,W,4] float32 numpy} of the reference's final
    images at `frames`, rendering frames 0 .. max(frames) in order."""
    from portbench.harness.frames import Frames, to_numpy
    from portbench.reference import hk

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    want = set(frames)
    out = {}
    planes = bf16_image_planes() if control else contextlib.nullcontext()
    with torch.no_grad(), planes:
        ref = Frames(hk, config, desc, traffic, device)
        for f in range(max(want) + 1):
            img = ref.frame(f)
            if f in want:
                out[f] = to_numpy(_round(img) if control else img)
    return out


def differences(got: np.ndarray, ref: np.ndarray) -> dict:
    """The numbers of one frame's comparison, over the colour channels:
    the mean absolute difference, the 99.9th and 99.99th percentiles of
    the per-pixel largest channel difference, and the share of non-finite
    values."""
    g = np.asarray(got, np.float64)[..., :3]
    r = np.asarray(ref, np.float64)[..., :3]
    bad = float(np.mean(~np.isfinite(g)))
    d = np.abs(np.nan_to_num(g, nan=1e9, posinf=1e9, neginf=1e9) - r)
    pixel = d.max(axis=-1)
    return {"mean_abs_diff": float(d.mean()),
            "p999_abs_diff": float(np.percentile(pixel, 99.9)),
            "p9999_abs_diff": float(np.percentile(pixel, 99.99)),
            "nonfinite_share": bad}


def judge(got: dict, ref: dict, limits: dict):
    """(correct, compared, failed frames, worst): each number is the worst
    over the compared frames; `compared` maps each limited number to
    {"value", "limit"}, `worst` every number of `differences`."""
    worst, failed = {}, 0
    for f in sorted(got):
        d = differences(got[f], ref[f])
        if any(not (d[k] <= limits[k]) for k in limits):
            failed += 1
        for k, v in d.items():
            worst[k] = max(worst.get(k, 0.0), v)
    compared = {k: {"value": worst[k], "limit": limits[k]} for k in limits}
    correct = bool(got) and failed == 0 and all(
        c["value"] <= c["limit"] for c in compared.values())
    return correct, compared, failed, worst
