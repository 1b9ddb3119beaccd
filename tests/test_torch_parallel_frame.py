"""The port's sharded frame (hikari_tpu_torch.parallel.shard_frame over 4
gloo ranks) against the port's single-process frame, bit for bit in the
image, the albedo and every carry, on every rank, for the configurations
of tests/test_parallel.py on the minimal scene (a cube on a plane, a sun).

hikari_tpu's CPU tracer takes the modular lighting path there and its
stubbed case the fused kernels; the port's tracer of this scene takes the
fused gates, so the first five run with the tracer's kind changed
(torch_dist.frame_setup modular=True: islands of 9, C, 11 and 12) and the
last two on the port's own gates (islands of A, 8, B / 4, 9, C, 11, 12;
kernel 10 whole)."""

from __future__ import annotations

import pytest
import torch

from tests import torch_dist
from tests.torch_threads import one_torch_thread  # noqa: F401

RANKS = 4
# (config, size, frames, modular)
RUNS = (
    # no denoise, no TAA, no upscale, 0 bounces
    ("plain", (32, 64), 2, True),
    # the reference default: SMAA TU4X 2.0, TAA, denoise, temporal and
    # spatial reuse
    ("default", (32, 64), 3, True),
    # checkerboard lighting + temporal reuse + denoise
    ("ckb", (32, 64), 3, True),
    # 256 rows: the full 16-row halo and denoise step 16 across ranks
    ("reuse", (256, 128), 2, True),
    # 42 rows: 4 ranks do not divide them
    ("reuse", (42, 64), 2, True),
    # the fused islands (hikari_tpu's stubbed tracer kind)
    ("fused", (32, 64), 2, False),
    # the reference default on the fused kernels (path M's kernels)
    ("default", (32, 64), 3, False),
)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}{k}."))
        return out
    return {prefix.rstrip("."): tree}


def _same_words(a, b):
    return (a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8)))


@pytest.fixture(scope="module")
def rendered(tmp_path_factory):
    """The ranks' frames and the single-process frames, made meanwhile."""
    started = torch_dist.start_ranks("frames", RANKS,
                                     tmp_path_factory.mktemp("frames"), RUNS)
    single = torch_dist.frames(None, RUNS)
    return single, torch_dist.join_ranks(started)


@pytest.mark.parametrize("run", RUNS, ids=[
    f"{c}-{h}x{w}-{'modular' if m else 'fused'}" for c, (h, w), _, m in RUNS])
def test_sharded_frame_equals_single_process(rendered, run):
    single, ranks = rendered
    cfg, size, _, modular = run
    key = (cfg, size, modular)
    for i, (image, albedo, carry) in enumerate(single[key]):
        want = {"image": image, "albedo": albedo, **_leaves(carry)}
        for r, res in enumerate(ranks):
            got_image, got_albedo, got_carry = res[key][i]
            got = {"image": got_image, "albedo": got_albedo,
                   **_leaves(got_carry)}
            assert set(got) == set(want)
            bad = [k for k in want if not _same_words(got[k], want[k])]
            assert not bad, f"frame {i + 1}, rank {r}: {bad} differ"
