"""Kernel 8's plain version (the SMAA parity quads) and the ratio-2
decimated G-buffer of hikari_tpu_torch.ops.prepass_fused against
hikari_tpu's Pallas prepass_fused_quads and prepass_fused(dec_size=,
dec_parity=) in interpret mode, on the box seen by a moving camera.

The port's quads are the words of its full-res planes at the parity
pixels (kernel 8 moves them; hikari_tpu traces those pixels again), so
against the port's own planes they are bit for bit, NaN payloads and
-0.0 included. Against hikari_tpu they meet kernel A's bar
(tests/test_torch_prepass.py): XLA on the CPU rounds the prepass's f32
chain differently from one-op-at-a-time PyTorch (on this box 68-79% of
position words are equal, the rest differ in the last bits), so a
bit-for-bit match with the reference is not reachable on the CPU.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hikari_tpu import Camera
from hikari_tpu.config import Taa, UpscaleMode
from hikari_tpu.ops.prepass import frame_jitter
from hikari_tpu.ops.prepass_fused import prepass_fused as prepass_ref
from hikari_tpu.ops.prepass_fused import prepass_fused_quads as quads_ref
from hikari_tpu_torch import scene_from_arrays
from hikari_tpu_torch.camera import view_to_device
from hikari_tpu_torch.ops import prepass as port_prepass
from hikari_tpu_torch.ops import prepass_fused as pf
from hikari_tpu_torch.config import Taa as PortTaa
from hikari_tpu_torch.config import UpscaleMode as PortUpscaleMode
from tests.cornell_box import EYE, TARGET, build_cornell_box
from tests.test_torch_prepass import assert_gbuffer_close
from tests.torch_threads import one_torch_thread  # noqa: F401

SIZE = (48, 64)
DEC = (24, 32)


@pytest.fixture(scope="module")
def box():
    gpu = build_cornell_box("hikari_tpu").compile()
    cam = Camera.from_look_at(EYE, TARGET, width=SIZE[1], height=SIZE[0])
    prev = Camera.from_look_at(np.add(EYE, (0.08, 0.05, -0.03)), TARGET,
                               width=SIZE[1], height=SIZE[0])
    return gpu, cam.view_uniform(), prev.view_uniform()


def _inputs(box, number):
    gpu, view_np, prev_np = box
    jit = frame_jitter(jnp.uint32(number), Taa.JASMINE,
                       UpscaleMode.SMAA_TU4X)
    ref_args = ({k: jnp.asarray(v) for k, v in gpu.arrays.items()},
                {k: jnp.asarray(v) for k, v in view_np.items()},
                {k: jnp.asarray(v) for k, v in prev_np.items()}, jit)
    jit_port = port_prepass.frame_jitter(number, PortTaa.JASMINE,
                                         PortUpscaleMode.SMAA_TU4X)
    np.testing.assert_array_equal(np.asarray(jit_port, np.float32),
                                  np.asarray(jit))
    port_args = (scene_from_arrays(gpu.arrays, "cpu"),
                 view_to_device(view_np, "cpu"),
                 view_to_device(prev_np, "cpu"), jit_port)
    return ref_args, port_args


def _quads_as_gbuffer(quads):
    """The {(a, b): planes} dict as gbuffer-like arrays for
    assert_gbuffer_close: depth, velocity and instance per parity."""
    out = {}
    for (a, b), q in quads.items():
        out[f"depth{a}{b}"] = q["depth"]
        out[f"velocity{a}{b}"] = q["velocity"]
        # the ids ride a trailing axis, as instance_material's do
        out[f"instance_material{a}{b}"] = q["instance"][..., None]
    return out


@pytest.mark.parametrize("number", [2, 5])
def test_quads_match_reference(box, number):
    """Kernel 8's plain version on the frame's G-buffer: the reference's
    traced quads to kernel A's bar, and the port's own full-res planes
    [a::2, b::2] bit for bit."""
    ref_args, port_args = _inputs(box, number)
    ref = quads_ref(*ref_args, SIZE, DEC, interpret=True)
    gbuf, _ = pf.prepass_fused(*port_args, SIZE)
    got = pf.prepass_fused_quads(gbuf)
    assert set(got) == set(ref) == set(pf.QUAD_PARITIES)
    g, r = _quads_as_gbuffer(got), _quads_as_gbuffer(ref)
    for k in r:
        key = "instance_material" if k.startswith("instance") else k
        assert_gbuffer_close({key: g[k]}, {key: r[k]})

    for (a, b), q in got.items():
        assert torch.equal(q["depth"], gbuf["position"][a::2, b::2, 3])
        assert torch.equal(q["velocity"], gbuf["velocity_uv"][a::2, b::2, :2])
        assert torch.equal(q["instance"],
                           gbuf["instance_material"][a::2, b::2, 0])


@pytest.mark.parametrize("number", [4, 7], ids=["even", "odd"])
def test_decimated_gbuffer_matches_reference(box, number):
    """The decimated G-buffer and albedo (the strided planes of the
    parity number & 1, the depth gradient included) against hikari_tpu's
    second, decimated prepass pass."""
    ref_args, port_args = _inputs(box, number)
    _, _, ref_g, ref_albedo = prepass_ref(
        *ref_args, SIZE, dec_size=DEC, dec_parity=jnp.uint32(number) & 1,
        interpret=True)
    gbuf, albedo, g, albedo_r = pf.prepass_fused(*port_args, SIZE,
                                                 dec_parity=number & 1)
    assert_gbuffer_close(g, ref_g)
    da = np.abs(albedo_r.numpy() - np.asarray(ref_albedo))
    assert (da <= 1e-4).mean() >= 0.99, da.max()

    s = number & 1
    for k in ("position", "normal", "instance_material", "velocity_uv"):
        assert torch.equal(g[k], gbuf[k][s::2, s::2]), k
    assert torch.equal(albedo_r, albedo[s::2, s::2])
    # the gradient: step-2 forward differences of the decimated depth, x 0.5
    d = g["position"][..., 3]
    ddx = torch.cat([d[:, 1:] - d[:, :-1], d[:, -1:] - d[:, -2:-1]], 1)
    ddy = torch.cat([d[1:] - d[:-1], d[-1:] - d[-2:-1]], 0)
    assert torch.equal(g["depth_gradient"],
                       torch.stack([ddx * 0.5, ddy * 0.5], -1))


# float32 words a G-buffer may hold that arithmetic would not keep:
# quiet and signalling NaNs with payloads, -0.0, infinities, a denormal
_SPECIAL_WORDS = np.array([0x7FC00001, 0x7F800001, 0xFFC0BEEF, 0xFFA00000,
                           0x80000000, 0x7F800000, 0xFF800000, 0x00000001],
                          dtype=np.uint32)


@pytest.mark.parametrize("size", [(6, 10), (48, 64)])
def test_quads_plain_moves_words(size):
    """quads_plain on a G-buffer of random words with NaN payloads, -0.0,
    infinities and denormals: each output word is the input word at its
    parity pixel, bit for bit (numpy's strided views of the raw words)."""
    rng = np.random.default_rng(size[0] * size[1])
    h, w = size

    def words(c):
        bits = rng.integers(0, 2 ** 32, (h, w, c), dtype=np.uint64).astype(
            np.uint32)
        pick = rng.random((h, w, c)) < 0.3
        bits[pick] = rng.choice(_SPECIAL_WORDS, int(pick.sum()))
        return bits

    pos, vel, ids = words(4), words(4), words(2)
    got = pf.quads_plain(*(torch.from_numpy(b.view(np.float32))
                           for b in (pos, vel, ids)))
    want = (np.stack([pos[a::2, b::2, 3] for a, b in pf.QUAD_PARITIES]),
            np.stack([vel[a::2, b::2, :2] for a, b in pf.QUAD_PARITIES]),
            np.stack([ids[a::2, b::2, 0] for a, b in pf.QUAD_PARITIES]))
    for g, r in zip(got, want):
        assert g.dtype == torch.float32 and g.is_contiguous()
        np.testing.assert_array_equal(g.numpy().view(np.uint32), r)
