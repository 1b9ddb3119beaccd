"""The post-overlay tail: bloom (ops/bloom.py) and FXAA (ops/fxaa.py)
against hikari_tpu's, run eagerly op by op on seeded images, and the
Renderer's tail (overlay, bloom, Reinhard, FXAA) on the box against
hikari_tpu's Renderer.

Tolerances:
* bloom bit for bit, at the default and at other BloomSettings, on sizes
  whose mip chain ends at one pixel and on odd sizes;
* FXAA bit for bit where hikari_tpu's luminance is evaluated as its source
  reads (the sum of the three products in order): XLA lowers its einsum to
  a chain of fused multiply-adds, which PyTorch has no form for, and a
  last-bit change of a luminance can flip FXAA's edge decisions on a noise
  image. As hikari_tpu's code runs, on smooth images: every value within
  1e-5 (a luminance's last bit moves the subpixel blend, and with it the
  sample point, by a few ulps of the image's values);
* the Renderer case under the frame bars (SSIM >= 0.98, mean abs diff <
  1e-3): hikari_tpu jits its tail, and XLA contracts its multiply-adds.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter

import hikari_tpu as hj
import hikari_tpu.ops.fxaa as ref_fxaa_mod
import hikari_tpu_torch as ht
from hikari_tpu.ops import bloom as ref_bloom
from hikari_tpu_torch.ops import bloom, fxaa
from tests.cornell_box import EYE, TARGET, build_cornell_box
from tests.test_torch_frame import assert_frames_close
from tests.torch_threads import one_torch_thread  # noqa: F401

# sizes: a 5-mip chain, odd sizes (fewer mips), a 1-pixel last mip, a row
SIZES = [(48, 64), (33, 17), (9, 13), (16, 16), (1, 5)]
SETTINGS = [(), (0.3, 0.5, 0.4, 1.7), (0.1, 2.0, 0.0, 0.5)]


def hdr_image(shape, seed):
    """Seeded HDR RGBA: most values below 1, a tail up to ~6."""
    rng = np.random.default_rng(seed)
    return (rng.random(shape + (4,)) ** 4 * 6.0).astype(np.float32)


def assert_bits_equal(got, want):
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("fields", SETTINGS,
                         ids=["default", "wide_knee", "no_knee"])
@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_bloom_matches_reference(size, fields):
    img = hdr_image(size, seed=size[0] * 100 + size[1])
    want = ref_bloom.bloom(jnp.asarray(img), ref_bloom.BloomSettings(*fields))
    got = bloom.bloom(torch.from_numpy(img), bloom.BloomSettings(*fields))
    assert_bits_equal(got.numpy(), np.asarray(want))


def test_bloom_mip_count_follows_the_size(monkeypatch):
    """5 mips at 48x64; the chain stops where the smaller side has
    bit_length - 3 halvings, at least 1 (hikari_tpu's rule)."""
    calls = []
    orig = bloom._downsample

    def counting(img):
        calls.append(tuple(img.shape[:2]))
        return orig(img)

    monkeypatch.setattr(bloom, "_downsample", counting)
    for size in ((48, 64), (9, 13), (1, 5)):
        calls.clear()
        bloom.bloom(torch.from_numpy(hdr_image(size, 0)))
        assert len(calls) == min(5, max(1, min(size).bit_length() - 3))


def plain_luminance(rgb):
    """hikari_tpu's luminance as its source reads: the products summed in
    order."""
    return rgb[..., 0] * 0.2126 + rgb[..., 1] * 0.7152 + rgb[..., 2] * 0.0722


@pytest.mark.parametrize("size", SIZES[:4] + [(64, 256)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_fxaa_matches_reference(size, monkeypatch):
    """Noise images (FXAA active on most pixels) with hikari_tpu's
    luminance as its source reads: bit for bit."""
    monkeypatch.setattr(ref_fxaa_mod, "luminance", plain_luminance)
    rng = np.random.default_rng(size[1])
    ldr = rng.random(size + (4,)).astype(np.float32)
    ldr[size[0] // 3:, :size[1] // 2, :3] *= 0.1     # a hard edge too
    want = ref_fxaa_mod.fxaa(jnp.asarray(ldr))
    got = fxaa.fxaa(torch.from_numpy(ldr))
    assert_bits_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("size", [(48, 64), (33, 17), (64, 256)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_fxaa_matches_reference_as_written(size):
    """Smooth images with a hard edge, against hikari_tpu's FXAA as it
    runs (its einsum luminance): every value within 1e-5."""
    rng = np.random.default_rng(size[0])
    ldr = gaussian_filter(rng.random(size + (4,)), (1.5, 1.5, 0))
    ldr[size[0] // 3:, :size[1] // 2, :3] *= 0.3
    ldr = ldr.astype(np.float32)
    want = np.asarray(ref_fxaa_mod.fxaa(jnp.asarray(ldr)))
    got = fxaa.fxaa(torch.from_numpy(ldr)).numpy()
    assert np.abs(got - want).max() <= 1e-5
    assert (got != ldr).any()           # FXAA changed some pixels


def test_renderer_post_tail_matches_reference():
    """The box on an HDR camera with BloomSettings() and fxaa=True at the
    flagship settings, 3 frames, 48x64: the port's Renderer against
    hikari_tpu's (overlay, bloom, Reinhard, FXAA)."""
    h, w = 48, 64

    def settings(pkg):
        return dataclasses.replace(
            pkg.HikariSettings(), temporal_reuse=False,
            emissive_spatial_reuse=False, indirect_spatial_reuse=False,
            taa=pkg.Taa.NONE, upscale=pkg.Upscale.none())

    def camera(pkg):
        return pkg.Camera.from_look_at(EYE, TARGET, width=w, height=h,
                                       hdr=True)

    ref = hj.Renderer(build_cornell_box("hikari_tpu"), camera(hj),
                      settings(hj), bloom_settings=ref_bloom.BloomSettings(),
                      fxaa=True).render(3)
    r = ht.Renderer(build_cornell_box("hikari_tpu_torch"), camera(ht),
                    settings(ht), device="cpu",
                    bloom_settings=bloom.BloomSettings(), fxaa=True)
    got = r.render(3)
    assert_frames_close(got, ref, (h, w))
    # the tail changed the image: without bloom and FXAA it differs
    plain = ht.Renderer(build_cornell_box("hikari_tpu_torch"), camera(ht),
                        settings(ht), device="cpu").render(3)
    assert np.abs(plain - got).max() > 1e-3
