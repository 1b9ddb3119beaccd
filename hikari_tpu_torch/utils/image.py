"""Image IO and quality metrics (the port of hikari_tpu/utils/image.py):
sRGB encoding, PNG output and input through PIL, and SSIM / PSNR in
numpy, the same expressions as hikari_tpu's."""

from __future__ import annotations

import numpy as np


def srgb_encode(rgb: np.ndarray) -> np.ndarray:
    """Linear RGB (clipped to [0, 1]) as sRGB values in [0, 1]."""
    rgb = np.clip(rgb, 0.0, 1.0)
    return np.where(rgb <= 0.0031308, 12.92 * rgb,
                    1.055 * rgb ** (1 / 2.4) - 0.055)


def save_png(path: str, img: np.ndarray, encode_srgb: bool = True):
    """Write the first three channels of `img` ([H,W,C] in [0, 1],
    sRGB-encoded first unless `encode_srgb` is False) as an 8-bit PNG."""
    from PIL import Image

    rgb = img[..., :3]
    if encode_srgb:
        rgb = srgb_encode(rgb)
    Image.fromarray((np.clip(rgb, 0, 1) * 255 + 0.5).astype(np.uint8)).save(
        path)


def load_png(path: str) -> np.ndarray:
    """A PNG as [H,W,3] float32 in [0, 1] (its stored values, not
    linearized)."""
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGB")).astype(
        np.float32) / 255.0


def _gaussian_kernel(size=11, sigma=1.5):
    ax = np.arange(size) - size // 2
    k = np.exp(-(ax ** 2) / (2 * sigma ** 2))
    k = np.outer(k, k)
    return k / k.sum()


def _filter2(img, kernel):
    from numpy.lib.stride_tricks import sliding_window_view

    pad = kernel.shape[0] // 2
    p = np.pad(img, ((pad, pad), (pad, pad)), mode="reflect")
    win = sliding_window_view(p, kernel.shape)
    return np.einsum("hwij,ij->hw", win, kernel)


def ssim(a: np.ndarray, b: np.ndarray, data_range: float = 1.0) -> float:
    """Mean SSIM over channels (Wang et al. 2004, 11x11 gaussian window,
    reflected borders)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.ndim == 2:
        a = a[..., None]
        b = b[..., None]
    k = _gaussian_kernel()
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    vals = []
    for c in range(a.shape[-1]):
        x, y = a[..., c], b[..., c]
        mx = _filter2(x, k)
        my = _filter2(y, k)
        mxx = _filter2(x * x, k)
        myy = _filter2(y * y, k)
        mxy = _filter2(x * y, k)
        vx = mxx - mx * mx
        vy = myy - my * my
        cxy = mxy - mx * my
        s = ((2 * mx * my + c1) * (2 * cxy + c2)) / (
            (mx * mx + my * my + c1) * (vx + vy + c2))
        vals.append(s.mean())
    return float(np.mean(vals))


def psnr(a: np.ndarray, b: np.ndarray, data_range: float = 1.0) -> float:
    """Peak signal-to-noise ratio in dB (inf for equal images)."""
    mse = float(np.mean((np.asarray(a, np.float64) - b) ** 2))
    if mse == 0:
        return float("inf")
    return 10.0 * np.log10(data_range * data_range / mse)
