"""Kernel C (csrc/denoise_fused.cu, one a-trous level over nch channels):
bf16 irradiance and geometry planes in and out, the level's weights."""

from portbench.bounds.peaks import bound_ms


def level_bound_ms(npix: int, nch: int):
    nbytes = npix * (2 * 3 * nch + 2 * (2 + nch) + 4 * 5 + 2 * 3 * nch)
    flops = npix * (8 * (20 + 25 * nch) + 30 * nch)
    return bound_ms(nbytes, flops)
