"""Kernel 4 (csrc/light_fused.cu `light_kernel`, the temporal lighting):
its bytes (G-buffer and noise in, the previous reservoirs in, per active
channel its render, variance and packed reservoir out, the tracking
planes where tracked) and operations (the reservoir algebra and shading
per channel and pixel, 60 a ray-triangle test of this frame's rays:
the sun's shadow ray, the emissive probe and shadow ray, per bounce the
bounce and its NEE, and the validation retraces)."""

from portbench.bounds.peaks import bound_ms

FLOPS_PER_TRI_TEST = 60
FLOPS_RESERVOIR = 300
FLOPS_SHADE = 400


def tri_tests(n_tri, n_em_tri, has_sun, n_em, bounces,
              validation=(False, False)) -> int:
    tests = 0
    if has_sun:
        tests += n_tri * (1 + validation[0])
    if n_em > 0:
        tests += (n_em_tri + n_tri) * (1 + validation[1])
    if bounces > 0:
        nee = (n_em_tri if n_em > 0 else 0) + n_tri
        tests += bounces * (n_tri + nee)
    return tests


def call_bound_ms(npix, n_tri, n_em_tri, has_sun, n_em, bounces,
                  validation, track_de, track_ind):
    """(bound ms, by) of one call over npix pixels."""
    n_de = int(has_sun) + int(n_em > 0)
    n_ch = n_de + int(bounces > 0)
    out_b = (4 * (4 + 1 + 16) * n_ch
             + 4 * (1 + 16) * n_de * int(track_de)
             + 4 * int(bounces > 0) * int(track_ind))
    nbytes = npix * (4 * (4 + 3 + 2 + 4) + 64 * n_ch + out_b)
    flops = npix * (FLOPS_RESERVOIR + FLOPS_SHADE) * n_ch
    flops += npix * FLOPS_PER_TRI_TEST * tri_tests(
        n_tri, n_em_tri, has_sun, n_em, bounces, validation)
    return bound_ms(nbytes, flops)
