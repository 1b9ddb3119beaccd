"""NVIDIA H100 SXM data-sheet peaks at the 700 W limit: HBM3 bytes/s and
the float32 rate outside the tensor cores, which the port's kernels use."""

PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12


def bound_ms(nbytes: float, flops: float):
    """(bound ms, "bytes" or "operations")."""
    b, f = nbytes / PEAK_BYTES, flops / PEAK_F32
    return max(b, f) * 1e3, ("bytes" if b >= f else "operations")
