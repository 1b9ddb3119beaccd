"""frame program (PyTorch glue): device time a frame in work that PyTorch
itself launched (the at::native namespace, the libraries it calls, and its
copies and fills), as opposed to the port's own kernels (csrc/) or any
later Triton or CUDA kernel."""

GLUE_MARKS = ("at::native", "at_cuda_detail", "cub::", "cutlass", "gemm",
              "gemv", "cublas", "xmma", "nvjet")


def is_glue(a) -> bool:
    """Copies and fills (also a captured copy's `memcpy128` kernel node)
    and PyTorch's own kernels."""
    name = a.name.lower()
    if a.kind != "kernel" or "memcpy" in name or "memset" in name:
        return True
    return any(m in a.name for m in GLUE_MARKS)


def read(ctx):
    if not ctx.frames or not ctx.device:
        return None
    ns = sum(a.end - a.start for a in ctx.device if is_glue(a))
    return ns / 1e6 / len(ctx.frames)
