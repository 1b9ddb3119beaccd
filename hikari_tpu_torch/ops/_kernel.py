"""Helpers shared by the kernel wrappers: argument checks, ctypes pointers,
the launch-error check, and the float32 arithmetic rules the plain
versions follow so that they round like the kernels."""

from __future__ import annotations

import ctypes

import numpy as np
import torch


def on_cpu(t: torch.Tensor) -> bool:
    """True for a CPU tensor (the plain version runs), False for a CUDA
    tensor (the kernel launches); any other device raises."""
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(f"unsupported device {t.device}")


def check(name: str, t: torch.Tensor, dtype, shape=None, device=None):
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(0 if t is None else t.data_ptr())


def stream(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def check_launch(rc: int, what: str):
    """Raise on the cudaError_t a launch function returned."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")


_CTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int, "f": ctypes.c_float}


def bind(lib, name: str, signature: str):
    """Declare the ctypes signature of `name`: one letter per argument,
    'p' for a pointer or stream (c_void_p), 'i' for an int, 'f' for a
    float."""
    fn = getattr(lib, name)
    fn.restype = ctypes.c_int
    fn.argtypes = [_CTYPES[c] for c in signature]
    return fn


def host_values(values, device) -> torch.Tensor:
    """A small float32 vector of host values on `device`. A CUDA copy goes
    through pinned memory without blocking, so building per-frame
    parameters does not stall the host on the stream."""
    t = torch.tensor(values, dtype=torch.float32)
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def f32(x) -> float:
    """x rounded to float32, as a Python float (exact in torch's f32 ops)."""
    return float(np.float32(x))


def div(a, b):
    """a / b as a correctly rounded f32 division. PyTorch turns a division
    by a Python scalar (and `scalar / tensor`) into a multiplication by a
    reciprocal on some devices, so both operands are made tensors."""
    if not torch.is_tensor(a):
        a = torch.full_like(b, a)
    if not torch.is_tensor(b):
        b = torch.full_like(a, b)
    return a / b
