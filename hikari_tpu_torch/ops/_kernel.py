"""Helpers shared by the kernel wrappers: argument checks, ctypes pointers,
the launch-error check, and the float32 arithmetic rules the plain
versions follow so that they round like the kernels."""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from hikari_tpu_torch.config import DYNAMIC_LAYOUT, dynamic_values


def on_cpu(t: torch.Tensor) -> bool:
    """True for a CPU tensor (the plain version runs), False for a CUDA
    tensor (the kernel launches); any other device raises."""
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(f"unsupported device {t.device}")


def check(name: str, t: torch.Tensor, dtype, shape=None, device=None):
    if (t.dtype == dtype and (shape is None or t.shape == tuple(shape))
            and (device is None or t.device == device)
            and t.is_contiguous()):
        return          # the common case, in one test (host time counts)
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    raise ValueError(f"{name}: not contiguous")


def outputs(like: torch.Tensor, h: int, w: int, channels):
    """Contiguous [h, w, c] tensors of like's dtype and device, one per c
    of `channels`: with several, views of one allocation (on the host an
    allocation costs more than a view)."""
    if len(channels) == 1:
        return [like.new_empty((h, w, channels[0]))]
    buf = like.new_empty(h * w * sum(channels))
    outs, off = [], 0
    for c in channels:
        outs.append(buf.as_strided((h, w, c), (w * c, c, 1), off))
        off += h * w * c
    return outs


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(0 if t is None else t.data_ptr())


def stream(device) -> ctypes.c_void_p:
    """PyTorch's current stream on the CUDA `device`, as a pointer. The raw
    accessor: `torch.cuda.current_stream(device).cuda_stream` builds a
    Stream object and costs tens of microseconds a call on the host."""
    index = device.index
    if index is None:
        index = torch.cuda.current_device()
    return ctypes.c_void_p(torch._C._cuda_getCurrentRawStream(index))


def check_launch(rc: int, what: str):
    """Raise on the cudaError_t a launch function returned."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")


_CTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int, "f": ctypes.c_float,
           "t": ctypes.c_char_p}
# {(library, name): bound function}, for the life of the process: a key
# holds its library object, so no other library takes its address (id)
_BOUND = {}


def bind(lib, name: str, signature: str):
    """The function `name` of `lib` with its ctypes signature declared: one
    letter per argument, 'p' for a pointer or stream (c_void_p), 'i' for
    an int, 'f' for a float, 't' for a packed table (bytes, passed by
    pointer). Declared once per library object and name."""
    fn = _BOUND.get((lib, name))
    if fn is None:
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [_CTYPES[c] for c in signature]
        _BOUND[lib, name] = fn
    return fn


def capturing(device) -> bool:
    """True while the current stream of the CUDA `device` is captured into
    a CUDA graph (renderer.py)."""
    return (torch.device(device).type == "cuda"
            and torch.cuda.is_current_stream_capturing())


def host_values(values, device) -> torch.Tensor:
    """A fresh small float32 vector of host values on `device`, for callers
    outside the compiled frame. A CUDA copy goes through pinned memory
    without blocking. Under a graph capture it raises: the graph would
    replay a copy from a freed buffer, and a value that varies by frame
    belongs in the frame's static buffers (frame.frame_words)."""
    if capturing(device):
        raise RuntimeError("host_values under a CUDA graph capture: a "
                           "per-frame value must come from the frame's "
                           "static buffers, a constant from const_values")
    t = torch.tensor(values, dtype=torch.float32)
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def values_on(values, device) -> torch.Tensor:
    """`values` as a float32 tensor on `device`: a tensor (such as one of
    the frame's device words) as it is, host values as a fresh vector
    (host_values)."""
    return values if torch.is_tensor(values) else host_values(values, device)


def frame_value(frame, key: str, make, device) -> torch.Tensor:
    """frame[key], one of the frame's device words (frame.with_words);
    for a frame dict without them (a caller outside the frame program)
    a fresh vector of make()'s host values."""
    t = frame.get(key)
    return host_values(make(), device) if t is None else t


def dynamic(frame, name: str, device) -> torch.Tensor:
    """The settings' dynamic value `name` (config.DYNAMIC_LAYOUT) as a
    [words] float32 tensor: a view of the frame's device words
    (frame.with_words), which a retune rewrites; for a frame dict without
    them (a caller outside the frame program) fresh host values from the
    frame's entries (config.dynamic_values)."""
    words = frame.get("dynamic")
    if words is None:
        return host_values(dynamic_values(frame, name), device)
    at, n = DYNAMIC_LAYOUT[name]
    return words[at:at + n]


# {(values, device): tensor}, for the life of the process: a captured
# graph keeps reading the tensors it was captured with, so none is freed
_CONSTS = {}


def const_values(values, device) -> torch.Tensor:
    """A float32 vector of host values that stay the same from frame to
    frame, made once per values and device and then shared: the compiled
    frame's warm-up makes it, its capture reads it. A first use under a
    graph capture raises. The frame asks it only for values fixed by its
    settings key and sizes (sizes, offsets, the validation flags of its
    key; the settings' dynamic values are frame words, `dynamic`), so the
    cache stays bounded however often the settings are retuned."""
    values = np.asarray(values, np.float32)
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    key = (values.shape, values.tobytes(), dev)
    t = _CONSTS.get(key)
    if t is None:
        if capturing(dev):
            raise RuntimeError("const_values: first use of a constant under "
                               "a CUDA graph capture")
        t = torch.from_numpy(values.copy()).to(dev)
        _CONSTS[key] = t
    return t


# PyTorch's CPU loops compute a vectorized op's last partial vector with the
# scalar function; for exp2 its last bit can differ from the vector
# function's. Which elements fall there depends on the tensor's size, so a
# row block of the image would round differently from the whole image.
# exp2's inputs are therefore padded to whole vectors of this many floats.
LANES = 64


def exp2(x):
    """torch.exp2(x), on the CPU with every element through the vector
    function (a row block's words equal the whole image's); unchanged on
    CUDA."""
    if x.device.type != "cpu":
        return torch.exp2(x)
    n = x.numel()
    flat = x.reshape(-1)
    if n % LANES:
        flat = torch.cat([flat, flat.new_zeros(LANES - n % LANES)])
    return torch.exp2(flat)[:n].reshape(x.shape)


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
