"""Helpers shared by the kernel wrappers: argument checks and the
float32 arithmetic rules the plain versions follow so that they round
like the kernels."""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.hk.config import DYNAMIC_LAYOUT, dynamic_values


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


def host_values(values, device) -> torch.Tensor:
    """A fresh small float32 vector of host values on `device`."""
    return torch.tensor(values, dtype=torch.float32).to(device)


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


def const_values(values, device) -> torch.Tensor:
    """A float32 vector of host values that stay the same from frame to
    frame (sizes, offsets, the validation flags of the frame's key) on
    `device`."""
    return torch.from_numpy(np.asarray(values, np.float32).copy()).to(device)


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
