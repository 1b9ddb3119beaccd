"""A recorder of the operations a frame dispatches (no JAX: the gloo ranks
of tests/torch_dist.py import it too). Each kernel wrapper's plain version
is recorded as one opaque call (`install_opaque`), its own operations
unrecorded; a frame whose operations, shapes, dtypes and non-tensor
arguments repeat on another frame bakes in nothing of it."""

from __future__ import annotations

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from hikari_tpu_torch.ops import (denoise_fused, light_fused, prepass_fused,
                                  reproj_gather, spatial_fused,
                                  texture_pallas, trace_cull, trace_pallas,
                                  warp2, warp_band)

PLAINS = ((denoise_fused, "atrous_plain"), (light_fused, "lighting_plain"),
          (prepass_fused, "prepass_plain"), (prepass_fused, "quads_plain"),
          (reproj_gather, "gather_plain"), (spatial_fused, "spatial_plain"),
          (texture_pallas, "sample_atlas"), (trace_cull, "walk_plain"),
          (trace_pallas, "closest_plain"), (trace_pallas, "full_plain"),
          (trace_pallas, "shadow_plain"), (warp_band, "band_plain"),
          (warp2, "multi_plain"))
# operations that read a tensor back to the host or make one from host
# data: none may run in the frame's glue
HOST_OPS = ("aten._local_scalar_dense", "aten.nonzero", "aten.lift_fresh",
            "aten.item")


def masked_index(op, args):
    """An indexing by a boolean mask: its shape depends on the data (and
    on CUDA it reads the mask's count back to the host)."""
    return (op.startswith(("aten.index.Tensor", "aten.index_put"))
            and any(isinstance(i, tuple) and len(i) > 2
                    and i[2] == torch.bool for i in args[1]))


def host_reads(ops):
    """The recorded operations that read back to the host."""
    return [op for op, args, _ in ops
            if op.startswith(HOST_OPS) or masked_index(op, args)]


def signature(x):
    if isinstance(x, torch.Tensor):
        return ("T", tuple(x.shape), x.dtype, tuple(x.stride()),
                x.storage_offset())
    if isinstance(x, (list, tuple)):
        return tuple(signature(v) for v in x)
    if isinstance(x, dict):
        return tuple((k, signature(v)) for k, v in sorted(x.items()))
    if isinstance(x, float):
        return ("f", repr(x))
    if isinstance(x, torch._C.ScriptObject):
        # such as a collective's process group, which has no == (a
        # point-to-point batch passes a group object of its own)
        return ("object",)
    return x


class Recorder(TorchDispatchMode):
    """Every dispatched operation (name, argument signatures); a plain
    version of a kernel wrapper is one entry, its operations unrecorded."""

    def __init__(self):
        super().__init__()
        self.ops = []
        self.quiet = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if not self.quiet:
            self.ops.append((str(func), signature(args), signature(kwargs)))
        return func(*args, **kwargs)


def install_opaque(rec, setattr_):
    """Replaces every plain version of PLAINS (through `setattr_(module,
    name, fn)`, such as monkeypatch.setattr) by one that `rec` records as
    one entry."""
    for mod, name in PLAINS:
        fn = getattr(mod, name)

        def opaque(*a, _fn=fn, _name=name, **k):
            if not rec.quiet:
                rec.ops.append((f"plain:{_name}", signature(a),
                                signature(k)))
            rec.quiet += 1
            try:
                return _fn(*a, **k)
            finally:
                rec.quiet -= 1

        setattr_(mod, name, opaque)


def first_difference(a, b):
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return i, x, y
    return len(a), len(a), len(b)
