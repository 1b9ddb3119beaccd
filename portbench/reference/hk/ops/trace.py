"""The ray tracers of the modular lighting path and the non-fused
prepass, the port of hikari_tpu/ops/trace.py's make_tracer on the TPU.

`make_tracer(num_triangles, brute_force_max=768)` picks the engine once
per compiled scene. Scenes of at most `brute_force_max` triangles take the
small-scene engine (its Pallas branch, `kind` "brute_force_pallas") over
kernels 5, 6 and 7 (ops/trace_pallas.py), which take a table of any size:

* `trace`: kernel 5 over the scene table;
* `with_info`: kernel 5 plus the winner's attributes, `tri_attr[prim]`.
  hikari_tpu fetches them with a one-hot matmul (`hit_info_onehot`) up to
  256 rows and takes kernel 6 above that, because the matmul grows with
  the table; the index does not, and interpolates the winner's row with
  kernel 6's expressions, so it serves every table size;
* `shadow`: kernel 7 over the scene table.

Larger scenes take the engine of `kind` "cull" over kernel 13
(ops/trace_cull.py, a walk of the world BVH): `trace`, `with_info` and
`shadow` are its modes hit, full and shadow.

Both engines' `probe_info` is kernel 6 over the emissive-only table (the
probe ray is include-masked to one emitter, so only its triangles can
win) when that table has at most `brute_force_max` rows, else
`with_info` with the include mask (hikari_tpu/ops/trace.py:301-311),
whose rays kernel 13 walks through the emitter's own subtree (the
reference's "emitter's own BLAS"). The reference's `shape2d` /
`incoherent` hints only reorder its rays, so the port has none.
"""

from __future__ import annotations

import torch

from portbench.reference.hk.ops import trace_cull as _tc
from portbench.reference.hk.ops import trace_pallas as _tp
from portbench.reference.hk.utils.math import normalize

# hikari_tpu's default brute_force_max (its measured crossover of brute
# force and its tile-cull engine on the TPU)
BRUTE_FORCE_MAX = 768


def _ids(ids, n, device):
    """An int32 id per ray: `ids`, or -1 everywhere for None."""
    if ids is None:
        return torch.full((n,), -1, dtype=torch.int32, device=device)
    return ids.to(torch.int32).contiguous()


def hit_info(scene, ro, rd, hit):
    """hit_info_onehot's contract from a kernel-5 hit: {position [N,4],
    normal, uv, instance, material}, the attributes of row tri_attr[prim]
    interpolated at the hit's (u, v) as kernel 6 does (zeros and material
    -1 on a miss)."""
    normal, uv, mat = _tp.interpolate(scene["tri_attr"], hit["prim"],
                                      hit["u"], hit["v"])
    return {
        "position": _tp.hit_position(ro, rd, hit["t"], hit["prim"] < 0),
        "normal": normalize(torch.stack(normal, -1)),
        "uv": torch.stack(uv, -1),
        "instance": hit["instance"],
        "material": torch.round(mat).to(torch.int32),
    }


def probe_emissive_table(scene, ro, rd, max_t, exclude_instance=None,
                         include_instance=None):
    """Kernel 6 over the emissive-only table: the probe ray is
    include-masked to one emitter, so only its triangles can win."""
    n, dev = ro.shape[0], ro.device
    return _tp.brute_force_full(scene["em_tri_pos_flat"],
                                scene["em_tri_attr"], ro, rd, max_t,
                                _ids(exclude_instance, n, dev),
                                _ids(include_instance, n, dev))


class _Tracer:
    """An engine's probe rule: kernel 6 over an emissive table of at most
    `brute_force_max` rows, else the engine's own `with_info`."""

    def __init__(self, brute_force_max: int = BRUTE_FORCE_MAX):
        self.brute_force_max = brute_force_max

    def probe_info(self, scene, ro, rd, max_t, exclude_instance=None,
                   include_instance=None):
        if scene["em_tri_pos_flat"].shape[0] <= self.brute_force_max:
            return probe_emissive_table(scene, ro, rd, max_t,
                                        exclude_instance, include_instance)
        return self.with_info(scene, ro, rd, max_t, exclude_instance,
                              include_instance)


class BruteForceTracer(_Tracer):
    """The engine of scenes with at most `brute_force_max` triangles. Each
    call takes the scene dict, ray origins and directions [N,3] f32, max_t
    [N] f32 and optional int32 exclude / include instance ids [N] (None:
    -1)."""

    kind = "brute_force_pallas"

    def trace(self, scene, ro, rd, max_t, exclude_instance=None,
              include_instance=None):
        n, dev = ro.shape[0], ro.device
        return _tp.brute_force(scene["tri_pos_flat"], ro, rd, max_t,
                               _ids(exclude_instance, n, dev),
                               _ids(include_instance, n, dev))

    def with_info(self, scene, ro, rd, max_t, exclude_instance=None,
                  include_instance=None):
        hit = self.trace(scene, ro, rd, max_t, exclude_instance,
                         include_instance)
        info = hit_info(scene, ro, rd, hit)
        info["t"] = hit["t"]
        info["prim"] = hit["prim"]
        return info

    def shadow(self, scene, ro, rd, max_t, exclude_instance=None,
               include_instance=None):
        n, dev = ro.shape[0], ro.device
        return _tp.shadow(scene["tri_pos_flat"], ro, rd, max_t,
                          _ids(exclude_instance, n, dev),
                          _ids(include_instance, n, dev))


class BvhTracer(_Tracer):
    """The engine of scenes above `brute_force_max` triangles: kernel 13.
    The calls take BruteForceTracer's arguments; `probe_info`'s
    `with_info` walks the included emitter's own subtree
    (models/walk_tables.py), and the -2 "no pick" rays walk the world."""

    kind = "cull"

    def trace(self, scene, ro, rd, max_t, exclude_instance=None,
              include_instance=None):
        n, dev = ro.shape[0], ro.device
        raw = _tc.bvh_closest(scene, ro, rd, max_t,
                              _ids(exclude_instance, n, dev),
                              _ids(include_instance, n, dev))
        return {"t": raw["t"], "u": raw["u"], "v": raw["v"],
                "prim": raw["prim"], "instance": raw["inst"]}

    def with_info(self, scene, ro, rd, max_t, exclude_instance=None,
                  include_instance=None):
        n, dev = ro.shape[0], ro.device
        raw = _tc.bvh_full(scene, ro, rd, max_t,
                           _ids(exclude_instance, n, dev),
                           _ids(include_instance, n, dev))
        return _tp.full_info(raw, ro, rd)

    def shadow(self, scene, ro, rd, max_t, exclude_instance=None,
               include_instance=None):
        n, dev = ro.shape[0], ro.device
        raw = _tc.bvh_shadow(scene, ro, rd, max_t,
                             _ids(exclude_instance, n, dev),
                             _ids(include_instance, n, dev))
        return {"t": raw["t"], "instance": raw["inst"]}


def make_tracer(num_triangles: int, brute_force_max: int = BRUTE_FORCE_MAX):
    """The engine for a scene of `num_triangles` (built once per compiled
    scene): brute force up to `brute_force_max` triangles, else kernel
    13's BVH walk (hikari_tpu/ops/trace.py:331-406 on the TPU)."""
    if num_triangles <= brute_force_max:
        return BruteForceTracer(brute_force_max)
    return BvhTracer(brute_force_max)
