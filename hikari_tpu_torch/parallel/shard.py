"""Row sharding of the hand-written kernels over torch.distributed: the
port of hikari_tpu/parallel/shard.py.

hikari_tpu row-shards a frame under GSPMD and runs each Pallas kernel as a
`shard_map` island over its own rows. PyTorch has no GSPMD, so the port
keeps one rule instead: the PyTorch glue runs whole on every rank, on the
same data with the same ops (every rank holds the same words), and each
hand-written kernel runs sharded exactly where hikari_tpu runs it as an
island. An island takes its rank's equal block of rows (`local_rows`),
fetches its halo rows from the neighbouring ranks (`halo_rows`, a single
hop of point-to-point sends), runs the kernel's wrapper on the block, and
all-gathers the output rows back into whole tensors (`gather_rows`), which
the glue goes on with. The islands:

* pixel-local kernels (A, 8, B / 4): plain row blocks; kernel A takes its
  block's first global row in its parameters;
* the a-trous level (C): a halo of 2 * step rows before each level, the
  block's first global row and the image's rows for the out-of-image taps;
* the reprojection gather (9): SHARD_HALO rows, the source rows rebased
  into the halo-extended block; a source beyond the halo rejects;
* the history warps (11, 12): halo rows with replicated image edges
  (`sampler_rows`), the source coords clamped in global coordinates, then
  rebased; beyond the halo they clamp to the halo-extended block.

A mesh is active inside `row_mesh(mesh)` (parallel/mesh.py shard_frame
enters it around the frame); without one every wrapper runs whole.

Collectives: `dist.all_gather_into_tensor` under NCCL (into the whole
tensor's rows; a captured frame replays it, parallel/mesh.py), the list
form `dist.all_gather` under gloo, and `dist.batch_isend_irecv` for the
halo rows. Under gloo, CUDA tensors are staged through the host (gloo
moves host tensors; two ranks on one card cannot use NCCL), which no CUDA
graph can capture.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses

import torch
import torch.distributed as dist

_MESH = contextvars.ContextVar("hikari_torch_row_mesh", default=None)


@dataclasses.dataclass(frozen=True)
class RowMesh:
    """The row axis of a frame (hikari_tpu's "sp" mesh axis): the process
    group, this process's rank in it, the number of ranks and the device
    this rank's tensors live on."""
    group: object
    rank: int
    n: int
    device: torch.device
    backend: str

    @property
    def staged(self) -> bool:
        """Collectives go through host copies (gloo with CUDA tensors)."""
        return self.backend == "gloo" and self.device.type == "cuda"


def active_mesh():
    """The mesh the frame runs under, or None."""
    return _MESH.get()


@contextlib.contextmanager
def row_mesh(mesh):
    tok = _MESH.set(mesh)
    try:
        yield
    finally:
        _MESH.reset(tok)


def nshards(mesh) -> int:
    return mesh.n


def block_rows(h: int, n: int, mult: int = 1) -> int:
    """Rows of each rank's block: ceil(h / n), rounded up to a multiple of
    `mult`."""
    hl = -(-h // n)
    return -(-hl // mult) * mult


def pad_rows_to(x, rows: int, axis: int = 0, mode: str = "constant",
                value: float = 0.0):
    """x with its `axis` padded at the end to `rows` rows: copies of the
    last row (mode "edge") or `value` ("constant"). Returns (padded,
    original rows)."""
    h = x.shape[axis]
    if rows <= h:
        return x, h
    shape = list(x.shape)
    shape[axis] = rows - h
    if mode == "edge":
        tail = x.narrow(axis, h - 1, 1).expand(shape)
    elif mode == "constant":
        tail = x.new_full(shape, value)
    else:
        raise ValueError(f"pad mode {mode!r}")
    return torch.cat([x, tail], axis), h


def local_rows(x, mesh, hl: int, axis: int = 0, mode: str = "constant",
               value: float = 0.0):
    """This rank's block of rows [rank * hl, (rank + 1) * hl) of x, the
    rows past x's end padded (pad_rows_to's modes). A block inside x is a
    view."""
    h = x.shape[axis]
    r0 = mesh.rank * hl
    if r0 + hl <= h:
        return x.narrow(axis, r0, hl)
    if r0 < h:
        return pad_rows_to(x.narrow(axis, r0, h - r0), hl, axis, mode,
                           value)[0]
    # a block wholly past the end: padding only
    shape = list(x.shape)
    shape[axis] = hl
    if mode == "edge":
        return x.narrow(axis, h - 1, 1).expand(shape).contiguous()
    return x.new_full(shape, value)


def _to_wire(t, mesh):
    return t.cpu() if mesh.staged else t


def _from_wire(t, mesh):
    return t.to(mesh.device) if mesh.staged else t


def halo_rows(x, up: int, down: int, mesh, axis: int = 0,
              edge: str = "zero"):
    """x (this rank's block) extended by `up` rows of the previous rank's
    block above and `down` rows of the next rank's below, by point-to-point
    sends to the neighbours.

    edge="zero": zeros beyond the first and last blocks (the kernels mask
    or reject reads there). edge="replicate": the first and last blocks
    repeat their own edge row, as the single-device samplers clamp to the
    edge (value warps must use this)."""
    if up == 0 and down == 0:
        return x
    hl = x.shape[axis]
    assert up <= hl and down <= hl, (
        "halo exceeds the local block (single-hop exchange)")
    if edge not in ("zero", "replicate"):
        raise ValueError(f"halo edge {edge!r}")
    r, n = mesh.rank, mesh.n
    x = x.contiguous()

    def edge_rows(row, count):
        shape = list(x.shape)
        shape[axis] = count
        if edge == "replicate":
            return x.narrow(axis, row, 1).expand(shape)
        return x.new_zeros(shape)

    ops, recvs = [], {}
    if up and r + 1 < n:
        ops.append(dist.P2POp(dist.isend, _to_wire(
            x.narrow(axis, hl - up, up).contiguous(), mesh), r + 1,
            mesh.group))
    if down and r > 0:
        ops.append(dist.P2POp(dist.isend, _to_wire(
            x.narrow(axis, 0, down).contiguous(), mesh), r - 1, mesh.group))
    for side, count, peer in (("top", up, r - 1), ("bottom", down, r + 1)):
        if count and 0 <= peer < n:
            shape = list(x.shape)
            shape[axis] = count
            buf = torch.empty(shape, dtype=x.dtype,
                              device="cpu" if mesh.staged else x.device)
            recvs[side] = buf
            ops.append(dist.P2POp(dist.irecv, buf, peer, mesh.group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    parts = []
    if up:
        parts.append(_from_wire(recvs["top"], mesh) if "top" in recvs
                     else edge_rows(0, up))
    parts.append(x)
    if down:
        parts.append(_from_wire(recvs["bottom"], mesh) if "bottom" in recvs
                     else edge_rows(hl - 1, down))
    return torch.cat(parts, axis)


def sampler_rows(x, halo: int, mesh):
    """A block of a sampler's source rows (axis 0) for coords rebased by
    subtraction: halo_rows(x, halo, halo, edge="replicate"), except that
    the first block keeps no rows above it. Returns (rows, base), base the
    image row of rows[0] (rank * block - halo, 0 for the first block).

    A coord c in image rows becomes c - base. For c >= base >= 0 with base
    an integer the subtraction is exact; the first block's base would be
    -halo, and c + halo rounds. The rows it drops hold copies of row 0,
    which the sampler's clamp to the edge reads in their place."""
    rows = halo_rows(x, halo, halo, mesh, edge="replicate")
    if mesh.rank == 0:
        return rows.narrow(0, halo, rows.shape[0] - halo), 0
    return rows, mesh.rank * x.shape[0] - halo


def gather_rows(outs, mesh, h: int, axes=0):
    """All-gathers each rank's blocks `outs` (a list of tensors, each with
    its rows on `axes`, an int or one per tensor) into whole tensors of `h`
    rows, contiguous, in one collective: the blocks travel as the bytes of
    one [hl, bytes] buffer, gathered into one [n * hl, bytes] buffer
    (all_gather_into_tensor; under gloo the list form and a cat)."""
    if isinstance(axes, int):
        axes = [axes] * len(outs)
    hl = outs[0].shape[axes[0]]
    rows = [o.movedim(a, 0).contiguous() for o, a in zip(outs, axes)]
    flat = [t.reshape(hl, -1).view(torch.uint8) for t in rows]
    buf = _to_wire(torch.cat(flat, 1) if len(flat) > 1 else flat[0], mesh)
    if mesh.backend == "nccl":
        whole = buf.new_empty((mesh.n * hl, buf.shape[1]))
        dist.all_gather_into_tensor(whole, buf, group=mesh.group)
    else:
        parts = [torch.empty_like(buf) for _ in range(mesh.n)]
        dist.all_gather(parts, buf, group=mesh.group)
        whole = _from_wire(torch.cat(parts, 0), mesh)
    result, c0 = [], 0
    for t, f, a in zip(rows, flat, axes):
        c1 = c0 + f.shape[1]
        cols = whole if len(flat) == 1 else whole[:, c0:c1].contiguous()
        full = cols.view(t.dtype).reshape((mesh.n * hl,) + t.shape[1:])
        full = full.narrow(0, 0, h).movedim(0, a)
        result.append(full if a == 0 else full.contiguous())
        c0 = c1
    return result


def island(fn, mesh, h: int, hl: int, *rows, axis: int = 0,
           out_axis: int = 0):
    """Runs fn on this rank's block of each of `rows` (local_rows: zero
    padding; pad first with pad_rows_to for another fill) and all-gathers
    its outputs back into whole tensors of `h` rows (the counterpart of
    hikari_tpu's smap). fn returns a tensor, or a list, tuple or dict of
    tensors, each with its rows on `out_axis`."""
    out = fn(*(local_rows(x, mesh, hl, axis) for x in rows))
    if torch.is_tensor(out):
        return gather_rows([out], mesh, h, out_axis)[0]
    if isinstance(out, dict):
        keys = list(out)
        return dict(zip(keys, gather_rows([out[k] for k in keys], mesh, h,
                                          out_axis)))
    return type(out)(gather_rows(list(out), mesh, h, out_axis))
