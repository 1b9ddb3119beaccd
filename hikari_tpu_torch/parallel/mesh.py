"""The row mesh and the sharded frame step (the port of
hikari_tpu/parallel/mesh.py).

hikari_tpu shards every per-pixel tensor of a frame by rows under GSPMD
and replicates the scene, view, frame uniform and noise. The port runs
one process per rank over torch.distributed instead: the scene, view,
frame uniform, noise and the carries are whole on every rank, the glue
runs whole on every rank, and the hand-written kernels run on their
rank's rows as islands (parallel/shard.py), whose outputs are gathered
back into whole tensors. So `shard_frame` returns the same image, albedo
and carry on every rank.

The caller starts the processes and initialises the default process
group (`torch.distributed.init_process_group`, with NCCL for one card per
rank, gloo on the CPU or for several ranks on one card), then:

    mesh = make_mesh()                    # rank r on cuda:r
    fn, args = shard_frame(frame_fn, mesh, scene, view, frame, noise,
                           carry, row_sizes)
    image, albedo, carry = fn(*args)
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from hikari_tpu_torch.parallel.shard import RowMesh, row_mesh


def make_mesh(n: int | None = None, device=None) -> RowMesh:
    """The row mesh of the initialised default process group: every rank
    of it (n, when given, must equal the world size). Rank r runs on
    cuda:r unless `device` says otherwise ("cpu", or one card for every
    rank); without CUDA and without a device it raises (no CPU
    fallback)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(torch.distributed.init_process_group)")
    world = dist.get_world_size()
    if n is not None and n != world:
        raise ValueError(f"a mesh of {n} ranks in a group of {world}")
    rank = dist.get_rank()
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh puts rank r on cuda:r and no CUDA "
                               "device is available; pass device='cpu'")
        if rank >= torch.cuda.device_count():
            raise RuntimeError(f"rank {rank} has no card of its own "
                               f"({torch.cuda.device_count()} visible)")
        device = torch.device("cuda", rank)
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    return RowMesh(group=dist.group.WORLD, rank=rank, n=world,
                   device=device, backend=str(dist.get_backend()))


def replicated(mesh: RowMesh, tree):
    """The leaves of a (nested dict / list) tree on the mesh's device:
    every rank holds all of it."""
    if isinstance(tree, dict):
        return {k: replicated(mesh, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(replicated(mesh, v) for v in tree)
    if torch.is_tensor(tree):
        return tree.to(mesh.device)
    return tree


def shard_frame(frame_fn, mesh: RowMesh, scene, view, frame, noise, carry,
                row_sizes=None):
    """The frame function with its kernels row-sharded over the mesh.

    Returns (fn, args): args are the inputs on the mesh's device (all of
    them on every rank, the carry too); fn(*args) runs frame_fn under
    row_mesh(mesh) and returns (image, albedo, carry), whole on every
    rank. row_sizes (hikari_tpu's rows to shard the carries by) is
    accepted for the same call and unused: the port keeps the carries
    whole."""
    del row_sizes

    def fn_meshed(*a):
        with row_mesh(mesh):
            return frame_fn(*a)

    return fn_meshed, replicated(mesh, (scene, view, frame, noise, carry))
