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

On CUDA over NCCL the frame `shard_frame` returns replays one captured
CUDA graph per frame key on every rank, the islands' collectives inside
it: the counterpart of hikari_tpu's `jax.jit` of the sharded frame
(`ShardedFrame`). Under gloo (the CPU, or several ranks on one card) it
runs eagerly by rule: gloo stages CUDA tensors through the host, which no
graph can capture.

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

from hikari_tpu_torch import compiled
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


class ShardedFrame:
    """The sharded frame (what shard_frame returns as its function):
    fn(scene, view, frame, noise, carry) -> (image, albedo, carry), whole
    on every rank, frame_fn (frame.build_render_frame's function) run
    under row_mesh(mesh).

    Its inputs are static tensors (the arguments shard_frame returns): a
    scene, view, noise or carry leaf the caller passes that is not the
    static one is copied in. The frame uniform's words (frame_fn.words:
    what changes with its number, the settings' dynamic values) are
    staged into compiled.StaticInputs, one copy a frame. On CUDA over
    NCCL, outside compiled.eager(), every rank then replays the graph of
    the frame's key (frame_fn.key), captured at the key's first use
    through compiled.Graphs (a warm-up on a side stream, whose
    collectives make NCCL's communicator, then the capture); every rank
    meets the same keys in the same order, so the collectives inside the
    graphs pair up. Otherwise (gloo, the CPU, compiled.eager()) the frame
    runs eagerly. Either way the new carry is written into the static
    carry (compiled.commit), which is returned: a caller that passes it
    back costs no copy, as hikari_tpu's donated carry. The image and the
    albedo returned are tensors of their own."""

    def __init__(self, frame_fn, mesh: RowMesh, scene, view, noise, carry):
        from hikari_tpu_torch.frame import FRAME_WORDS

        self.frame_fn, self.mesh = frame_fn, mesh
        self.scene, self.view, self.noise = scene, view, noise
        self.carry = carry
        self._words = compiled.StaticInputs(FRAME_WORDS, mesh.device)
        captured = mesh.device.type == "cuda" and mesh.backend == "nccl"
        self._graphs = compiled.Graphs(mesh.device) if captured else None

    def graphed(self) -> bool:
        """Frames replay graphs: NCCL on CUDA, outside compiled.eager()."""
        return self._graphs is not None and not compiled.eager_active()

    def graph_keys(self) -> list:
        return [] if self._graphs is None else self._graphs.keys()

    def __call__(self, scene, view, frame, noise, carry):
        from hikari_tpu_torch.frame import with_words

        for static, given in ((self.scene, scene), (self.view, view),
                              (self.noise, noise), (self.carry, carry)):
            if given is not static:
                compiled.commit(static, given)
        self._words.write(self.frame_fn.words(frame))
        staged = with_words(frame, self._words.dev)

        def program(commit: bool):
            with row_mesh(self.mesh):
                image, albedo, new = self.frame_fn(
                    self.scene, self.view, staged, self.noise, self.carry)
            if commit:
                compiled.commit(self.carry, new)
            return image, albedo

        if self.graphed():
            image, albedo = self._graphs.run(self.frame_fn.key(frame),
                                             program)
            image, albedo = image.clone(), albedo.clone()
        else:
            image, albedo = program(True)
        return image, albedo, self.carry


def shard_frame(frame_fn, mesh: RowMesh, scene, view, frame, noise, carry,
                row_sizes=None):
    """The frame function with its kernels row-sharded over the mesh.

    Returns (fn, args): args are the inputs on the mesh's device (all of
    them on every rank, the carry too), fn a ShardedFrame over them:
    fn(*args), or fn(scene, view, frame uniform, noise, carry) for the
    next frame, runs frame_fn under row_mesh(mesh) and returns (image,
    albedo, carry), whole on every rank; on CUDA over NCCL as captured
    graphs, one per frame key (gloo runs eagerly by rule). row_sizes
    (hikari_tpu's rows to shard the carries by) is accepted for the same
    call and unused: the port keeps the carries whole."""
    del row_sizes
    scene, view, frame, noise, carry = replicated(
        mesh, (scene, view, frame, noise, carry))
    return (ShardedFrame(frame_fn, mesh, scene, view, noise, carry),
            (scene, view, frame, noise, carry))
