"""Row sharding of a frame across ranks (the port of hikari_tpu/parallel/):
one process per card over torch.distributed (NCCL; gloo on the CPU or for
several ranks on one card). The glue runs whole on every rank; each
hand-written kernel runs on its rank's rows (parallel/shard.py)."""

from hikari_tpu_torch.parallel.mesh import make_mesh, shard_frame  # noqa: F401
