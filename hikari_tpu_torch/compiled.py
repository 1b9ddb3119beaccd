"""The compiled frame: what the jit of the frame, of the post-overlay, of
the debug frame and of the device refit is to hikari_tpu's Renderer, and
the jit of the sharded frame to its parallel/mesh.py, as captured CUDA
graphs for the port's Renderer and parallel/mesh.py ShardedFrame.

* `StaticInputs`: the frame's per-frame values (and the settings'
  dynamic values) in one pinned staging buffer and one device buffer,
  written before each frame by one host-to-device copy; the captured
  frame reads the device buffer, so a replay serves any frame number,
  camera pose, transform or retune of a dynamic setting.
* `Graphs`: one CUDA graph per key (the frame's branches, frame.py
  `render_frame.key`; the refit), captured at the key's first use after a
  warm-up run on a side stream, all in one shared memory pool, then
  replayed. A capture or replay that fails raises; nothing falls back to
  the eager frame.
* `eager()`: a context manager under which Renderer runs the frame as
  PyTorch eager code on CUDA too (jax.disable_jit's counterpart).

A shared pool is safe here because every graph's outputs are consumed
before the next replay: the carry and the scene are copied into their
static tensors inside the graph, and Renderer clones the image.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

_EAGER = [0]


@contextlib.contextmanager
def eager():
    """Run Renderer's frames, post-overlay and refit eagerly on CUDA while
    the context is open (the graphs are kept, not dropped)."""
    _EAGER[0] += 1
    try:
        yield
    finally:
        _EAGER[0] -= 1


def eager_active() -> bool:
    return _EAGER[0] > 0


class StaticInputs:
    """[n] float32 words on `device` that keep their address: `write`
    fills a pinned staging buffer and copies it to the device buffer `dev`
    on the current stream (one copy), after the previous copy has read
    the staging buffer."""

    def __init__(self, n: int, device):
        self.device = torch.device(device)
        cuda = self.device.type == "cuda"
        self.host = torch.zeros(n, dtype=torch.float32, pin_memory=cuda)
        self.dev = torch.zeros(n, dtype=torch.float32, device=self.device)
        self._copied = torch.cuda.Event() if cuda else None
        self._pending = False

    def write(self, words: np.ndarray):
        if self._pending:
            self._copied.synchronize()
        self.host.numpy()[:] = words
        if self._copied is None:
            self.dev.copy_(self.host)
            return
        self.dev.copy_(self.host, non_blocking=True)
        self._copied.record()
        self._pending = True


class Graphs:
    """CUDA graphs by key on one device, in one memory pool."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.pool = torch.cuda.graph_pool_handle()
        self.graphs = {}
        # a context manager factory entered around each capture (for
        # example to count the launches a graph holds), or None
        self.capture_context = None

    def run(self, key, program):
        """Replays key's graph, capturing it first at the key's first use:
        program(False) once as a warm-up on a side stream (it builds and
        binds the kernels and makes the constants; it must leave the
        state as it was), then program(True) under capture. Returns what
        program(True) returned at the capture: the graph's outputs, which
        the next replay of any graph of the pool may overwrite."""
        entry = self.graphs.get(key)
        if entry is None:
            entry = self._capture(program)
            self.graphs[key] = entry
        entry[0].replay()
        return entry[1]

    def _capture(self, program):
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            program(False)
        current.wait_stream(side)
        # the warm-up's work (its collectives too) done before the capture
        torch.cuda.synchronize(self.device)
        graph = torch.cuda.CUDAGraph()
        ctx = (self.capture_context() if self.capture_context is not None
               else contextlib.nullcontext())
        # "thread_local": other threads (such as a sharded frame's NCCL
        # watchdog) may call CUDA while this thread captures
        with ctx, torch.cuda.graph(graph, pool=self.pool,
                                   capture_error_mode="thread_local"):
            out = program(True)
        return graph, out

    def keys(self):
        return list(self.graphs)

    def clear(self):
        self.graphs.clear()


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}/")
    else:
        yield prefix[:-1], tree


def _storage(t):
    return t.untyped_storage().data_ptr()


def commit(static: dict, new: dict):
    """Writes the tree `new` into the tree of tensors `static` in place,
    leaf by leaf (the carry's donation). A leaf of `new` that is its
    static leaf is skipped; one that shares memory with another static
    leaf raises, since the copies would read what an earlier copy
    wrote."""
    dst = dict(_leaves(static))
    owners = {_storage(t): k for k, t in dst.items()}
    for k, t in _leaves(new):
        if k not in dst:
            raise KeyError(f"the frame returned a carry leaf {k!r} that "
                           "the static carry lacks")
        d = dst[k]
        if t is d:
            continue
        owner = owners.get(_storage(t))
        if owner is not None and owner != k:
            raise RuntimeError(f"carry leaf {k!r} aliases {owner!r}")
        d.copy_(t)
