"""One intra-op thread for the port's CPU tests.

The suite runs under pytest-xdist, several workers to a machine. torch's
default intra-op pool holds a thread for every core in every worker, so the
workers' pools oversubscribe the cores, and the port's frames, thousands of
small tensor ops each, then wait on one another's threads far longer than
they compute. Their tensors are small enough that one thread loses little
when a file runs alone.

A test module takes the fixture by importing it:

    from tests.torch_threads import one_torch_thread  # noqa: F401
"""

from __future__ import annotations

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """torch on one intra-op thread for the module's tests, restored
    after them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
