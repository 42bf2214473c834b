"""Intra-op threads of torch in the port's CPU tests.

The tier-1 command runs six pytest workers on the machine's cores, and
each worker's torch starts an OpenMP thread per core for every op it
parallelises: on an 8-core machine some 48 threads whose barriers wait on
each other. The port's test modules import `few_torch_threads`, an
autouse fixture, so that their torch ops run on TORCH_THREADS threads
(on an 8-core machine the whole suite ran in less than half the time
with two threads per process).
"""

import pytest
import torch

TORCH_THREADS = 2


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    """torch's intra-op threads at most TORCH_THREADS for the importing
    module's tests; the process's count restored after them."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, TORCH_THREADS))
    yield
    torch.set_num_threads(n)
