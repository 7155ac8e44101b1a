"""A module-scoped autouse fixture for the port's CPU-heavy test files:
under pytest-xdist (``PYTEST_XDIST_WORKER`` set) the suite runs in
parallel workers, and torch's default of one intra-op thread per core in
each of them oversubscribes the cores, so there each worker keeps one
thread. Import it into a test module to apply it there."""

import os

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread_per_worker():
    n = torch.get_num_threads()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
