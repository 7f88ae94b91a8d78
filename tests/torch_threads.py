"""One torch thread in each pytest-xdist worker, for the port's tests.

The test run's workers share the host's cores, and torch's own thread pool
beside them made CPU-heavy tests many times slower (the CPU bench run
took 583 s so in the six-worker run). A test module that imports
``one_torch_thread`` runs torch on one thread while its tests run under
pytest-xdist (``PYTEST_XDIST_WORKER`` set) and restores the count after
them. Run alone, torch keeps its default.
"""

import os

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    if not os.environ.get("PYTEST_XDIST_WORKER"):
        yield
        return
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
