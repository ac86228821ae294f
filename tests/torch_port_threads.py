"""The port's test files pin torch to one thread while they run.

The suite runs on several xdist workers at once, and each worker's default
thread pool (every core) on top of the others' oversubscribes the machine
several times over; the port's test tensors are small enough that one
thread is faster.  A test file takes the fixture with one line:

    from torch_port_threads import one_torch_thread  # noqa: F401

(``tests/`` is on ``sys.path`` under pytest and when a file is run as a
script.)
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
