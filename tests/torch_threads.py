"""torch's CPU thread count for the port's test modules.

The tier-1 run puts several pytest-xdist workers on one machine, and by
default torch gives each worker one intra-op thread per core: the workers'
threads then outnumber the cores several times over and spin against each
other, which makes the port's files several times slower than they run
alone. A test module that imports ``torch_threads`` (the autouse fixture
below) runs torch on ``TORCH_THREADS`` threads and restores the count when
it ends. The module imports no JAX, so the card-only tests can use it.
"""

import pytest
import torch

TORCH_THREADS = 2


@pytest.fixture(scope="module", autouse=True)
def torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(TORCH_THREADS)
    yield TORCH_THREADS
    torch.set_num_threads(before)
