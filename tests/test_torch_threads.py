"""One intra-op torch thread for the port's test modules.

The suite runs several pytest workers on the same cores; a torch thread
pool of one thread a core in every worker oversubscribes them, and its
spinning threads slow every other worker's tests too (a 2.5 s model step
once took 230 s).  Every ``tests/test_torch_*.py`` module imports the
autouse fixture below, which holds one thread for the module and restores
the previous count after it.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
