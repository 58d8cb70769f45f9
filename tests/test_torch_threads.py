"""One intra-op torch thread for the port's test modules.

The suite runs several pytest workers on the same cores; a torch thread
pool of one thread a core in every worker oversubscribes them, and its
spinning threads slow every other worker's tests too (a 2.5 s model step
once took 230 s).  Every ``tests/test_torch_*.py`` module imports the
autouse fixture below, which holds one thread for the module and restores
the previous count after it.

``shared_across_workers`` runs a module fixture's computation once for
all the workers of a run: a module fixture runs again in every worker
that gets one of its tests.
"""

import os
import pickle

import filelock
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def shared_across_workers(tmp_path_factory, name: str, compute):
    """``compute()``, once for all the pytest-xdist workers of a run: the
    first worker to ask computes it and pickles it under the run's shared
    temporary root, the others wait for it and load it.  Without xdist,
    ``compute()``."""
    if "PYTEST_XDIST_WORKER" not in os.environ:
        return compute()
    path = tmp_path_factory.getbasetemp().parent / f"{name}.pkl"
    with filelock.FileLock(f"{path}.lock"):
        if path.exists():
            with open(path, "rb") as f:
                return pickle.load(f)
        out = compute()
        with open(path, "wb") as f:
            pickle.dump(out, f, protocol=pickle.HIGHEST_PROTOCOL)
        return out
