"""A module-scoped fixture for the port's CPU tests: one intra-op thread.

The tier-1 run gives each of several pytest workers a share of the cores,
while PyTorch's intra-op pool in each worker starts a thread per core.
The pools then contend, and tests of small models that take seconds alone
ran 30 to 70 times as long (a warp-search emulation over 20 minutes on an
8-core machine).  A test module imports ``one_intra_op_thread`` to run on
one thread; its checks hold the port to itself or to the JAX package
within stated tolerances, whatever the thread count.  This module holds
no test of its own."""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
