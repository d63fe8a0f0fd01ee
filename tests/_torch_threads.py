"""One intra-op thread for the port's CPU tests.

The port's CPU tests run the plain PyTorch versions on smoke-size tensors:
thousands of tiny ops, each of which ATen would spread over every core.
Under ``pytest -n`` several such processes share the cores, and the thread
pools then spend their time waiting on each other (an op on a [3, 64]
tensor took ~10 ms instead of ~50 us).  A test module imports the fixture
below (``from _torch_threads import one_torch_thread  # noqa: F401``) to
run its torch ops on one thread; the count is restored after the module.
"""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
