"""The benchmark's CPU tests: each test process keeps to two threads, since
the test workers share the machine's cores."""

import pytest
import torch


@pytest.fixture(autouse=True)
def _two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)
