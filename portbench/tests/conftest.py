"""CPU tests of the benchmark: one torch thread (a loaded host waits on
descheduled threads), and the `cuda` marker for tests that need the card
(they skip inside a fixture where there is none)."""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")
