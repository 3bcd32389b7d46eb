"""The benchmark's CPU tests: no card, nvcc or triton. A test that needs the
card is marked `chip` and skips inside the `cuda` fixture."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a CUDA device; skipped without one")


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def _threads():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)  # tiny batched ops are slower threaded
    yield
    torch.set_num_threads(n)
