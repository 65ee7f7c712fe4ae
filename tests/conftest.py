import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: long-running (subprocess / multi-device) test"
    )
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device and nvcc (skips without them)"
    )


@pytest.fixture
def rng():
    return np.random.default_rng(0)
