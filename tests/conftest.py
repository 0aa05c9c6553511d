import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: multi-device subprocess tests")
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; skips where there is none")
