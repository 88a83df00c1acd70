"""Shared fixtures.  NOTE: no XLA_FLAGS here -- unit tests must see the
real single CPU device; multi-device behaviour is tested via
subprocesses (tests/test_multidevice.py) so the device count never
leaks into this process."""

import numpy as np
import pytest


def pytest_configure(config):
    # registered here as well as pyproject.toml so direct pytest
    # invocations from other rootdirs still know the marker
    config.addinivalue_line(
        "markers", "slow: multi-minute cases excluded from tier-1")
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skipped without one")


@pytest.fixture
def rng():
    return np.random.default_rng(0)
