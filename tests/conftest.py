"""Shared fixtures. NOTE: no XLA_FLAGS here by design — tests see the
real single CPU device; only the dry-run subprocess gets 512."""
import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card and skips without one; run on "
        "the card with `PYTHONPATH=src python -m pytest -m cuda "
        "tests/test_torch_*.py`")
