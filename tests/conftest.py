"""Pytest settings shared by the test files: marker registration only."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "gpu: needs a CUDA device (the hand-written kernels have no CPU "
        "mode); skips with its reason where there is none")
