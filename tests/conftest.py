"""Test-suite pytest settings: registers the ``cuda`` marker."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs a CUDA device (hand-written kernels have no CPU mode); "
        "skips without one")
