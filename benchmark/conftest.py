"""pytest settings of the benchmark's own tests (python3 -m pytest
benchmark/tests): the marker of tests that need the card."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device; skipped without one")
