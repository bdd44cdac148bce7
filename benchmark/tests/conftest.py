"""The benchmark's own tests: CPU tests at TINY sizes, and tests marked
``cuda`` that decide inside the test whether there is a card."""


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card (skips itself without one)")
