def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU and nvcc; skips without one "
        "(on the card: python -m pytest -q -m cuda tests/test_torch_cuda.py)")
