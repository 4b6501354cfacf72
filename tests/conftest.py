def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA GPU and nvcc (skips without them)")
