"""CPU tests of the benchmark: ``python -m pytest perfbench/tests -q``. A test
marked ``cuda`` needs the GPU and decides inside itself whether one is
there. One torch thread a worker: the tiny runs time their windows, and
workers that share the cores would otherwise slow each call many times."""


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU; skipped without one")
    import torch

    torch.set_num_threads(1)
