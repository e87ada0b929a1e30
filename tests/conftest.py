"""Test env: force CPU with 8 virtual devices so sharding/collective tests
run without TPU hardware (SURVEY.md §5.4).

Something in the pytest plugin chain can import jax before this conftest
executes, so setting os.environ alone is not reliable — we also push the
config through jax.config, which works any time before backend init.
"""
import os

os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

import jax

jax.config.update("jax_platforms", "cpu")

assert jax.default_backend() == "cpu", (
    "tests must run on CPU; TPU was already initialized before conftest")
assert jax.local_device_count() == 8, "expected 8 virtual CPU devices"


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: long-running end-to-end drills (minutes)")
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU and nvcc; skipped without one")
