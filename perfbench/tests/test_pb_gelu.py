"""The int8 GELU kernel's metric: ``gelu_ms`` reads the families named
``qgelu`` of a fabricated slice over its calls, and nothing where there is
none."""
from types import SimpleNamespace

import pytest

from perfbench.metrics import gelu_ms


def _run(ops, calls=4, traced=True):
    s = SimpleNamespace(device_ops=ops, calls=calls) if traced else None
    return SimpleNamespace(window=SimpleNamespace(slice=s))


def test_gelu_ms_reads_the_kernel_family():
    run = _run([["qmatmul_pot4", 9e-3], ["torch:qgelu_kernel", 1.6e-3],
                ["torch:qdwconv_kernel", 2e-3]])
    assert gelu_ms.read(run) == pytest.approx(0.4)
    assert gelu_ms.read(_run([["torch:qgelu_kernel", 1.2e-3]], calls=3)) == pytest.approx(0.4)


@pytest.mark.parametrize("ops", [[["qmatmul_pot4", 9e-3]],
                                 [["torch:index_elementwise_kernel", 2.5e-3]], []])
def test_gelu_ms_is_none_without_the_kernel(ops):
    """The parent's gather (``index_elementwise_kernel``) is not the kernel;
    an untraced run has no slice."""
    assert gelu_ms.read(_run(ops)) is None
    assert gelu_ms.read(_run(ops, traced=False)) is None
