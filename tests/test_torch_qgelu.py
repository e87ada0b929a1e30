"""The int8 GELU kernel (``kernels/qgelu.py``, ``csrc/qgelu.cu``) and its
plain version.

On the CPU: ``qgelu_plain`` and the wrapper against the table indexed by
code + 128 for every code, ``dispatch.qgelu`` through the wrapper,
``execute(plain=True)`` through the plain version, and the Engine's
plan giving the kernel every GELU (``Engine.plan``). On the card (the ``cuda`` marker; skipped
without one, decided in the fixture): the kernel bit-equal to the plain
version on the card and on the CPU for every code, at ragged sizes, from
unaligned views, at a ConvNeXt-T and a ViT-B/16 node's b64 shape and inside
a captured CUDA graph. This file imports neither JAX nor tf2_tpu, so it
runs on a GPU machine without them:

    python -m pytest --noconftest tests/test_torch_qgelu.py -q
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tf2_tpu_torch import kernels
from tf2_tpu_torch.graph import Node, execute
from tf2_tpu_torch.kernels import dispatch, qblocks, qgelu
from tf2_tpu_torch.models import synthetic_quantized
from tf2_tpu_torch.runtime import Engine, spans
from tf2_tpu_torch.runtime.engine import Limits

# (s_in, s_out): ConvNeXt-T's synthetic scales, then ViT-like ones
# (tests/test_torch_vit.py::test_qgelu_matches_reference)
SCALES = [(0.02, 0.02), (0.05, 0.04)]
CARD = Limits(256, qblocks.SMEM_LIMIT)
CODES = np.arange(-128, 128, dtype=np.int8)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in parallel workers; one intra-op thread keeps these
    checks from starving the others."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _table(s_in, s_out, device="cpu"):
    return dispatch._qgelu_table(s_in, s_out, torch.device(device))


def _node(s_in, s_out):
    return Node("g", "qgelu", ("x",), (), {"s_in": s_in, "s_out": s_out})


# ---- the plain version, on the CPU ----

@pytest.mark.parametrize("s_in,s_out", SCALES)
def test_plain_is_the_table_for_every_code(s_in, s_out):
    """qgelu_plain and the wrapper (on a CPU tensor) give table[code + 128]
    for each of the 256 codes, in any order and shape, and launch
    nothing."""
    table = _table(s_in, s_out)
    assert table.dtype == torch.int8 and tuple(table.shape) == (256,)
    rng = np.random.default_rng(1)
    x = rng.permutation(np.concatenate([CODES, CODES])).reshape(2, 16, 16)
    want = table.numpy()[x.astype(np.int64) + 128]
    before = kernels.launch_counts()["qgelu"]
    for fn in (qgelu.qgelu_plain, qgelu.qgelu):
        got = fn(torch.as_tensor(x), table)
        assert got.dtype == torch.int8 and tuple(got.shape) == x.shape
        np.testing.assert_array_equal(got.numpy(), want)
    assert kernels.launch_counts()["qgelu"] == before


@pytest.mark.parametrize("plain", [False, True])
def test_dispatch_goes_through_the_wrapper(plain, monkeypatch):
    """dispatch.qgelu hands the node's table to the wrapper (which on a CPU
    tensor takes the plain version) or, with ``kernel="plain"``, to the plain
    version alone; the result is the table's."""
    calls = []
    for name in ("qgelu", "qgelu_plain"):
        def spy(x_q, table, _fn=getattr(qgelu, name), _name=name):
            calls.append(_name)
            return _fn(x_q, table)

        monkeypatch.setattr(qgelu, name, spy)
    x = torch.as_tensor(CODES).reshape(4, 64)
    got = dispatch.qgelu(_node(0.05, 0.04), {}, x, kernel="plain" if plain else None)
    assert calls == (["qgelu_plain"] if plain else ["qgelu", "qgelu_plain"])
    np.testing.assert_array_equal(got.numpy(), _table(0.05, 0.04).numpy()[CODES.astype(int) + 128]
                                  .reshape(4, 64))


def test_execute_plain_reaches_the_plain_version(monkeypatch):
    """qgelu is an op with a kernel: execute(plain=True) calls qgelu_plain for
    every GELU and never the wrapper; the default path calls the wrapper
    (which on the CPU takes the plain version)."""
    art = synthetic_quantized("vit_b16", batch=1, image=32, classes=10, dim=64, depth=2,
                              heads=2, weight_bits=8)
    eng = Engine(art.graph, art.params, device="cpu")
    gelus = sum(n.op == "qgelu" for n in eng.graph.nodes)
    assert gelus == 2
    calls = {"plain": 0, "kernel": 0}
    plain_fn, kernel_fn = qgelu.qgelu_plain, qgelu.qgelu

    def plain(*a, **kw):
        calls["plain"] += 1
        return plain_fn(*a, **kw)

    def kernel(*a, **kw):
        calls["kernel"] += 1
        return kernel_fn(*a, **kw)

    monkeypatch.setattr(qgelu, "qgelu_plain", plain)
    monkeypatch.setattr(qgelu, "qgelu", kernel)
    x = torch.as_tensor(np.random.default_rng(2).standard_normal((1, 32, 32, 3)),
                        dtype=torch.float32)
    want = execute(eng.graph, plain=True)(eng.params, image=x)
    assert calls == {"plain": gelus, "kernel": 0}
    assert torch.equal(eng.run(image=x), want)
    assert calls["kernel"] == gelus


@pytest.mark.parametrize("model,kwargs,want", [
    ("convnext_t", {"dims": (16, 32, 64, 128)}, 18),
    ("vit_b16", {"dim": 64, "heads": 2, "weight_bits": 8}, 12),
    ("resnet50", {}, 0),
])
def test_plan_counts_the_gelus(model, kwargs, want):
    """Engine.plan gives every int8 GELU the kernel: ConvNeXt-T's 18
    (depths 3-3-9-3), ViT-B/16's 12 (depth 12), ResNet-50's none; it leaves
    none of them plain."""
    art = synthetic_quantized(model, batch=1, image=32, classes=10, **kwargs)
    gelus = {n.name for n in art.graph.nodes if n.op == "qgelu"}
    assert len(gelus) == want
    plan = Engine.plan(art.graph, art.params, CARD)
    assert dispatch.nodes_on(plan, "qgelu") == gelus


def test_imports_without_cuda():
    """The module imports and the counter reads 0 where no card is visible;
    the library is not built at import."""
    code = ("import torch; from tf2_tpu_torch.kernels import qgelu as q; "
            "assert not torch.cuda.is_available(); "
            "assert q.LAUNCHES == {'qgelu': 0}; "
            "assert q._lib.cache_info().currsize == 0")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    subprocess.run([sys.executable, "-c", code], env=env, check=True, timeout=120,
                   cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


# ---- the kernel, on the card ----

def _check_kernel(dev, x, s_in, s_out):
    """The kernel's output on ``x`` (a CUDA tensor) against the plain
    version on the card and on the CPU: 0 mismatches; one launch."""
    table = _table(s_in, s_out, dev)
    before = kernels.launch_counts()["qgelu"]
    got = qgelu.qgelu(x, table)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["qgelu"] == before + 1
    assert got.shape == x.shape and got.dtype == torch.int8
    assert int((got != qgelu.qgelu_plain(x, table)).sum()) == 0
    assert int((got.cpu() != qgelu.qgelu_plain(x.cpu(), _table(s_in, s_out))).sum()) == 0
    return got


def _codes(n: int, dev, seed: int = 0) -> torch.Tensor:
    """n int8 codes: every one of the 256 codes, repeated, in a random
    order (the first min(n, 256) distinct)."""
    rng = np.random.default_rng(seed + n)
    x = np.resize(rng.permutation(CODES), n)
    return torch.as_tensor(x).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("s_in,s_out", SCALES)
@pytest.mark.parametrize("n", [1, 15, 16, 17, 256, 4097])
def test_kernel_every_code_ragged_sizes(cuda, n, s_in, s_out):
    _check_kernel(cuda, _codes(n, cuda), s_in, s_out)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", range(1, 16))
@pytest.mark.parametrize("n", [17, 4097])
def test_kernel_unaligned_views(cuda, offset, n):
    """An input view offset by 1-15 bytes from an aligned buffer: through
    the wrapper (its output aligned, so x and y differ in alignment), and
    through the library with the output offset by as much (the aligned body
    with a head and a tail)."""
    buf = _codes(n + 16, cuda, seed=offset)
    x = buf[offset:offset + n]
    assert x.data_ptr() % 16 == offset and x.is_contiguous()
    _check_kernel(cuda, x, 0.05, 0.04)
    table = _table(0.05, 0.04, cuda)
    out = torch.zeros(n + 16, dtype=torch.int8, device=cuda)
    rc = qgelu._lib().tf2_qgelu(x.data_ptr(), out[offset:].data_ptr(), table.data_ptr(), n,
                                torch.cuda.current_stream().cuda_stream)
    assert rc == 0
    torch.cuda.synchronize()
    assert torch.equal(out[offset:offset + n], qgelu.qgelu_plain(x, table))
    assert not out[:offset].any() and not out[offset + n:].any()


@pytest.mark.cuda
def test_kernel_refuses(cuda):
    """A non-contiguous input, another dtype or a CPU table raise before any
    launch."""
    table = _table(0.05, 0.04, cuda)
    before = kernels.launch_counts()["qgelu"]
    x = _codes(64 * 3, cuda).reshape(64, 3)
    for bad, t in ((x.t(), table), (x.to(torch.int16), table), (x, table.cpu()),
                   (x, table.to(torch.int16))):
        with pytest.raises(ValueError):
            qgelu.qgelu(bad, t)
    assert kernels.launch_counts()["qgelu"] == before


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(64, 56, 56, 384), (64, 196, 3072)])
def test_kernel_node_shapes_captured(cuda, shape):
    """A ConvNeXt-T stage-1 GELU's and a ViT-B/16 GELU's b64 input: the
    kernel host-launched and inside a captured CUDA graph (one launch
    counted at capture, none at replay), both equal to the plain version;
    the replay on new codes in the same buffer too."""
    rng = np.random.default_rng(5)
    x = torch.as_tensor(rng.integers(-128, 128, shape, dtype=np.int8)).to(cuda)
    table = _table(0.02, 0.02, cuda)
    want = qgelu.qgelu_plain(x, table)
    assert torch.equal(_check_kernel(cuda, x, 0.02, 0.02), want)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        qgelu.qgelu(x, table)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    before = kernels.launch_counts()["qgelu"]
    with torch.cuda.graph(graph):
        y = qgelu.qgelu(x, table)
    assert kernels.launch_counts()["qgelu"] == before + 1
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(y, want)
    x.copy_(torch.as_tensor(rng.integers(-128, 128, shape, dtype=np.int8)))
    graph.replay()
    torch.cuda.synchronize()
    assert kernels.launch_counts()["qgelu"] == before + 1
    assert torch.equal(y, qgelu.qgelu_plain(x, table))
