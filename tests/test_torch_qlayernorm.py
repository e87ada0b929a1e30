"""The int8 layer norm kernel (``kernels/qlayernorm.py``,
``csrc/qlayernorm.cu``) and its plain version.

On the CPU: ``qlayernorm_plain`` against a numpy model of the same steps
(exact integer sums, float64 divisions, then f32 operations, each
correctly rounded in numpy), ``dispatch.qlayernorm`` on it, ``covers``,
the Engine's coverage plan and ``execute(plain=True)``. On the card (the
``cuda`` marker; skipped without one, decided in the fixture): the kernel
against the plain version on the card and on the CPU, with 0 mismatches.
This file imports neither JAX nor tf2_tpu, so it runs on a GPU machine
without them:

    python -m pytest --noconftest tests/test_torch_qlayernorm.py -q
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tf2_tpu_torch import kernels
from tf2_tpu_torch.graph import Node, execute
from tf2_tpu_torch.kernels import dispatch, qlayernorm
from tf2_tpu_torch.models import synthetic_quantized
from tf2_tpu_torch.runtime import Engine
from tf2_tpu_torch.runtime.engine import Limits

# (s_in, s_out) of tests/test_torch_vit.py::test_qlayernorm_matches_reference
SCALES = [(0.05, 0.04), (0.011, 0.023), (0.3, 0.02)]
EPS = 1e-6


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


def _model(x, gamma, beta, eps, s_in, s_out):
    """The layer norm's steps in numpy: S1, S2 in int64, mu and var as
    float64 divisions rounded once to f32, then one f32 operation a step."""
    d = x.shape[-1]
    xi = x.astype(np.int64)
    s1 = xi.sum(-1, keepdims=True)
    s2 = (xi * xi).sum(-1, keepdims=True)
    mu = (s1.astype(np.float64) / float(d)).astype(np.float32)
    var = ((d * s2 - s1 * s1).astype(np.float64) / float(d * d)).astype(np.float32)
    inv = np.float32(1.0) / np.sqrt(var + np.float32(eps / (s_in * s_in)))
    so = np.float32(s_out)
    y = ((x.astype(np.float32) - mu) * inv) * (gamma / so) + beta / so
    return np.clip(np.rint(y), -127, 127).astype(np.int8)


def _rows(kind: str, m: int, d: int, rng) -> np.ndarray:
    """Rows of int8 codes: random; equal codes (variance 0, the eps term
    alone); +-127 at random; alternating +-127 (the largest S2 and D * S2 -
    S1^2); and -128 to 127 at random."""
    if kind == "random":
        return rng.integers(-127, 128, (m, d), dtype=np.int8)
    if kind == "equal":
        return np.repeat(rng.integers(-127, 128, (m, 1), dtype=np.int8), d, axis=1)
    if kind == "pm127":
        return np.where(rng.random((m, d)) < 0.5, -127, 127).astype(np.int8)
    if kind == "alternating":
        return np.tile(np.array([127, -127], np.int8), (m, d // 2))
    return rng.integers(-128, 128, (m, d), dtype=np.int8)


def _affine(d: int, rng):
    gamma = (1 + 0.3 * rng.standard_normal(d)).astype(np.float32)
    beta = (0.2 * rng.standard_normal(d)).astype(np.float32)
    return gamma, beta


# ---- the plain version, on the CPU ----

@pytest.mark.parametrize("kind", ["random", "equal", "pm127", "alternating", "full"])
@pytest.mark.parametrize("s_in,s_out", SCALES)
@pytest.mark.parametrize("m,d", [(1, 768), (197, 768), (5, 8), (9, 200), (3, 1032)])
def test_plain_matches_numpy_model(kind, s_in, s_out, m, d):
    rng = np.random.default_rng(m * 7 + d)
    x = _rows(kind, m, d, rng)
    gamma, beta = _affine(d, rng)
    want = _model(x, gamma, beta, EPS, s_in, s_out)
    got = qlayernorm.qlayernorm_plain(torch.as_tensor(x), torch.as_tensor(gamma),
                                      torch.as_tensor(beta), eps=EPS, s_in=s_in, s_out=s_out)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("plain", [False, True])
def test_dispatch_takes_the_module(plain):
    """The node's attrs and params reach the module; on CPU tensors the
    wrapper takes the plain version and launches nothing. A node without
    eps takes 1e-6."""
    rng = np.random.default_rng(4)
    x = rng.integers(-127, 128, (2, 17, 64), dtype=np.int8)
    gamma, beta = _affine(64, rng)
    before = kernels.launch_counts()["qlayernorm"]
    for attrs, eps in (({"eps": 1e-5, "s_in": 0.05, "s_out": 0.04}, 1e-5),
                       ({"s_in": 0.05, "s_out": 0.04}, 1e-6)):
        got = dispatch.qlayernorm(Node("ln", "qlayernorm", ("x",), ("g", "b"), attrs),
                                  {"g": torch.as_tensor(gamma), "b": torch.as_tensor(beta)},
                                  torch.as_tensor(x), kernel="plain" if plain else None)
        np.testing.assert_array_equal(got.numpy(), _model(x, gamma, beta, eps, 0.05, 0.04))
    assert kernels.launch_counts()["qlayernorm"] == before


def test_plain_runs_on_meta():
    """activation_shapes runs the plain version on meta tensors."""
    x = torch.empty((3, 197, 768), dtype=torch.int8, device="meta")
    g = torch.empty(768, dtype=torch.float32, device="meta")
    y = qlayernorm.qlayernorm_plain(x, g, g, eps=EPS, s_in=0.05, s_out=0.04)
    assert y.shape == x.shape and y.dtype == torch.int8 and y.device.type == "meta"


@pytest.mark.parametrize("d,takes", [(8, True), (768, True), (1032, True), (4096, True),
                                     (0, False), (4, False), (772, False), (4104, False)])
def test_covers(d, takes):
    assert qlayernorm.covers(d) is takes


@pytest.mark.parametrize("dim", [36, 64])
def test_plan_leaves_uncovered_widths_plain(dim):
    """Engine.plan names a qlayernorm node exactly when covers refuses its
    input's width (36 is not a multiple of 8; 64 is)."""
    art = synthetic_quantized("vit_b16", batch=1, image=32, classes=10, dim=dim, depth=1,
                              heads=2, weight_bits=8)
    eng = Engine(art.graph, art.params, device="cpu")
    lns = {n.name for n in eng.graph.nodes if n.op == "qlayernorm"}
    assert len(lns) == 3
    plan = Engine.plan(eng.graph, eng.params, Limits(8000, 200_000))
    assert {plan[n] for n in lns} == {"qlayernorm" if qlayernorm.covers(dim) else "plain"}


def test_execute_plain_reaches_the_plain_version(monkeypatch):
    """execute(plain=True) and a plan naming them plain call qlayernorm_plain
    for every layer norm and never the kernel's wrapper; the default path calls the
    wrapper (which on the CPU takes the plain version)."""
    art = synthetic_quantized("vit_b16", batch=1, image=32, classes=10, dim=64, depth=1,
                              heads=2, weight_bits=8)
    eng = Engine(art.graph, art.params, device="cpu")
    lns = frozenset(n.name for n in eng.graph.nodes if n.op == "qlayernorm")
    calls = {"plain": 0, "kernel": 0}
    plain_fn, kernel_fn = qlayernorm.qlayernorm_plain, qlayernorm.qlayernorm

    def plain(*a, **kw):
        calls["plain"] += 1
        return plain_fn(*a, **kw)

    def kernel(*a, **kw):
        calls["kernel"] += 1
        return kernel_fn(*a, **kw)

    monkeypatch.setattr(qlayernorm, "qlayernorm_plain", plain)
    monkeypatch.setattr(qlayernorm, "qlayernorm", kernel)
    x = torch.as_tensor(np.random.default_rng(2).standard_normal((1, 32, 32, 3)),
                        dtype=torch.float32)
    want = execute(eng.graph, plain=True)(eng.params, image=x)
    assert calls == {"plain": len(lns), "kernel": 0}
    assert torch.equal(execute(eng.graph, kernels=dict.fromkeys(lns, "plain"))(
        eng.params, image=x), want)
    assert calls == {"plain": 2 * len(lns), "kernel": 0}
    assert torch.equal(eng.run(image=x), want)
    assert calls["kernel"] == len(lns)


def test_imports_without_cuda():
    """The module imports, covers answers and the counter reads 0 where no
    card is visible; the library is not built at import."""
    code = ("import torch; from tf2_tpu_torch.kernels import qlayernorm as q; "
            "assert not torch.cuda.is_available(); "
            "assert q.covers(768) and q.LAUNCHES == {'qlayernorm': 0}; "
            "assert q._lib.cache_info().currsize == 0")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    subprocess.run([sys.executable, "-c", code], env=env, check=True, timeout=120,
                   cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


# ---- the kernel, on the card ----

def _check_kernel(dev, x, gamma, beta, s_in, s_out):
    """The kernel's output against the plain version on the card and on
    the CPU: 0 mismatches; one launch."""
    kw = dict(eps=EPS, s_in=s_in, s_out=s_out)
    xd, gd, bd = (torch.as_tensor(a).to(dev) for a in (x, gamma, beta))
    before = kernels.launch_counts()["qlayernorm"]
    got = qlayernorm.qlayernorm(xd, gd, bd, **kw)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["qlayernorm"] == before + 1
    assert got.shape == xd.shape and got.dtype == torch.int8
    on_card = qlayernorm.qlayernorm_plain(xd, gd, bd, **kw)
    on_cpu = qlayernorm.qlayernorm_plain(*(torch.as_tensor(a) for a in (x, gamma, beta)), **kw)
    assert int((got != on_card).sum()) == 0
    assert int((got.cpu() != on_cpu).sum()) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("s_in,s_out", SCALES)
@pytest.mark.parametrize("m", [1, 196, 197, 12544])
def test_kernel_random_rows(cuda, m, s_in, s_out):
    rng = np.random.default_rng(m)
    _check_kernel(cuda, _rows("random", m, 768, rng), *_affine(768, rng), s_in, s_out)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["equal", "pm127", "alternating", "full"])
@pytest.mark.parametrize("s_in,s_out", SCALES)
def test_kernel_edge_rows(cuda, kind, s_in, s_out):
    rng = np.random.default_rng(11)
    _check_kernel(cuda, _rows(kind, 197, 768, rng), *_affine(768, rng), s_in, s_out)


@pytest.mark.cuda
@pytest.mark.parametrize("m,d", [(9, 8), (33, 200), (130, 1032), (7, 4096)])
@pytest.mark.parametrize("kind", ["random", "alternating", "full"])
def test_kernel_other_widths(cuda, m, d, kind):
    """Widths of one word a row up to MAX_WIDTH, with rows that leave lanes
    idle (200 and 1032 codes are 25 and 129 words)."""
    rng = np.random.default_rng(d)
    _check_kernel(cuda, _rows(kind, m, d, rng).reshape(m, 1, d), *_affine(d, rng), 0.05, 0.04)


@pytest.mark.cuda
def test_kernel_refuses(cuda):
    """Widths covers refuses, a misaligned row and a wrong dtype raise; the
    kernel's own limit is MAX_WIDTH; no launch counts."""
    assert qlayernorm.max_width() == qlayernorm.MAX_WIDTH
    kw = dict(eps=EPS, s_in=0.05, s_out=0.04)
    before = kernels.launch_counts()["qlayernorm"]
    for d in (772, 4104):
        g = torch.ones(d, device=cuda)
        with pytest.raises(ValueError, match="rows of"):
            qlayernorm.qlayernorm(torch.zeros((3, d), dtype=torch.int8, device=cuda), g, g, **kw)
    g = torch.ones(768, device=cuda)
    flat = torch.zeros(2 * 768 + 4, dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError, match="aligned"):
        qlayernorm.qlayernorm(flat[4:].view(2, 768), g, g, **kw)
    with pytest.raises(ValueError, match="dtype"):
        qlayernorm.qlayernorm(torch.zeros((2, 768), dtype=torch.int8, device=cuda),
                              g.to(torch.float64), g, **kw)
    assert kernels.launch_counts()["qlayernorm"] == before
