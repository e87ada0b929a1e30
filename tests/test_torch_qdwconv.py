"""The int8 depthwise conv kernel (``kernels/qdwconv.py``,
``csrc/qdwconv.cu``) and its plain version.

On the CPU: ``covers``; the plain version against ``qconv_plain`` and a
numpy model of the window sums; a replay, in numpy, of the kernel's
schedule (the channel planes, the banded B fragments, the mma.m16n8k32
fragment layouts, the epilogue's f32 steps) against the plain version; the
dispatch and the Engine's coverage plan. On the card (the ``cuda`` marker;
skipped without one, decided in the fixture): the kernel against the plain
version on the card and on the CPU, with 0 mismatches, at every ConvNeXt-T
shape at b64 and b1 and at other widths, window sizes and odd sizes. This
file imports neither JAX nor tf2_tpu, so it runs on a GPU machine without
them:

    python -m pytest --noconftest tests/test_torch_qdwconv.py -q
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tf2_tpu_torch import kernels
from tf2_tpu_torch.bench import coverage_cases
from tf2_tpu_torch.graph import Node
from tf2_tpu_torch.kernels import dispatch, qblocks, qconv, qdwconv
from tf2_tpu_torch.models import synthetic_quantized
from tf2_tpu_torch.runtime import Engine, spans
from tf2_tpu_torch.runtime.engine import Limits

CARD = Limits(256, qblocks.SMEM_LIMIT)
# ConvNeXt-T's depthwise convs: (H = W, C), 7 x 7
CONVNEXT = [(56, 96), (28, 192), (14, 384), (7, 768)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _case(n, h, w, c, k, rng, kind="random"):
    """x, w, es, eb: int8 codes (random; +-127), int8 weights, and an
    epilogue whose outputs spread over the int8 grid."""
    if kind == "pm127":
        x = np.where(rng.random((n, h, w, c)) < 0.5, -127, 127).astype(np.int8)
        wq = np.where(rng.random((k, k, 1, c)) < 0.5, -127, 127).astype(np.int8)
    else:
        x = rng.integers(-128, 128, (n, h, w, c), dtype=np.int8)
        wq = rng.integers(-127, 128, (k, k, 1, c), dtype=np.int8)
    spread = k * 127 * 127 / 2.0
    es = (rng.uniform(20, 60, c) / spread).astype(np.float32)
    eb = rng.uniform(-20, 20, c).astype(np.float32)
    return x, wq, es, eb


def _model(x, wq, es, eb, relu):
    """The window sums in int64 numpy with SAME pads, then the epilogue's
    f32 steps: f32(acc) * es, + eb, relu, round half to even, clip."""
    n, h, w, c = x.shape
    k = wq.shape[0]
    p = (k - 1) // 2
    xp = np.pad(x.astype(np.int64), ((0, 0), (p, p), (p, p), (0, 0)))
    acc = np.zeros((n, h, w, c), np.int64)
    for dy in range(k):
        for dx in range(k):
            acc += xp[:, dy:dy + h, dx:dx + w, :] * wq[dy, dx, 0].astype(np.int64)
    y = acc.astype(np.float32) * es + eb
    if relu:
        y = np.maximum(y, np.float32(0))
    return np.clip(np.rint(y), -127, 127).astype(np.int8)


def _torch(*arrays):
    return [torch.as_tensor(a) for a in arrays]


# ---- covers and the plain version, on the CPU ----

@pytest.mark.parametrize("kshape,strides,groups,cin,padding,takes", [
    ((7, 7, 1, 96), (1, 1), 96, 96, "SAME", True),
    ((3, 3, 1, 8), (1, 1), 8, 8, "SAME", True),
    ((5, 5, 1, 776), (1, 1), 776, 776, "SAME", True),
    ((5, 5, 1, 16), (1, 1), 16, 16, [(2, 2), (2, 2)], True),
    ((7, 7, 1, 96), (1, 1), 96, 96, "VALID", False),
    ((7, 7, 1, 96), (2, 2), 96, 96, "SAME", False),
    ((9, 9, 1, 96), (1, 1), 96, 96, "SAME", False),
    ((1, 1, 1, 96), (1, 1), 96, 96, "SAME", False),
    ((3, 5, 1, 96), (1, 1), 96, 96, "SAME", False),
    ((3, 3, 1, 12), (1, 1), 12, 12, "SAME", False),
    ((3, 3, 2, 32), (1, 1), 16, 32, "SAME", False),
    ((3, 3, 16, 32), (1, 1), 2, 32, "SAME", False),
    ((3, 3, 32, 32), (1, 1), 1, 32, "SAME", False),
])
def test_covers(kshape, strides, groups, cin, padding, takes):
    assert qdwconv.covers(kshape, strides, groups, cin, padding, width=56) is takes


def test_covers_asks_shared_memory():
    """A block holds every column of its rows: rows too wide for 227 KB
    are refused."""
    assert qdwconv.smem_bytes(7, 56) == 63872
    assert qdwconv.smem_bytes(7, 256) == 199040
    assert qdwconv.covers((7, 7, 1, 96), (1, 1), 96, 96, width=256)
    assert not qdwconv.covers((7, 7, 1, 96), (1, 1), 96, 96, width=512)


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("n,h,w,c,k,kind", [
    (2, 7, 7, 16, 7, "random"), (1, 9, 13, 8, 3, "random"), (1, 5, 11, 24, 5, "pm127"),
    (3, 14, 14, 32, 7, "pm127")])
def test_plain_matches_model_and_qconv_plain(n, h, w, c, k, kind, relu):
    rng = np.random.default_rng(h * 31 + c + k)
    x, wq, es, eb = _case(n, h, w, c, k, rng, kind)
    got = qdwconv.qdwconv_plain(*_torch(x, wq, es, eb), relu=relu)
    np.testing.assert_array_equal(got.numpy(), _model(x, wq, es, eb, relu))
    p = (k - 1) // 2
    want = qconv.qconv_plain(*_torch(x, wq, es, eb), strides=(1, 1), kshape=(k, k, 1, c),
                             pads=((p, p), (p, p)), relu=relu, wfmt="int8", groups=c)
    assert torch.equal(got, want)
    assert torch.equal(qdwconv.qdwconv(*_torch(x, wq, es, eb), relu=relu), got)


def test_plain_runs_on_meta():
    x = torch.empty((2, 56, 56, 96), dtype=torch.int8, device="meta")
    w = torch.empty((7, 7, 1, 96), dtype=torch.int8, device="meta")
    e = torch.empty(96, dtype=torch.float32, device="meta")
    y = qdwconv.qdwconv(x, w, e, e, relu=False)
    assert y.shape == x.shape and y.dtype == torch.int8 and y.device.type == "meta"


# ---- a replay of the kernel's schedule, in numpy ----

def _round_to(v, mod, rem):
    r = v - v % mod + rem
    return r if r >= v else r + mod


def _transpose4(v):
    """csrc/qdwconv.cu: transpose4, by its byte permutes."""
    def perm(x, y, sel):
        src = np.frombuffer(np.array([x, y], "<u4").tobytes(), np.uint8)
        return int(np.frombuffer(bytes(src[(sel >> (4 * i)) & 7] for i in range(4)),
                                 "<u4")[0])
    t0, t1 = perm(v[0], v[1], 0x5140), perm(v[2], v[3], 0x5140)
    t2, t3 = perm(v[0], v[1], 0x7362), perm(v[2], v[3], 0x7362)
    return [perm(t0, t1, 0x5410), perm(t0, t1, 0x7632), perm(t2, t3, 0x5410),
            perm(t2, t3, 0x7632)]


def _requant_bits(acc, es, eb, relu):
    """csrc/qdwconv.cu: requant_bits, in numpy f32 (each step one IEEE
    operation): f32(acc) from the bits of 0x4B400000 + acc less 1.5 * 2^23,
    * es + eb, relu, clip, + 1.5 * 2^23 and the low byte of its bits."""
    magic = np.float32(12582912.0)
    v = np.array([0x4B400000 + int(acc)], np.uint32).view(np.float32)[0] - magic
    v = np.float32(np.float32(v * np.float32(es)) + np.float32(eb))
    if relu:
        v = max(v, np.float32(0))
    v = np.float32(min(max(v, np.float32(-127)), np.float32(127)))
    return int(np.array([v + magic], np.float32).view(np.uint32)[0]) & 0xFF


def _kernel_replay(x, wq, es, eb, relu):
    """csrc/qdwconv.cu step by step: each block's 32 channel planes filled
    by its threads' 4-channel words, each warp's B fragments from the padded
    weight rows, each lane's A fragment loads, the m16n8k32 product on the
    PTX fragment layouts (two window rows a product, the last of an odd k
    against zeros), the epilogue's 2-byte stores into the planes over the
    tile's own columns, and the copy back to NHWC."""
    n, h, w, c = x.shape
    k = wq.shape[0]
    p, rows = (k - 1) // 2, 16 + k - 1
    tiles = -(-w // 8)
    rs = _round_to(8 * tiles + 8, 32, 16)
    plane = rows * rs + 4
    xb = x.view(np.uint8)
    wb = wq.view(np.uint8).reshape(k, k, c)
    y = np.full((n, h, w, c), 99, np.uint8)
    lanes = [(lane >> 2, lane & 3) for lane in range(32)]

    def word(buf, at):
        return int(buf[at:at + 4].view("<u4")[0])

    for c0 in range(0, c, 32):
        nch = min(32, c - c0)
        s_w = np.zeros((32, k, 32), np.uint8)
        s_w[:nch, :, 8:8 + k] = wb[:, :, c0:c0 + nch].transpose(2, 0, 1)
        bregs = np.zeros((32, k + 1, 32), np.uint64)   # [ch][dy][lane]; dy = k: 0
        for ch in range(32):
            for dy in range(k):
                row = s_w[ch, dy].view("<u4")
                for lane, (g, t) in enumerate(lanes):
                    off = 8 + 4 * t - g
                    pair = (int(row[(off >> 2) + 1]) << 32) | int(row[off >> 2])
                    bregs[ch, dy, lane] = (pair >> (8 * (off & 3))) & 0xFFFFFFFF
        for img in range(n):
            for y0 in range(0, h, 16):
                s = np.zeros(32 * plane, np.uint8)
                for r in range(rows):
                    for j in range(2 * tiles + 2):
                        for q in range(8):
                            v = [0, 0, 0, 0]
                            for i in range(4):
                                yy, xx = y0 - p + r, 4 * j + i - p
                                if 4 * q < nch and 0 <= yy < h and 0 <= xx < w:
                                    v[i] = word(xb[img, yy, xx], c0 + 4 * q)
                            v = _transpose4(v)
                            for cc in range(4):
                                at = (4 * q + cc) * plane + r * rs + 4 * j
                                s[at:at + 4] = np.frombuffer(np.array([v[cc]], "<u4").tobytes(),
                                                             np.uint8)
                for ch in range(32):
                    base = ch * plane
                    for xt in range(tiles):
                        d = np.zeros((16, 8), np.int64)
                        for dy in range(0, k, 2):
                            a = np.zeros((16, 32), np.int64)
                            bm = np.zeros((32, 8), np.int64)
                            for lane, (g, t) in enumerate(lanes):
                                at = base + (g + dy) * rs + 8 * xt + 4 * t
                                frags = [at, at + 8 * rs] + ([at + rs, at + 9 * rs] if dy + 1 < k
                                                              else [at, at + 8 * rs])
                                for (m, col), fa in zip(((g, 0), (g + 8, 0), (g, 16), (g + 8, 16)),
                                                        frags):
                                    a[m, col + 4 * t:col + 4 * t + 4] = s[fa:fa + 4].view(np.int8)
                                for half, dd in ((0, dy), (1, min(dy + 1, k))):
                                    bb = np.array([bregs[ch, dd, lane]], "<u4").view(np.int8)
                                    bm[16 * half + 4 * t:16 * half + 4 * t + 4, g] = bb
                            d += a @ bm
                        for g, t in lanes:
                            for m in (g, g + 8):
                                for col in (2 * t, 2 * t + 1):
                                    s[base + m * rs + 8 * xt + col] = _requant_bits(
                                        d[m, col], es[c0 + ch] if ch < nch else 0,
                                        eb[c0 + ch] if ch < nch else 0, relu)
                for m in range(16):
                    if y0 + m >= h:
                        continue
                    for j in range(2 * tiles):
                        for q in range(8):
                            if 4 * q >= nch:
                                continue
                            v = _transpose4([word(s, (4 * q + cc) * plane + m * rs + 4 * j)
                                             for cc in range(4)])
                            for i in range(4):
                                if 4 * j + i < w:
                                    y[img, y0 + m, 4 * j + i, c0 + 4 * q:c0 + 4 * q + 4] = \
                                        np.frombuffer(np.array([v[i]], "<u4").tobytes(), np.uint8)
    return y.view(np.int8)


@pytest.mark.parametrize("n,h,w,c,k,relu", [
    (1, 7, 7, 16, 7, False), (2, 9, 13, 8, 3, True), (1, 17, 10, 24, 5, False),
    (1, 5, 9, 40, 7, True)])
def test_kernel_schedule_replay_equals_plain(n, h, w, c, k, relu):
    """Every index of the kernel (the planes' byte layout, the halo, the
    Toeplitz B fragment, the A rows of each pair of window rows, the
    epilogue's columns over the tile's own inputs, the copy-out, a last
    group of 8 or 24 channels, rows and columns past the image) and its
    epilogue's f32 steps reproduce the plain version."""
    rng = np.random.default_rng(n + h + w + c + k)
    x, wq, es, eb = _case(n, h, w, c, k, rng)
    want = qdwconv.qdwconv_plain(*_torch(x, wq, es, eb), relu=relu).numpy()
    np.testing.assert_array_equal(_kernel_replay(x, wq, es, eb, relu), want)


# ---- the dispatch and the Engine's coverage plan ----

def test_dispatch_routes_depthwise_convs(monkeypatch):
    """dispatch.qconv2d hands an int8 depthwise node the plan puts on
    ``qdwconv`` to the module's kernel (its plain version here), and one
    the plan runs plain, or one with no plan off the card, to the conv
    path's plain version; no launch on the CPU. With no plan on the card
    it asks ``kernel_of``: the kernel for this node, and a raise for one
    ``covers`` refuses (the card stood in for)."""
    calls = []
    real = qdwconv.qdwconv

    def spy(*a, **kw):
        calls.append("qdwconv")
        return real(*a, **kw)

    monkeypatch.setattr(qdwconv, "qdwconv", spy)
    rng = np.random.default_rng(3)
    x, wq, es, eb = _case(1, 9, 9, 16, 7, rng)
    params = dict(zip(("w", "es", "eb"), _torch(wq, es, eb)))
    attrs = {"relu": True, "wfmt": "int8", "strides": [1, 1], "padding": "SAME",
             "groups": 16, "kshape": [7, 7, 1, 16], "in_scale": 0.02, "out_scale": 0.02}
    node = Node("dw", "qconv2d", ("x",), ("w", "es", "eb"), attrs)
    valid = Node("dw", "qconv2d", ("x",), ("w", "es", "eb"), dict(attrs, padding="VALID"))
    before = kernels.launch_counts()["qdwconv"]
    for kernel in ("qdwconv", "plain", None):
        got = dispatch.qconv2d(node, params, torch.as_tensor(x), kernel=kernel)
        np.testing.assert_array_equal(got.numpy(), _model(x, wq, es, eb, True))
    assert calls == ["qdwconv"]
    dispatch.qconv2d(valid, params, torch.as_tensor(x))
    assert calls == ["qdwconv"]
    monkeypatch.setattr(dispatch, "_on_card", lambda t: True)
    monkeypatch.setattr(dispatch.Limits, "of_card", staticmethod(lambda: CARD))
    got = dispatch.qconv2d(node, params, torch.as_tensor(x))
    np.testing.assert_array_equal(got.numpy(), _model(x, wq, es, eb, True))
    assert calls == ["qdwconv", "qdwconv"]
    with pytest.raises(NotImplementedError, match="no kernel takes"):
        dispatch.qconv2d(valid, params, torch.as_tensor(x))
    assert kernels.launch_counts()["qdwconv"] == before


def test_plan_gives_depthwise_convs_the_kernel():
    """Engine.plan gives every depthwise conv of a small ConvNeXt the
    kernel and leaves none plain; with predecode=False its weights stay
    pot4 and every one of them is planned plain (counted in
    engine.plain_nodes)."""
    art = synthetic_quantized("convnext_t", batch=1, image=32, classes=10, depths=(1, 1, 2, 1),
                              dims=(16, 32, 64, 128))
    eng = Engine(art.graph, art.params, device="cpu")
    dws = {n.name for n in eng.graph.nodes if n.attrs.get("groups", 1) > 1}
    assert len(dws) == 5 and all(eng.graph.node_map()[d].attrs["wfmt"] == "int8" for d in dws)
    before = spans.counters()
    plan = Engine.plan(eng.graph, eng.params, CARD)
    after = spans.counters()
    assert dispatch.nodes_on(plan, "qdwconv") == dws and "plain" not in plan.values()
    assert after["engine.plain_nodes"] == before["engine.plain_nodes"]
    packed = Engine(art.graph, art.params, device="cpu", predecode=False)
    assert dispatch.nodes_on(Engine.plan(packed.graph, packed.params, CARD), "plain") == dws
    assert spans.counters()["engine.plain_nodes"] - after["engine.plain_nodes"] == 5


def test_plan_takes_the_coverage_depthwise_conv():
    """coverage_cases.conv_graph's 3x3 depthwise conv (16 channels) now
    runs on the kernel; its groups=2 and strided convs stay plain."""
    conv = coverage_cases.conv_artifact()
    eng = Engine(conv.graph, conv.params, device="cpu")
    plan = Engine.plan(eng.graph, eng.params, CARD)
    assert dispatch.nodes_on(plan, "plain") == coverage_cases.CONV_PLAIN
    assert plan["dw3x3"] == "qdwconv"


def test_imports_without_cuda():
    """The module imports, covers answers and the counter reads 0 where no
    card is visible; the library is not built at import."""
    code = ("import torch; from tf2_tpu_torch.kernels import qdwconv as q; "
            "assert not torch.cuda.is_available(); "
            "assert q.covers((7, 7, 1, 96), (1, 1), 96, 96) and q.LAUNCHES == {'qdwconv': 0}; "
            "assert q._lib.cache_info().currsize == 0")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    subprocess.run([sys.executable, "-c", code], env=env, check=True, timeout=120,
                   cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


# ---- the kernel, on the card ----

def _check_kernel(dev, x, wq, es, eb, relu):
    """The kernel's output against the plain version on the card and on
    the CPU: 0 mismatches; one launch."""
    xd, wd, esd, ebd = (t.to(dev) for t in _torch(x, wq, es, eb))
    before = kernels.launch_counts()["qdwconv"]
    got = qdwconv.qdwconv(xd, wd, esd, ebd, relu=relu)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["qdwconv"] == before + 1
    assert got.shape == xd.shape and got.dtype == torch.int8
    on_card = qdwconv.qdwconv_plain(xd, wd, esd, ebd, relu=relu)
    on_cpu = qdwconv.qdwconv_plain(*_torch(x, wq, es, eb), relu=relu)
    assert int((got != on_card).sum()) == 0
    assert int((got.cpu() != on_cpu).sum()) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [64, 1])
@pytest.mark.parametrize("hw,c", CONVNEXT)
def test_kernel_convnext_shapes(cuda, batch, hw, c):
    rng = np.random.default_rng(hw * batch + c)
    _check_kernel(cuda, *_case(batch, hw, hw, c, 7, rng), relu=False)


@pytest.mark.cuda
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("n,h,w,c,k,kind", [
    (2, 9, 13, 8, 3, "random"), (3, 15, 17, 776, 5, "random"), (2, 33, 35, 24, 7, "pm127"),
    (1, 1, 1, 8, 3, "random"), (5, 31, 9, 40, 5, "pm127"), (1, 57, 57, 96, 7, "random"),
    (2, 16, 8, 16, 3, "pm127")])
def test_kernel_other_shapes(cuda, n, h, w, c, k, kind, relu):
    """Other widths (a last group of 8 channels: 8, 24, 40, 776), window
    sizes, odd sizes, rows and columns shorter than a tile, +-127."""
    rng = np.random.default_rng(h * w + c + k)
    _check_kernel(cuda, *_case(n, h, w, c, k, rng, kind), relu=relu)


@pytest.mark.cuda
def test_kernel_refuses(cuda):
    """Shapes covers refuses, a misaligned input and a wrong dtype raise;
    no launch counts. The wrapper's shared memory count is the kernel's."""
    for k, w in ((3, 1), (5, 17), (7, 56), (7, 256)):
        assert qdwconv._lib().tf2_qdwconv_smem(k, w) == qdwconv.smem_bytes(k, w)
    before = kernels.launch_counts()["qdwconv"]
    e = torch.ones(12, device=cuda)
    with pytest.raises(ValueError, match="qdwconv kernel"):
        qdwconv.qdwconv(torch.zeros((1, 8, 8, 12), dtype=torch.int8, device=cuda),
                        torch.zeros((3, 3, 1, 12), dtype=torch.int8, device=cuda), e, e,
                        relu=False)
    e = torch.ones(16, device=cuda)
    with pytest.raises(ValueError, match="qdwconv kernel"):
        qdwconv.qdwconv(torch.zeros((1, 8, 8, 16), dtype=torch.int8, device=cuda),
                        torch.zeros((9, 9, 1, 16), dtype=torch.int8, device=cuda), e, e,
                        relu=False)
    flat = torch.zeros(8 * 8 * 16 + 2, dtype=torch.int8, device=cuda)
    w = torch.zeros((3, 3, 1, 16), dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError, match="aligned"):
        qdwconv.qdwconv(flat[2:].view(1, 8, 8, 16), w, e, e, relu=False)
    with pytest.raises(ValueError, match="dtype"):
        qdwconv.qdwconv(torch.zeros((1, 8, 8, 16), dtype=torch.int8, device=cuda),
                        w, e.double(), e, relu=False)
    assert kernels.launch_counts()["qdwconv"] == before
