"""The port's CUDA kernels and Engine on the card, held against the plain
PyTorch versions on the same card. This file imports neither JAX nor
tf2_tpu, so it runs on a GPU machine without them:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Without a card every test here skips (decided inside the ``cuda`` fixture,
not at import). Tolerance is 0 throughout: integer accumulation is exact
and the epilogue rounds the same f32 operations.
"""
import numpy as np
import pytest
import torch

from tf2_tpu_torch import kernels
from tf2_tpu_torch.kernels import qblocks, qconv, qlrn, shift_matmul
from tf2_tpu_torch.transform import potq


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _tensors(dev, *arrays):
    return [torch.as_tensor(a).to(dev) for a in arrays]


def _gemm(rng, m, k, n):
    x = rng.integers(-127, 128, (m, k), dtype=np.int8)
    codes = rng.integers(0, 16, (k, n)).astype(np.uint8)
    w = rng.integers(-127, 128, (k, n), dtype=np.int8)
    es = rng.uniform(1e-5, 1e-4, n).astype(np.float32)
    eb = rng.standard_normal(n).astype(np.float32)
    return x, potq.pack_codes(codes), w, es, eb


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(100, 576, 64), (8, 2048, 1000), (49, 2048, 512),
                                   (130, 48, 200), (1, 64, 16)])
@pytest.mark.parametrize("relu", [False, True])
def test_qmatmul_kernels_match_plain(cuda, m, k, n, relu):
    x, packed, w, es, eb = _tensors(cuda, *_gemm(np.random.default_rng(m + k), m, k, n))
    before = kernels.launch_counts()
    got = shift_matmul.qmatmul_pot4(x, packed, es, eb, relu)
    assert torch.equal(got, shift_matmul.qmatmul_pot4_plain(x, packed, es, eb, relu))
    got = shift_matmul.qmatmul_int8(x, w, es, eb, relu)
    assert torch.equal(got, shift_matmul.qmatmul_int8_plain(x, w, es, eb, relu))
    after = kernels.launch_counts()
    assert after["qmatmul_pot4"] - before["qmatmul_pot4"] == 1
    assert after["qmatmul_int8"] - before["qmatmul_int8"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w,cin,cout,kh,stride,padding,wfmt", [
    (2, 15, 15, 32, 64, 3, 1, "SAME", "pot4"),
    (2, 14, 14, 32, 64, 3, 2, "SAME", "pot4"),
    (2, 14, 14, 64, 96, 1, 2, "SAME", "pot4"),
    (1, 28, 28, 3, 64, 7, 2, "SAME", "int8"),
    (2, 9, 9, 130, 40, 3, 1, "SAME", "pot4"),
    (2, 13, 13, 24, 32, 3, 2, "VALID", "int8"),
    (2, 16, 16, 12, 64, 4, 1, "VALID", "int8"),
])
@pytest.mark.parametrize("relu", [False, True])
def test_qconv_kernels_match_plain(cuda, b, h, w, cin, cout, kh, stride, padding,
                                   wfmt, relu):
    rng = np.random.default_rng(cin + cout)
    x = rng.integers(-127, 128, (b, h, w, cin), dtype=np.int8)
    if wfmt == "pot4":
        wparam = potq.pack_codes(rng.integers(0, 16, (kh * kh * cin, cout)).astype(np.uint8))
    else:
        wparam = rng.integers(-127, 128, (kh, kh, cin, cout), dtype=np.int8)
    es = rng.uniform(1e-5, 1e-4, cout).astype(np.float32)
    eb = rng.standard_normal(cout).astype(np.float32)
    x, wparam, es, eb = _tensors(cuda, x, wparam, es, eb)
    kw = dict(strides=(stride, stride), padding=padding, groups=1, relu=relu,
              wfmt=wfmt, kshape=(kh, kh, cin, cout))
    name = f"qconv_s{stride}"
    before = kernels.launch_counts()[name]
    got = qconv.fused_qconv2d(x, wparam, es, eb, **kw)
    torch.cuda.synchronize()
    assert kernels.launch_counts()[name] == before + 1
    assert torch.equal(got, qconv.fused_qconv2d(x, wparam, es, eb, plain=True, **kw))


@pytest.mark.cuda
def test_wrappers_refuse_bad_operands(cuda):
    x, packed, w, es, eb = _tensors(cuda, *_gemm(np.random.default_rng(0), 32, 64, 32))
    with pytest.raises(ValueError, match="contiguous"):
        shift_matmul.qmatmul_int8(x.t().contiguous().t(), w, es, eb)
    with pytest.raises(ValueError, match="dtype"):
        shift_matmul.qmatmul_int8(x, w.to(torch.int32), es, eb)
    with pytest.raises(ValueError, match="on cpu"):
        shift_matmul.qmatmul_pot4(x, packed, es.cpu(), eb)


@pytest.mark.cuda
def test_engine_every_node_equals_plain(cuda):
    """Small ResNet through Engine on the card: launch counts per forward,
    every node equal to the plain path on the card, logits equal to the
    Engine on the CPU."""
    from tf2_tpu_torch.graph import execute
    from tf2_tpu_torch.models import synthetic_quantized
    from tf2_tpu_torch.runtime import Engine

    art = synthetic_quantized("resnet50", seed=0, batch=2, image=64,
                              depths=(1, 1, 1, 1), classes=64)
    x = np.random.default_rng(0).standard_normal((2, 64, 64, 3)).astype(np.float32)
    eng = Engine(art.graph, art.params)
    kernels.reset_launch_counts()
    logits = eng.run(image=x)
    assert kernels.launch_counts() == {"qmatmul_pot4": 9, "qmatmul_int8": 1,
                                       "qconv_s1": 1, "qconv_s2": 7, "qblockchain": 0,
                                       "qlrn": 0}
    xt = torch.as_tensor(x).to(cuda)
    _, env = execute(eng.graph, intermediates=True)(eng.params, image=xt)
    _, plain = execute(eng.graph, intermediates=True, plain=True)(eng.params, image=xt)
    for n in eng.graph.nodes:
        assert torch.equal(env[n.name], plain[n.name]), n.name
    cpu = Engine(art.graph, art.params, device="cpu").run(image=x)
    assert torch.equal(logits.cpu(), cpu)


def _chain(rng, dev, cin, cm, cout, nblocks, down, relu):
    blocks = []
    for i in range(nblocks):
        k = cin if i == 0 else cout
        blk = {"w1": rng.integers(-127, 128, (k, cm), dtype=np.int8),
               "w2": rng.integers(-127, 128, (3, 3, cm, cm), dtype=np.int8),
               "w3": rng.integers(-127, 128, (cm, cout), dtype=np.int8)}
        convs = [("1", k, cm), ("2", 9 * cm, cm), ("3", cm, cout)]
        if down and i == 0:
            blk["wd"] = rng.integers(-127, 128, (k, cout), dtype=np.int8)
            convs.append(("d", k, cout))
        for key, kk, n in convs:
            # scales that put the accumulators' spread across the int8 range
            blk["es" + key] = (rng.uniform(0.5, 2.0, n) * 40 / (127 * 127 * np.sqrt(kk))
                               ).astype(np.float32)
            blk["eb" + key] = rng.normal(0, 3, n).astype(np.float32)
        blk = {k_: torch.as_tensor(v).to(dev) for k_, v in blk.items()}
        blk.update(sa_over_so=float(rng.uniform(0.5, 1.5)),
                   sb_over_so=float(rng.uniform(0.5, 1.5)), relu=relu)
        blocks.append(blk)
    return blocks


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w,cin,cm,cout,nblocks,down", [
    (64, 9, 13, 48, 40, 64, 2, True),       # bands of 2 rows on 9; Cm % 16 != 0
    (64, 9, 13, 64, 40, 64, 1, False),
    (96, 12, 12, 32, 32, 96, 3, True),      # bands of 5 on 12; Cin != Cout, downsample
    (3, 8, 8, 64, 16, 64, 3, False),
    (1, 7, 7, 2048, 512, 2048, 2, False),   # stage 4 at batch 1
])
@pytest.mark.parametrize("relu", [False, True])
def test_qblockchain_kernel_matches_plain(cuda, b, h, w, cin, cm, cout, nblocks, down, relu):
    """The chain kernel equals the plain chain on ragged chains. The band
    heights in the comments are those ``band_rows`` picks on 132 SMs (an
    H100 SXM); tests/test_torch_qblocks.py pins them."""
    rng = np.random.default_rng(cin + cm + nblocks)
    blocks = _chain(rng, cuda, cin, cm, cout, nblocks, down, relu)
    x = torch.as_tensor(rng.integers(-127, 128, (b, h, w, cin), dtype=np.int8)).to(cuda)
    before = kernels.launch_counts()["qblockchain"]
    got = qblocks.qblockchain(x, blocks)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["qblockchain"] == before + 1
    want = qblocks.qblockchain_plain(x, blocks)
    assert got.shape == (b, h, w, cout) and torch.equal(got, want)
    assert 0 < int((want != 0).sum()) < want.numel()


@pytest.mark.cuda
def test_qblockchain_refuses_what_it_does_not_take(cuda):
    """An identity block that changes the channel count, and a block whose
    w1 does not take the input's channels, raise instead of launching."""
    rng = np.random.default_rng(0)
    x = torch.zeros((1, 8, 8, 32), dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError, match="does not take"):
        qblocks.qblockchain(x, _chain(rng, cuda, 32, 16, 64, 1, False, True))
    with pytest.raises(ValueError, match="does not take"):
        qblocks.qblockchain(x, _chain(rng, cuda, 64, 16, 64, 1, False, True))


@pytest.mark.cuda
def test_block_fused_engine_every_node_equals_plain(cuda):
    """Engine(block_fusion=True) on a small ResNet (depths 2-2-2-2) on the
    card: four chain launches a forward, every node equal to the plain
    path, logits equal to the fused Engine on the CPU and to the unfused
    Engine on the card."""
    from tf2_tpu_torch.graph import execute
    from tf2_tpu_torch.models import synthetic_quantized
    from tf2_tpu_torch.runtime import Engine

    art = synthetic_quantized("resnet50", seed=0, batch=2, image=64,
                              depths=(2, 2, 2, 2), classes=64)
    x = np.random.default_rng(0).standard_normal((2, 64, 64, 3)).astype(np.float32)
    eng = Engine(art.graph, art.params, block_fusion=True)
    kernels.reset_launch_counts()
    logits = eng.run(image=x)
    assert kernels.launch_counts() == {"qmatmul_pot4": 6, "qmatmul_int8": 1,
                                       "qconv_s1": 0, "qconv_s2": 7, "qblockchain": 4,
                                       "qlrn": 0}
    xt = torch.as_tensor(x).to(cuda)
    _, env = execute(eng.graph, intermediates=True)(eng.params, image=xt)
    _, plain = execute(eng.graph, intermediates=True, plain=True)(eng.params, image=xt)
    for n in eng.graph.nodes:
        assert torch.equal(env[n.name], plain[n.name]), n.name
    cpu = Engine(art.graph, art.params, device="cpu", block_fusion=True).run(image=x)
    assert torch.equal(logits.cpu(), cpu)
    assert torch.equal(logits, Engine(art.graph, art.params).run(image=x))


@pytest.mark.cuda
@pytest.mark.parametrize("m,c", [(3137, 64), (1001, 192), (777, 13), (1, 192), (5, 3)])
@pytest.mark.parametrize("radius", [1, 2])
@pytest.mark.parametrize("s_in,s_out,alpha", [(0.0312, 0.0279, 2e-4), (0.5, 0.37, 1e-4),
                                               (0.2, 0.05, 1e-3)])
def test_qlrn_kernel_matches_plain(cuda, m, c, radius, s_in, s_out, alpha):
    """Odd pixel counts (runs that end inside a block), C = 13 (16-byte
    words that straddle pixels), C < 2r + 1, one pixel; +-127 in every
    tenth row."""
    rng = np.random.default_rng(m + c + radius)
    x = rng.integers(-127, 128, (m, c), dtype=np.int8)
    x[::10] = rng.choice(np.array([-127, 127], np.int8), size=x[::10].shape)
    x = torch.as_tensor(x).to(cuda)
    kw = dict(radius=radius, alpha=alpha, beta=0.75, bias=1.0, s_in=s_in, s_out=s_out)
    before = kernels.launch_counts()["qlrn"]
    got = qlrn.qlrn(x, **kw)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["qlrn"] == before + 1
    want = qlrn.qlrn_plain(x, **kw)
    assert torch.equal(got, want)
    assert torch.equal(got.cpu(), qlrn.qlrn_plain(x.cpu(), **kw))


@pytest.mark.cuda
def test_qlrn_kernel_on_a_view_offset_in_memory(cuda):
    """A run whose start is not 16-byte aligned in memory."""
    base = torch.as_tensor(np.random.default_rng(0).integers(
        -127, 128, 64 * 61 + 7, dtype=np.int8)).to(cuda)
    x = base[7:].view(61, 64)
    kw = dict(radius=2, alpha=2e-4, beta=0.75, bias=1.0, s_in=0.0312, s_out=0.0279)
    assert torch.equal(qlrn.qlrn(x, **kw), qlrn.qlrn_plain(x, **kw))


@pytest.mark.cuda
def test_qlrn_kernel_refuses_other_beta(cuda):
    x = torch.zeros((4, 8, 8, 96), dtype=torch.int8, device=cuda)
    with pytest.raises(NotImplementedError, match="beta"):
        qlrn.qlrn(x, radius=1, alpha=2e-4, beta=0.5, bias=1.0, s_in=0.03, s_out=0.03)


@pytest.mark.cuda
@pytest.mark.parametrize("name,image,launches", [
    ("googlenet", 64, {"qmatmul_pot4": 37, "qmatmul_int8": 1, "qconv_s1": 19,
                       "qconv_s2": 1, "qblockchain": 0, "qlrn": 2}),
    ("squeezenet_v1_1", 96, {"qmatmul_pot4": 16, "qmatmul_int8": 1, "qconv_s1": 8,
                             "qconv_s2": 1, "qblockchain": 0, "qlrn": 0}),
])
def test_zoo_engines_every_node_equals_plain(cuda, name, image, launches):
    """GoogLeNet and SqueezeNet at batch 2 on the card, merge_1x1 off and
    on: launch counts per forward, every node equal to the plain path,
    logits equal to the Engine on the CPU and to each other."""
    from tf2_tpu_torch.graph import execute
    from tf2_tpu_torch.models import synthetic_quantized
    from tf2_tpu_torch.runtime import Engine

    art = synthetic_quantized(name, seed=0, batch=2, image=image, classes=64)
    x = np.random.default_rng(0).standard_normal((2, image, image, 3)).astype(np.float32)
    xt = torch.as_tensor(x).to(cuda)
    logits = {}
    for merge in (False, True):
        eng = Engine(art.graph, art.params, merge_1x1=merge)
        kernels.reset_launch_counts()
        logits[merge] = eng.run(image=x)
        if not merge:
            assert kernels.launch_counts() == launches
        _, env = execute(eng.graph, intermediates=True)(eng.params, image=xt)
        _, plain = execute(eng.graph, intermediates=True, plain=True)(eng.params, image=xt)
        for n in eng.graph.nodes:
            assert torch.equal(env[n.name], plain[n.name]), n.name
        cpu = Engine(art.graph, art.params, device="cpu", merge_1x1=merge).run(image=x)
        assert torch.equal(logits[merge].cpu(), cpu)
    assert torch.equal(logits[True], logits[False])
