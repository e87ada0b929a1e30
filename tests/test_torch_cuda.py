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
from tf2_tpu_torch.kernels import qattention, qblocks, qconv, qlrn, qstem, shift_matmul
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
    # taps crossing a K step (C not a multiple of 64), copy widths 8 and 4
    (2, 14, 14, 48, 64, 3, 1, "SAME", "pot4"),
    (2, 14, 14, 96, 128, 3, 1, "SAME", "pot4"),
    (2, 14, 14, 112, 224, 3, 1, "SAME", "pot4"),
    (2, 14, 14, 144, 288, 3, 1, "SAME", "pot4"),
    (2, 14, 14, 24, 64, 5, 1, "SAME", "pot4"),      # K/2 = 300: 4-byte copies
    (2, 14, 14, 16, 48, 5, 1, "SAME", "pot4"),      # K/2 = 200, not a multiple of 32
    # SSD's heads: N = 12 and 63 (unaligned weight rows)
    (2, 8, 8, 256, 12, 3, 1, "SAME", "pot4"),
    (2, 8, 8, 256, 63, 3, 1, "SAME", "pot4"),
    (2, 4, 4, 256, 63, 3, 1, "SAME", "int8"),
    # ResNet-50 stage 4 at batch 1, the smallest grid
    (1, 7, 7, 512, 512, 3, 1, "SAME", "pot4"),
    # the tiles 256x128, 128x128 and 128x64 (enough blocks for the SMs)
    (64, 28, 28, 128, 128, 3, 1, "SAME", "pot4"),
    (64, 56, 56, 64, 128, 3, 2, "SAME", "pot4"),
    (64, 14, 14, 256, 256, 3, 1, "SAME", "int8"),
    (32, 28, 28, 64, 64, 3, 1, "SAME", "pot4"),
    (64, 14, 14, 512, 512, 3, 2, "SAME", "pot4"),
    # the staged gather: the full 224x224 stem at batch 1, SSD's stem,
    # SqueezeNet's VALID stem, and pot4 on 6 channels
    (1, 224, 224, 3, 64, 7, 2, "SAME", "int8"),
    (1, 256, 256, 3, 32, 3, 2, "SAME", "int8"),
    (2, 224, 224, 3, 64, 3, 2, "VALID", "int8"),
    (3, 11, 10, 6, 30, 3, 2, "SAME", "pot4"),
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
                                       "qlrn": 0, "qattention": 0,
                                       "qconv_s2x1": 0, "qstem": 0}
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
                                       "qlrn": 0, "qattention": 0,
                                       "qconv_s2x1": 0, "qstem": 0}
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
@pytest.mark.parametrize("m,c", [(3137, 64), (1001, 192), (777, 13)])
@pytest.mark.parametrize("beta", [0.5, 0.6, 1.0])
def test_qlrn_kernel_other_beta(cuda, m, c, beta):
    """beta != 0.75: t^beta as the double exp and log, the same functions
    in the kernel and in the plain version on the card."""
    rng = np.random.default_rng(m + c)
    x = torch.as_tensor(rng.integers(-127, 128, (m, c), dtype=np.int8)).to(cuda)
    for s_in, s_out, alpha in [(0.0312, 0.0279, 2e-4), (0.2, 0.05, 1e-3)]:
        kw = dict(radius=2, alpha=alpha, beta=beta, bias=1.0, s_in=s_in, s_out=s_out)
        assert torch.equal(qlrn.qlrn(x, **kw), qlrn.qlrn_plain(x, **kw))


@pytest.mark.cuda
def test_qlrn_kernel_refuses_too_many_channels(cuda):
    x = torch.zeros((2, 9000), dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError, match="channels"):
        qlrn.qlrn(x, radius=1, alpha=2e-4, beta=0.75, bias=1.0, s_in=0.03, s_out=0.03)


@pytest.mark.cuda
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("m,k,n", [(12544, 768, 768), (394, 3072, 768), (100, 64, 130),
                                   (1, 48, 16)])
def test_residual_qmatmul_matches_plain(cuda, m, k, n, relu):
    """The int8 GEMM with the residual added in the epilogue (the ViT's
    proj and mlp2), outputs clipped at both ends."""
    rng = np.random.default_rng(m + n)
    x, _, w, es, eb = _gemm(rng, m, k, n)
    r = rng.integers(-127, 128, (m, n), dtype=np.int8)
    es = (rng.uniform(0.5, 3.0, n) / (127 * np.sqrt(k))).astype(np.float32)
    eb = rng.normal(0, 20, n).astype(np.float32)
    x, w, es, eb, r = _tensors(cuda, x, w, es, eb, r)
    before = kernels.launch_counts()["qmatmul_int8"]
    got = shift_matmul.qmatmul_int8(x, w, es, eb, relu, residual=(r, 0.73))
    torch.cuda.synchronize()
    assert kernels.launch_counts()["qmatmul_int8"] == before + 1
    want = shift_matmul.qmatmul_int8_plain(x, w, es, eb, relu, residual=(r, 0.73))
    assert torch.equal(got, want)
    assert not torch.equal(got, shift_matmul.qmatmul_int8(x, w, es, eb, relu))
    with pytest.raises(ValueError, match="residual"):
        shift_matmul.qmatmul_int8(x, w, es, eb, relu, residual=(r[:, :-1].contiguous(), 0.73))


def _qkv(rng, n, t, dim, extreme=False):
    if extreme:
        return rng.choice(np.array([-127, 127], np.int8), size=(n, t, 3 * dim))
    return rng.integers(-127, 128, (n, t, 3 * dim), dtype=np.int8)


@pytest.mark.cuda
@pytest.mark.parametrize("n,t,heads,hd", [(3, 50, 4, 64), (2, 17, 4, 16), (1, 1, 12, 64),
                                          (5, 197, 12, 64), (2, 196, 12, 64), (2, 77, 3, 48),
                                          (1, 130, 2, 128), (2, 33, 5, 32)])
@pytest.mark.parametrize("s_in,s_out", [(0.005, 0.01), (0.02, 0.05), (0.1, 0.05)])
def test_qattention_kernel_matches_plain(cuda, n, t, heads, hd, s_in, s_out):
    """Ragged N and T (T = 1, T not a multiple of 8 or of the 64-row query
    blocks), every head width class (16, 32, 48, 64, 128), softmax from flat
    to peaked, and +-127 inputs."""
    rng = np.random.default_rng(n * t + hd)
    dim = heads * hd
    kw = dict(heads=heads, dim=dim, s_in=s_in, s_out=s_out)
    for extreme in (False, True):
        qkv = torch.as_tensor(_qkv(rng, n, t, dim, extreme)).to(cuda)
        before = kernels.launch_counts()["qattention"]
        got = qattention.qattention(qkv, **kw)
        torch.cuda.synchronize()
        assert kernels.launch_counts()["qattention"] == before + 1
        assert got.shape == (n, t, dim) and torch.equal(got, qattention.qattention_plain(qkv, **kw))
        if not extreme:
            assert torch.equal(got.cpu(), qattention.qattention_plain(qkv.cpu(), **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("n,t,heads,hd", [(1, 481, 2, 64), (2, 577, 3, 64), (1, 1025, 2, 128),
                                          (1, 4096, 2, 64), (1, 2000, 1, 16)])
def test_qattention_kernel_at_long_sequences(cuda, n, t, heads, hd):
    """No sequence limit: past the old shared-memory limit (480 at hd 64),
    ViT-B/16's 577 at 384x384 (K and V resident, three passes over chunks
    of keys) and sequences whose K and V stream through shared memory."""
    rng = np.random.default_rng(t + hd)
    for s_in, s_out in [(0.005, 0.01), (0.1, 0.05)]:
        kw = dict(heads=heads, dim=heads * hd, s_in=s_in, s_out=s_out)
        qkv = torch.as_tensor(_qkv(rng, n, t, heads * hd)).to(cuda)
        assert qattention.covers(t, hd)
        assert torch.equal(qattention.qattention(qkv, **kw), qattention.qattention_plain(qkv, **kw))


@pytest.mark.cuda
def test_qattention_refuses_what_it_does_not_take(cuda):
    kw = dict(s_in=0.02, s_out=0.05)
    with pytest.raises(ValueError, match="head width"):
        qattention.qattention(torch.zeros((1, 8, 3 * 96), dtype=torch.int8, device=cuda),
                              heads=4, dim=96, **kw)  # hd 24
    with pytest.raises(ValueError, match="head width"):
        qattention.qattention(torch.zeros((1, 8, 3 * 288), dtype=torch.int8, device=cuda),
                              heads=2, dim=288, **kw)  # hd 144
    base = torch.zeros(3 * 64 * 8 + 1, dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError, match="16-byte"):
        qattention.qattention(base[1:].view(1, 8, 192), heads=1, dim=64, **kw)
    assert not qattention.covers(8, 24) and not qattention.covers(8, 144)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["vit_b16", "vit_b16_cls"])
@pytest.mark.parametrize("weight_bits", [8, 4])
def test_vit_engine_every_node_equals_plain(cuda, name, weight_bits):
    """A small ViT (depth 2, dim 64, 4 heads, image 64) through Engine on
    the card: launch counts per forward, every node equal to the plain path
    on the card, logits equal to the Engine on the CPU. At W4 the qkv and
    mlp1 GEMMs keep packed pot4 codes and the residual GEMMs are decoded."""
    from tf2_tpu_torch.graph import execute
    from tf2_tpu_torch.models import synthetic_quantized
    from tf2_tpu_torch.runtime import Engine

    art = synthetic_quantized(name, seed=0, batch=2, image=64, classes=10, dim=64, depth=2,
                              heads=4, weight_bits=weight_bits)
    x = np.random.default_rng(0).standard_normal((2, 64, 64, 3)).astype(np.float32)
    eng = Engine(art.graph, art.params)
    kernels.reset_launch_counts()
    logits = eng.run(image=x)
    pot4 = 0 if weight_bits == 8 else 4
    assert kernels.launch_counts() == {"qmatmul_pot4": pot4, "qmatmul_int8": 10 - pot4,
                                       "qconv_s1": 0, "qconv_s2": 0, "qblockchain": 0,
                                       "qlrn": 0, "qattention": 2,
                                       "qconv_s2x1": 0, "qstem": 0}
    xt = torch.as_tensor(x).to(cuda)
    _, env = execute(eng.graph, intermediates=True)(eng.params, image=xt)
    _, plain = execute(eng.graph, intermediates=True, plain=True)(eng.params, image=xt)
    for n in eng.graph.nodes:
        assert torch.equal(env[n.name], plain[n.name]), n.name
    cpu = Engine(art.graph, art.params, device="cpu").run(image=x)
    assert torch.equal(logits.cpu(), cpu)


@pytest.mark.cuda
@pytest.mark.parametrize("name,image,launches", [
    ("googlenet", 64, {"qmatmul_pot4": 37, "qmatmul_int8": 1, "qconv_s1": 19,
                       "qconv_s2": 1, "qblockchain": 0, "qlrn": 2, "qattention": 0,
                       "qconv_s2x1": 0, "qstem": 0}),
    ("squeezenet_v1_1", 96, {"qmatmul_pot4": 16, "qmatmul_int8": 1, "qconv_s1": 8,
                             "qconv_s2": 1, "qblockchain": 0, "qlrn": 0, "qattention": 0,
                             "qconv_s2x1": 0, "qstem": 0}),
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


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w,cin,cout,kh,kw,pads,wfmt", [
    (2, 64, 34, 6, 64, 7, 4, ((2, 3), (0, 0)), "int8"),   # ResNet's packed stem, image 64
    (2, 63, 32, 6, 64, 3, 2, ((0, 0), (0, 0)), "int8"),   # SqueezeNet's, VALID
    (1, 128, 65, 6, 32, 3, 2, ((0, 1), (0, 0)), "int8"),  # SSD's, image 128
    (3, 17, 9, 2, 40, 5, 3, ((2, 2), (0, 0)), "int8"),    # cin 1 packed, odd H
    (2, 15, 12, 32, 48, 3, 3, ((1, 1), (1, 1)), "pot4"),
])
@pytest.mark.parametrize("relu", [False, True])
def test_qconv_s2x1_matches_plain(cuda, b, h, w, cin, cout, kh, kw, pads, wfmt, relu):
    """The stride-(2, 1) entry of the conv kernel on the wpack2 stems'
    shapes, and on a pot4 conv."""
    rng = np.random.default_rng(cin + cout + kh)
    x = rng.integers(-127, 128, (b, h, w, cin), dtype=np.int8)
    if wfmt == "pot4":
        wparam = potq.pack_codes(rng.integers(0, 16, (kh * kw * cin, cout)).astype(np.uint8))
    else:
        wparam = rng.integers(-127, 128, (kh, kw, cin, cout), dtype=np.int8)
    es = rng.uniform(1e-5, 1e-3, cout).astype(np.float32)
    eb = rng.standard_normal(cout).astype(np.float32)
    x, wparam, es, eb = _tensors(cuda, x, wparam, es, eb)
    kw_ = dict(kshape=(kh, kw, cin, cout), pads=pads, relu=relu, wfmt=wfmt)
    before = kernels.launch_counts()["qconv_s2x1"]
    got = qconv.qconv_s2x1(x, wparam, es, eb, **kw_)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["qconv_s2x1"] == before + 1
    want = qconv.qconv_plain(x, wparam, es, eb, strides=(2, 1), **kw_)
    assert torch.equal(got, want)
    assert 0 < int((want != 0).sum()) < want.numel()


def _stem_case(rng, b, h, w, cin, cout, k, extreme):
    if extreme:
        x = rng.choice(np.array([-127, 127], np.int8), size=(b, h, w, cin))
        w_q = rng.choice(np.array([-127, 127], np.int8), size=(k, k, cin, cout))
    else:
        x = rng.integers(-127, 128, (b, h, w, cin), dtype=np.int8)
        w_q = rng.integers(-127, 128, (k, k, cin, cout), dtype=np.int8)
    es = (rng.uniform(0.5, 4.0, cout) / (127 * np.sqrt(k * k * cin))).astype(np.float32)
    eb = rng.normal(0, 20, cout).astype(np.float32)
    return x, w_q, es, eb


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w,cin,cout,k,padding", [
    (2, 224, 224, 3, 64, 7, "SAME"),     # ResNet-50 / GoogLeNet
    (2, 224, 224, 3, 64, 3, "VALID"),    # SqueezeNet v1.1
    (2, 256, 256, 3, 32, 3, "SAME"),     # SSD
    (3, 37, 41, 1, 16, 5, "SAME"), (3, 33, 19, 2, 24, 5, "VALID"),
    (1, 30, 30, 4, 130, 7, "SAME"),      # cout above one 64-channel chunk
    (2, 9, 7, 3, 8, 1, "SAME")])
@pytest.mark.parametrize("relu", [False, True])
def test_qstem_kernel_matches_plain(cuda, b, h, w, cin, cout, k, padding, relu):
    """The stem kernel on the zoo's stems and ragged ones, with the f32
    image quantized inside (scale) and on int8 input, random and +-127."""
    rng = np.random.default_rng(h + w + cin + k)
    for extreme in (False, True):
        x, w_q, es, eb = _stem_case(rng, b, h, w, cin, cout, k, extreme)
        wmat, es, eb = _tensors(cuda, qstem.fold_weight(w_q).numpy(), es, eb)
        kw = dict(kh=k, kw=k, padding=padding, relu=relu)
        xf = torch.as_tensor(x.astype(np.float32) * np.float32(0.02)
                             + rng.uniform(-0.01, 0.01, x.shape).astype(np.float32)).to(cuda)
        for xin, scale in ((torch.as_tensor(x).to(cuda), None), (xf, 0.02)):
            before = kernels.launch_counts()["qstem"]
            got = qstem.qstem(xin, wmat, es, eb, scale=scale, **kw)
            torch.cuda.synchronize()
            assert kernels.launch_counts()["qstem"] == before + 1
            want = qstem.qstem_plain(xin, wmat, es, eb, scale=scale, **kw)
            assert torch.equal(got, want)
        assert torch.equal(got.cpu(), qstem.qstem_plain(xf.cpu(), wmat.cpu(), es.cpu(), eb.cpu(),
                                                        scale=0.02, **kw))


@pytest.mark.cuda
def test_stem_engines_every_node_equals_plain(cuda):
    """A small ResNet with Engine(phase_stem=True) and Engine(optimize=True)
    on the card: launch counts, every node equal to the plain path, logits
    equal to the default Engine's and to the same Engine on the CPU."""
    from tf2_tpu_torch.graph import execute
    from tf2_tpu_torch.models import synthetic_quantized
    from tf2_tpu_torch.runtime import Engine

    art = synthetic_quantized("resnet50", seed=0, batch=2, image=64,
                              depths=(1, 1, 1, 1), classes=64)
    x = np.random.default_rng(0).standard_normal((2, 64, 64, 3)).astype(np.float32)
    xt = torch.as_tensor(x).to(cuda)
    default = Engine(art.graph, art.params).run(image=x)
    base = {"qmatmul_pot4": 9, "qmatmul_int8": 1, "qconv_s1": 1, "qconv_s2": 7,
            "qblockchain": 0, "qlrn": 0, "qattention": 0, "qconv_s2x1": 0, "qstem": 0}
    for flag, moved in (("phase_stem", {"qconv_s2": 6, "qconv_s2x1": 1}),
                        ("optimize", {"qconv_s2": 6, "qconv_s1": 2})):
        eng = Engine(art.graph, art.params, **{flag: True})
        kernels.reset_launch_counts()
        logits = eng.run(image=x)
        assert kernels.launch_counts() == {**base, **moved}, flag
        _, env = execute(eng.graph, intermediates=True)(eng.params, image=xt)
        _, plain = execute(eng.graph, intermediates=True, plain=True)(eng.params, image=xt)
        for n in eng.graph.nodes:
            assert torch.equal(env[n.name], plain[n.name]), (flag, n.name)
        assert torch.equal(logits, default)
        cpu = Engine(art.graph, art.params, device="cpu", **{flag: True}).run(image=x)
        assert torch.equal(logits.cpu(), cpu)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["random", "background"])
def test_ssd_engine_every_node_equals_plain(cuda, case):
    """A small SSD (image 128) on the card under both score cases: 8
    qconv_s1 and 6 qconv_s2 launches a forward, every node equal to the
    plain path, detections equal to the Engine on the CPU."""
    from tf2_tpu_torch.bench.ssd_cases import case_params
    from tf2_tpu_torch.graph import execute
    from tf2_tpu_torch.models import synthetic_quantized
    from tf2_tpu_torch.runtime import Engine

    art = synthetic_quantized("ssd", seed=0, batch=2, image=128)
    params = case_params(case, art.graph, art.params)
    x = np.random.default_rng(0).standard_normal((2, 128, 128, 3)).astype(np.float32)
    eng = Engine(art.graph, params)
    kernels.reset_launch_counts()
    dets = eng.run(image=x)
    counts = kernels.launch_counts()
    assert (counts["qconv_s1"], counts["qconv_s2"]) == (8, 6)
    assert sum(counts.values()) == 14
    xt = torch.as_tensor(x).to(cuda)
    _, env = execute(eng.graph, intermediates=True)(eng.params, image=xt)
    _, plain = execute(eng.graph, intermediates=True, plain=True)(eng.params, image=xt)
    for n in eng.graph.nodes:
        assert torch.equal(env[n.name], plain[n.name]), n.name
    assert torch.equal(dets.cpu(), Engine(art.graph, params, device="cpu").run(image=x))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["convs", "vit_hd24"])
def test_engine_with_plain_nodes_equals_cpu(cuda, case):
    """Graphs outside the zoo (tf2_tpu_torch/bench/coverage_cases.py): the
    Engine's coverage plan lists the nodes no kernel takes, they run their
    plain versions on the card, every other node its kernel, and every
    node equals the Engine on the CPU."""
    from tf2_tpu_torch.bench import coverage_cases
    from tf2_tpu_torch.graph import execute
    from tf2_tpu_torch.runtime import Engine

    if case == "convs":
        art, image, want = coverage_cases.conv_artifact(), 32, coverage_cases.CONV_PLAIN
    else:
        art, image, want = coverage_cases.tiny_vit_hd24(), 64, {"blk0_attn"}
    eng = Engine(art.graph, art.params)
    cpu = Engine(art.graph, art.params, device="cpu")
    assert eng.plain_nodes == want and cpu.plain_nodes == frozenset()
    x = np.random.default_rng(0).standard_normal((2, image, image, 3)).astype(np.float32)
    kernels.reset_launch_counts()
    logits = eng.run(image=x)
    assert sum(kernels.launch_counts().values()) > 0
    _, env = execute(eng.graph, intermediates=True, plain_nodes=eng.plain_nodes)(
        eng.params, image=torch.as_tensor(x).to(cuda))
    _, cpu_env = execute(cpu.graph, intermediates=True)(cpu.params, image=torch.as_tensor(x))
    for n in eng.graph.nodes:
        assert torch.equal(env[n.name].cpu(), cpu_env[n.name]), n.name
    assert torch.equal(logits.cpu(), cpu.run(image=x))
