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
    eng = Engine(art.graph, art.params, block_fusion=False)
    kernels.reset_launch_counts()
    logits = eng.run(image=x)
    assert kernels.launch_counts() == {"qmatmul_pot4": 9, "qmatmul_int8": 1,
                                       "qconv_s1": 1, "qconv_s2": 6, "qblockchain": 0,
                                       "qlrn": 0, "qattention": 0,
                                       "qconv_s2x1": 0, "qstem": 1, "nms": 0,
                                       "qlayernorm": 0, "qdwconv": 0}
    assert eng.stem_nodes == {"conv1_relu"}
    assert set(kernels.prepared_per_call().values()) == {0}
    xt = torch.as_tensor(x).to(cuda)
    _, env = execute(eng.graph, intermediates=True)(eng.params, image=xt)
    _, plain = execute(eng.graph, intermediates=True, plain=True)(eng.params, image=xt)
    for n in eng.graph.nodes:
        assert torch.equal(env[n.name], plain[n.name]), n.name
    cpu = Engine(art.graph, art.params, device="cpu", block_fusion=False).run(image=x)
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
    (64, 9, 13, 48, 40, 64, 2, True),       # Cm % 16 != 0
    (64, 9, 13, 64, 40, 64, 1, False),
    (96, 12, 12, 32, 32, 96, 3, True),      # Cin != Cout, downsample
    (3, 8, 8, 64, 16, 64, 3, False),
    (1, 7, 7, 2048, 512, 2048, 2, False),   # stage 4 at batch 1
])
@pytest.mark.parametrize("relu", [False, True])
def test_qblockchain_kernel_matches_plain(cuda, b, h, w, cin, cm, cout, nblocks, down, relu):
    """The chain kernel equals the plain chain on ragged chains, each block
    on the plan ``launch_plan`` picks on this card."""
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
                                       "qconv_s1": 0, "qconv_s2": 6, "qblockchain": 4,
                                       "qlrn": 0, "qattention": 0,
                                       "qconv_s2x1": 0, "qstem": 1, "nms": 0,
                                       "qlayernorm": 0, "qdwconv": 0}
    assert set(kernels.prepared_per_call().values()) == {0}
    xt = torch.as_tensor(x).to(cuda)
    _, env = execute(eng.graph, intermediates=True)(eng.params, image=xt)
    _, plain = execute(eng.graph, intermediates=True, plain=True)(eng.params, image=xt)
    for n in eng.graph.nodes:
        assert torch.equal(env[n.name], plain[n.name]), n.name
    cpu = Engine(art.graph, art.params, device="cpu", block_fusion=True).run(image=x)
    assert torch.equal(logits.cpu(), cpu)
    assert torch.equal(logits, Engine(art.graph, art.params, block_fusion=False).run(image=x))


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


# (m, k, n, byte offset of x in its storage, residual, the plan's name):
# every tile, split-K and not, each copy width of x (16, 8, 4, padded) and
# of the output (16, 8, 4, 2, 1)
GEMM_PLANS = [
    (4096, 256, 1024, 0, True, "128x128 a16 o16"),
    (2048, 192, 1024, 0, False, "128x128 a16 o16"),
    (197, 768, 2304, 0, True, "128x64 a16 o16 split3"),
    (16, 64, 8464, 0, False, "64x128 a16 o16"),
    (64, 2048, 1000, 0, True, "64x64 a16 o8 split8"),
    (300, 200, 130, 0, True, "64x64 a8 o2"),
    (33, 196, 99, 0, False, "64x64 a4 o1"),
    (33, 50, 20, 0, True, "64x64 apad o4"),
    (40, 64, 48, 4, False, "64x64 a4 o16"),
    (1, 3072, 768, 0, True, "64x64 a16 o16 split12"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,x_offset,resid,name", GEMM_PLANS)
@pytest.mark.parametrize("prepared", [True, False])
def test_qmatmul_int8_plan_variants(cuda, m, k, n, x_offset, resid, name, prepared):
    """Each variant of the int8 GEMM's plan equals the plain version, with
    the weight prepared (K-major, as the Engine holds it) or prepared by
    the wrapper on the call (counted)."""
    rng = np.random.default_rng(m + k + n)
    x, _, w, _, eb = _gemm(rng, m, k, n)
    es = (rng.uniform(0.5, 3.0, n) / (127 * np.sqrt(k))).astype(np.float32)
    xs = torch.zeros(m * k + x_offset, dtype=torch.int8, device=cuda)
    xs[x_offset:] = torch.as_tensor(x.reshape(-1)).to(cuda)
    x = xs[x_offset:].view(m, k)
    w, es, eb = _tensors(cuda, w, es, eb)
    residual = None
    if resid:
        residual = (torch.as_tensor(rng.integers(-127, 128, (m, n), dtype=np.int8)).to(cuda), 0.61)
    wq = shift_matmul.prepare_weight(w) if prepared else w
    assert (shift_matmul.prepared_ld(wq) is not None) == prepared
    assert shift_matmul.launch_plan(x, n, residual).name == name
    kernels.reset_launch_counts()
    got = shift_matmul.qmatmul_int8(x, wq, es, eb, True, residual)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["qmatmul_int8"] == 1
    assert kernels.prepared_per_call()["qmatmul_int8"] == (0 if prepared else 1)
    assert torch.equal(got, shift_matmul.qmatmul_int8_plain(x, w, es, eb, True, residual))
    assert torch.equal(wq, w)


# (m, k, n, byte offset of x in its storage): K = 2, 16, 48 and 2 * odd,
# N = 1, 16, 24, 48, 1000, x at every alignment, M = 1 and 63, a K * BN too
# large for one slab, split-K under a wave (chip_smoke.py: RAGGED_POT4)
POT4_PLANS = [(1, 2, 1, 0), (63, 16, 16, 0), (63, 48, 24, 0), (100, 34, 48, 0),
              (130, 50, 1000, 0), (1, 2048, 1000, 0), (63, 96, 200, 8), (300, 200, 130, 4),
              (70, 64, 36, 2), (65, 66, 99, 1), (20000, 4608, 128, 0), (4096, 256, 1024, 0)]


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,x_offset", POT4_PLANS)
@pytest.mark.parametrize("prepared", [True, False])
def test_qmatmul_pot4_plan_variants(cuda, m, k, n, x_offset, prepared):
    """The pot4 kernel on each kind of plan (kernels/shift_matmul.py:
    plan_pot4) equals the plain version, the codes prepared K-major (as the
    Engine holds them) or prepared by the wrapper on the call (counted),
    relu on and off, on random and on +-127 inputs and max-magnitude codes."""
    rng = np.random.default_rng(m + k + n)
    codes = rng.integers(0, 16, (k, n)).astype(np.uint8)
    packed = torch.as_tensor(potq.pack_codes(codes)).to(cuda)
    es = torch.as_tensor((rng.uniform(0.5, 3.0, n) / (64 * np.sqrt(k))).astype(np.float32)).to(cuda)
    eb = torch.as_tensor(rng.normal(0, 3, n).astype(np.float32)).to(cuda)
    xs = torch.zeros(m * k + x_offset, dtype=torch.int8, device=cuda)
    x = xs[x_offset:].view(m, k)
    wq = shift_matmul.prepare_weight(packed) if prepared else packed
    assert (shift_matmul.prepared_ld(wq) is not None) == prepared
    p = shift_matmul.launch_plan_pot4(x, n)
    assert p.avec == next((v for v in (16, 8, 4) if k % v == 0 and (x_offset or 16) % v == 0), 0)
    for xv, w in ((rng.integers(-127, 128, m * k, dtype=np.int8), wq),
                  (rng.choice(np.array([-127, 127], np.int8), m * k),
                   shift_matmul.prepare_weight(torch.full_like(packed, 0x77)) if prepared
                   else torch.full_like(packed, 0xF7))):
        x.copy_(torch.as_tensor(xv).view(m, k).to(cuda))
        for relu in (True, False):
            kernels.reset_launch_counts()
            got = shift_matmul.qmatmul_pot4(x, w, es, eb, relu)
            torch.cuda.synchronize()
            assert kernels.launch_counts()["qmatmul_pot4"] == 1
            unprepared = shift_matmul.prepared_ld(w) is None
            assert kernels.prepared_per_call()["qmatmul_pot4"] == int(unprepared)
            assert torch.equal(got, shift_matmul.qmatmul_pot4_plain(x, w, es, eb, relu)), p.name


@pytest.mark.cuda
@pytest.mark.parametrize("k", [510, 512, 514, 516])
@pytest.mark.parametrize("code", [7, 15])
def test_qmatmul_pot4_at_the_accumulator_bound(cuda, k, code):
    """x = -128 against codes of +64 (7) or -64 (15): every accumulator is
    -+128 * 64 * K, just inside 2^22 at K = 512 and past it at K = 514 and
    516 (csrc/shift_matmul.cu: small), with es and eb that put the outputs
    in range, so a wrong conversion shows."""
    m, n = 70, 40
    rng = np.random.default_rng(k + code)
    x = torch.full((m, k), -128, dtype=torch.int8, device=cuda)
    packed = torch.as_tensor(potq.pack_codes(np.full((k, n), code, np.uint8))).to(cuda)
    acc = -128 * 64 * k * (1 if code == 7 else -1)
    es = torch.full((n,), 2.0 ** -10, dtype=torch.float32, device=cuda)
    eb = torch.as_tensor((-acc * 2.0 ** -10 + rng.uniform(-60, 60, n)).astype(np.float32)).to(cuda)
    for relu in (True, False):
        got = shift_matmul.qmatmul_pot4(x, shift_matmul.prepare_weight(packed), es, eb, relu)
        assert torch.equal(got, shift_matmul.qmatmul_pot4_plain(x, packed, es, eb, relu))


def _lrn_near_boundaries(rng, dev, c, radius, s_in, alpha):
    """Inputs and s_out values that put y / s_out on and next to half-integers:
    s_out = v / (k + 1/2) for an element's v = y (before the division) and
    each k, and the f32 values either side of it."""
    x = torch.as_tensor(rng.integers(-127, 128, (257, c), dtype=np.int8)).to(dev)
    kw = dict(radius=radius, alpha=alpha, beta=0.75, bias=1.0)
    v = qlrn.lrn_f32(x.to(torch.float32) * np.float32(s_in), **kw).flatten()
    big = v[v.abs() > 1].cpu().numpy()
    cases = []
    for k, vj in zip(range(0, 127, 6), big[::max(1, big.size // 22)]):
        s0 = np.float32(abs(vj) / (k + 0.5))
        for s_out in (s0, np.nextafter(s0, np.float32(1)), np.nextafter(s0, np.float32(0))):
            cases.append(dict(kw, s_in=s_in, s_out=float(s_out)))
    return x, cases


@pytest.mark.cuda
@pytest.mark.parametrize("c,radius", [(64, 2), (192, 1), (13, 2)])
@pytest.mark.parametrize("s_in,alpha", [(0.0312, 2e-4), (0.5, 1e-4)])
def test_qlrn_kernel_on_half_boundaries(cuda, c, radius, s_in, alpha):
    """Outputs on and next to every kind of rounding boundary: the
    certified epilogue sends them to the exact steps (counted), and the
    kernel equals qlrn_plain; C = 64 and 192 take the fast kernel, C = 13
    the generic one."""
    x, cases = _lrn_near_boundaries(np.random.default_rng(c + radius), cuda, c, radius,
                                    s_in, alpha)
    slow = torch.zeros(1, dtype=torch.int32, device=cuda)
    for kw in cases:
        assert torch.equal(qlrn.qlrn(x, slow_count=slow, **kw), qlrn.qlrn_plain(x, **kw)), kw
    assert int(slow) > 0


# (b, h, w, cin, cm, cout, down, the plan: g, r, wc, c, bn): bands and whole
# images, clusters of 1 to 16 CTAs, MMA widths 32 and 64, narrow bands,
# ragged channels (Cm and Cout not multiples of 16, Cin padded)
CHAIN_PLANS = [
    ((2, 9, 13, 48, 64, 64, True), (1, 2, 13, 1, 64)),
    ((2, 9, 13, 64, 40, 64, False), (1, 3, 13, 1, 32)),
    ((1, 12, 30, 32, 32, 32, False), (1, 1, 7, 1, 32)),
    ((2, 14, 14, 64, 64, 128, True), (1, 4, 14, 2, 32)),
    ((3, 7, 7, 256, 256, 256, False), (1, 7, 7, 4, 64)),
    ((5, 7, 7, 512, 512, 512, False), (2, 7, 7, 8, 64)),
    ((4, 8, 8, 64, 32, 64, False), (3, 8, 8, 1, 32)),
    ((1, 7, 7, 512, 512, 512, False), (1, 7, 7, 16, 32)),
    ((2, 6, 6, 40, 16, 40, False), (1, 6, 6, 1, 32)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,plan", CHAIN_PLANS)
@pytest.mark.parametrize("relu", [False, True])
def test_qblockchain_plan_variants(cuda, monkeypatch, shape, plan, relu):
    """The chain kernel on each kind of plan (given, not picked), two
    blocks, equal to the plain chain; weights prepared on the call the
    first time (counted), prepared beforehand the second."""
    b, h, w, cin, cm, cout, down = shape
    rng = np.random.default_rng(sum(shape))
    blocks = _chain(rng, cuda, cin, cm, cout, 2, down, relu)
    x = torch.as_tensor(rng.integers(-127, 128, (b, h, w, cin), dtype=np.int8)).to(cuda)
    p = qblocks.make_plan(b, h, w, cm, *plan)
    assert p.smem <= qblocks.SMEM_LIMIT
    monkeypatch.setattr(qblocks, "launch_plan", lambda *a: p)
    want = qblocks.qblockchain_plain(x, blocks)
    kernels.reset_launch_counts()
    got = qblocks.qblockchain(x, blocks)
    torch.cuda.synchronize()
    assert kernels.prepared_per_call()["qblockchain"] == (7 if down else 6)
    assert got.shape == (b, h, w, cout) and torch.equal(got, want)
    for blk in blocks:
        for key in ("w1", "w3", "wd"):
            if key in blk:
                blk[key] = shift_matmul.prepare_weight(blk[key])
        blk["w2"] = qblocks.prepare_w2(blk["w2"])
    kernels.reset_launch_counts()
    assert torch.equal(qblocks.qblockchain(x, blocks), want)
    assert kernels.prepared_per_call()["qblockchain"] == 0
    assert kernels.launch_counts()["qblockchain"] == 1


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
                                       "qconv_s2x1": 0, "qstem": 0, "nms": 0,
                                       "qlayernorm": 5, "qdwconv": 0}
    assert set(kernels.prepared_per_call().values()) == {0}
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
                       "qconv_s2": 0, "qblockchain": 0, "qlrn": 2, "qattention": 0,
                       "qconv_s2x1": 0, "qstem": 1, "nms": 0, "qlayernorm": 0,
                       "qdwconv": 0}),
    ("squeezenet_v1_1", 96, {"qmatmul_pot4": 16, "qmatmul_int8": 1, "qconv_s1": 8,
                             "qconv_s2": 0, "qblockchain": 0, "qlrn": 0, "qattention": 0,
                             "qconv_s2x1": 0, "qstem": 1, "nms": 0, "qlayernorm": 0,
                       "qdwconv": 0}),
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
        assert set(kernels.prepared_per_call().values()) == {0}
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
    else:  # the int8 path takes -128 as it is
        x = rng.integers(-128, 128, (b, h, w, cin), dtype=np.int8)
        w_q = rng.integers(-127, 128, (k, k, cin, cout), dtype=np.int8)
    es = (rng.uniform(0.5, 4.0, cout) / (127 * np.sqrt(k * k * cin))).astype(np.float32)
    eb = rng.normal(0, 20, cout).astype(np.float32)
    return x, w_q, es, eb


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w,cin,cout,k,padding", [
    (2, 224, 224, 3, 64, 7, "SAME"),     # ResNet-50 / GoogLeNet
    (2, 224, 224, 3, 64, 3, "VALID"),    # SqueezeNet v1.1
    (2, 256, 256, 3, 32, 3, "SAME"),     # SSD
    (3, 37, 41, 1, 16, 5, "SAME"),       # f32 rows of 164 bytes: 4-byte copies
    (3, 33, 19, 2, 24, 5, "VALID"),      # int8 rows of 38 bytes: read in the conversion
    (1, 30, 30, 4, 130, 7, "SAME"),      # five 32-channel chunks, the last of 2
    (2, 9, 7, 3, 8, 1, "SAME"),
    (2, 15, 13, 3, 96, 3, "SAME"),       # three chunks
    (2, 17, 21, 2, 32, 3, "VALID"),
    (5, 23, 29, 1, 64, 3, "SAME"),
    (2, 21, 19, 4, 32, 7, "VALID")])
@pytest.mark.parametrize("relu", [False, True])
def test_qstem_kernel_matches_plain(cuda, b, h, w, cin, cout, k, padding, relu):
    """The stem kernel on the zoo's stems and ragged ones (k 1-7, odd H
    and W, cin 1-4, cout 8-130, VALID and SAME, rows whose bytes 16 does
    not divide), with the f32 image quantized inside (scale) and on int8
    input (-128 included), random and +-127; the weight folded
    (``fold_weight``, prepared on the call)."""
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
@pytest.mark.parametrize("scale", [0.013, 0.02, 0.5, 1.7])
def test_qstem_quantize_on_half_boundaries(cuda, scale):
    """The kernel's certified quantize (x times the scale's f32 reciprocal,
    the division where that lies near a half-integer) on inputs on and next
    to every half-integer multiple of the scale: the IEEE division's bits."""
    rng = np.random.default_rng(int(scale * 1000))
    _, w_q, es, eb = _stem_case(rng, 2, 29, 29, 3, 64, 7, False)
    w_q, es, eb = _tensors(cuda, w_q, es, eb)
    half = ((rng.integers(-140, 140, (2, 29, 29, 3)) + 0.5) * np.float32(scale)).astype(np.float32)
    up, down = np.float32(np.inf), np.float32(-np.inf)
    for xv in (half, np.nextafter(half, up), np.nextafter(half, down)):
        x = torch.as_tensor(xv).to(cuda)
        kw = dict(padding="SAME", relu=False, scale=scale)
        got = qstem.fused_qstem(x, qstem.prepare_weight(w_q), es, eb, **kw)
        assert torch.equal(got, qstem.fused_qstem(x, w_q, es, eb, plain=True, **kw))


@pytest.mark.cuda
def test_fused_qstem_on_prepared_weights(cuda):
    """``fused_qstem`` on ``prepare_weight``'s view prepares nothing and
    lays each launch out once; on the HWIO weight it prepares on each call
    (counted); both equal the plain version; a shape the plan has no
    launch for (k 9) takes the quantize and the stride-2 conv kernel
    (``TWO_PASS``), equal to the plain version too."""
    rng = np.random.default_rng(4)
    x, w_q, es, eb = _stem_case(rng, 3, 64, 64, 3, 64, 7, False)
    xf = torch.as_tensor(x.astype(np.float32) * np.float32(0.02)).to(cuda)
    w_q, es, eb = _tensors(cuda, w_q, es, eb)
    wp = qstem.prepare_weight(w_q)
    kw = dict(padding="SAME", relu=True, scale=0.02)
    want = qstem.fused_qstem(xf, w_q, es, eb, plain=True, **kw)
    kernels.reset_launch_counts()
    for _ in range(3):
        assert torch.equal(qstem.fused_qstem(xf, wp, es, eb, **kw), want)
    assert kernels.prepared_per_call()["qstem"] == 0 and kernels.launch_counts()["qstem"] == 3
    assert torch.equal(qstem.fused_qstem(xf, w_q, es, eb, **kw), want)
    assert kernels.prepared_per_call()["qstem"] == 1
    w9 = torch.as_tensor(rng.integers(-127, 128, (9, 9, 3, 8), dtype=np.int8)).to(cuda)
    before = dict(qstem.TWO_PASS), kernels.launch_counts()
    got = qstem.fused_qstem(xf, w9, es[:8], eb[:8], **kw)
    assert torch.equal(got, qstem.fused_qstem(xf, w9, es[:8], eb[:8], plain=True, **kw))
    assert qstem.TWO_PASS["qstem"] == before[0]["qstem"] + 1
    assert kernels.launch_counts()["qconv_s2"] == before[1]["qconv_s2"] + 1
    assert kernels.launch_counts()["qstem"] == before[1]["qstem"]


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
    default = Engine(art.graph, art.params, block_fusion=False).run(image=x)
    # the unfused Engine's counts, its stem (one qstem launch) taken off
    base = {"qmatmul_pot4": 9, "qmatmul_int8": 1, "qconv_s1": 1, "qconv_s2": 6,
            "qblockchain": 0, "qlrn": 0, "qattention": 0, "qconv_s2x1": 0, "qstem": 0,
            "nms": 0, "qlayernorm": 0, "qdwconv": 0}
    for flag, moved in (("phase_stem", {"qconv_s2x1": 1}), ("optimize", {"qconv_s1": 2})):
        eng = Engine(art.graph, art.params, block_fusion=False, **{flag: True})
        kernels.reset_launch_counts()
        logits = eng.run(image=x)
        assert kernels.launch_counts() == {**base, **moved}, flag
        _, env = execute(eng.graph, intermediates=True)(eng.params, image=xt)
        _, plain = execute(eng.graph, intermediates=True, plain=True)(eng.params, image=xt)
        for n in eng.graph.nodes:
            assert torch.equal(env[n.name], plain[n.name]), (flag, n.name)
        assert torch.equal(logits, default)
        cpu = Engine(art.graph, art.params, device="cpu", block_fusion=False,
                     **{flag: True}).run(image=x)
        assert torch.equal(logits.cpu(), cpu)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["random", "background"])
def test_ssd_engine_every_node_equals_plain(cuda, case):
    """A small SSD (image 128) on the card under both score cases: 8
    qconv_s1, 5 qconv_s2, 1 qstem and 1 nms launches a forward, every node
    equal to the plain path (the NMS's keep mask there the plain
    fixpoint), detections equal to the Engine on the CPU."""
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
    assert [counts[k] for k in ("qconv_s1", "qconv_s2", "qstem", "nms")] == [8, 5, 1, 1]
    assert sum(counts.values()) == 15
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


# ---- the captured forward, the routes, the wide stems (the Engine as the
# reference runs it) ----

def _small_resnet(batch=2):
    from tf2_tpu_torch.models import synthetic_quantized

    return synthetic_quantized("resnet50", seed=0, batch=batch, image=64,
                               depths=(1, 1, 1, 1), classes=64)


def _images(dev, n, batch=2, image=64, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.as_tensor(rng.standard_normal((batch, image, image, 3),
                                                dtype=np.float32)).to(dev) for _ in range(n)]


@pytest.mark.cuda
@pytest.mark.parametrize("flags", [{"block_fusion": False}, {}])
def test_built_engine_replays_equal_eager(cuda, flags):
    """``build`` runs one eager forward and one capture (twice a forward's
    launches, counted in the wrappers), then every call replays the graph:
    no wrapper runs (launch counts stay 0), three seeded inputs give the
    eager forward's outputs bit for bit, an output is not overwritten by
    the next call, and an input of another shape or dtype raises."""
    from tf2_tpu_torch.runtime import Engine

    art = _small_resnet()
    eager = Engine(art.graph, art.params, **flags)
    xs = _images(cuda, 3)
    want = [eager.run(image=x) for x in xs]
    kernels.reset_launch_counts()
    eager.run(image=xs[0])
    per_forward = kernels.launch_counts()
    eng = Engine(art.graph, art.params, **flags)
    kernels.reset_launch_counts()
    assert eng.build(image=xs[0]) is eng and eng.built
    assert kernels.launch_counts() == {k: 2 * v for k, v in per_forward.items()}
    kernels.reset_launch_counts()
    outs = [eng.run(image=x) for x in xs]
    assert set(kernels.launch_counts().values()) == {0}
    for got, w in zip(outs, want):
        assert torch.equal(got, w)
    first = outs[0].clone()
    eng.run(image=xs[1])
    assert torch.equal(outs[0], first)
    assert torch.equal(eng.run(image=xs[2].cpu().numpy()), want[2])
    with pytest.raises(ValueError, match="built for"):
        eng(image=torch.zeros((1, 64, 64, 3), device=cuda))
    with pytest.raises(ValueError, match="built for"):
        eng(image=xs[0].double())
    r = eng.benchmark(iters=5, reps=2, image=xs[0])
    assert r["captured"] and r["latency_s"] > 0


@pytest.mark.cuda
def test_donated_built_engine_equals_nondonated(cuda):
    from tf2_tpu_torch.runtime import Engine

    art = _small_resnet()
    xs = _images(cuda, 3, seed=1)
    ref = Engine(art.graph, art.params).build(image=xs[0])
    want = [ref.run(image=x) for x in xs]
    for built in (False, True):
        eng = Engine(art.graph, art.params, donate_inputs=True)
        if built:
            eng.build(image=xs[0].clone())
        for x, w in zip(xs, want):
            mine = x.clone()
            assert torch.equal(eng.run(image=mine), w)
            assert mine.untyped_storage().nbytes() == 0
        assert all(x.untyped_storage().nbytes() > 0 for x in xs)


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("case", ["random", "background"])
def test_ssd_built_engine_equals_eager(cuda, batch, case):
    """SSD's Engine builds into one CUDA graph, its NMS included: the
    build launches twice a forward's kernels (one nms a forward), three
    replays on seeded inputs launch none and equal the eager forward's
    detections bit for bit."""
    from tf2_tpu_torch.bench.ssd_cases import case_params
    from tf2_tpu_torch.models import synthetic_quantized
    from tf2_tpu_torch.runtime import Engine

    art = synthetic_quantized("ssd", seed=0, batch=batch, image=128)
    params = case_params(case, art.graph, art.params)
    xs = _images(cuda, 3, batch=batch, image=128, seed=batch)
    eager = Engine(art.graph, params)
    want = [eager.run(image=x) for x in xs]
    kernels.reset_launch_counts()
    eager.run(image=xs[0])
    per_forward = kernels.launch_counts()
    assert per_forward["nms"] == 1
    eng = Engine(art.graph, params)
    kernels.reset_launch_counts()
    assert eng.build(image=xs[0]).built
    assert kernels.launch_counts() == {k: 2 * v for k, v in per_forward.items()}
    kernels.reset_launch_counts()
    got = [eng.run(image=x) for x in xs]
    assert set(kernels.launch_counts().values()) == {0}
    for g, w in zip(got, want):
        assert tuple(g.shape) == (batch, 100, 6) and torch.equal(g, w)


# ---- the NMS keep-mask kernel (csrc/nms.cu) ----

def _nms_rows(rng, rows, k, kind):
    """(rows, k, 4) f32 xyxy boxes of one kind: ``random`` (uniform corners),
    ``ssd`` (boxes around a coarse grid of centres, as SSD's priors
    decoded: many overlaps, deep chains), ``zero`` (all-zero boxes),
    ``same`` (one box repeated), ``chain`` (each box overlapping only its
    neighbours above the threshold), ``special`` (inf and NaN corners)."""
    if kind == "random":
        lo = rng.uniform(0, 1, (rows, k, 2))
        return np.concatenate([lo, lo + rng.uniform(0, 0.5, (rows, k, 2))], -1).astype(np.float32)
    if kind == "ssd":
        c = rng.integers(0, 4, (rows, k, 2)) / 4 + rng.normal(0, 0.02, (rows, k, 2))
        wh = rng.uniform(0.1, 0.4, (rows, k, 2))
        return np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32)
    if kind == "zero":
        return np.zeros((rows, k, 4), np.float32)
    if kind == "same":
        return np.broadcast_to(np.float32([0.1, 0.2, 0.5, 0.7]), (rows, k, 4)).copy()
    if kind == "chain":
        x = np.arange(k, dtype=np.float32)[None, :] * 0.3
        x = np.broadcast_to(x, (rows, k))
        return np.stack([x, np.zeros_like(x), x + 1, np.ones_like(x)], -1).astype(np.float32)
    boxes = _nms_rows(rng, rows, k, "random")
    boxes.reshape(-1)[rng.integers(0, boxes.size, boxes.size // 50)] = np.inf
    boxes.reshape(-1)[rng.integers(0, boxes.size, boxes.size // 50)] = -np.inf
    boxes.reshape(-1)[rng.integers(0, boxes.size, boxes.size // 50)] = np.nan
    return boxes


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["random", "ssd", "zero", "same", "chain", "special"])
@pytest.mark.parametrize("rows,k", [(1280, 100), (1280, 200), (3, 1), (5, 31), (7, 257),
                                    (2, 1008), (2, 2000)])
@pytest.mark.parametrize("thresh", [0.45, 0.1])
def test_nms_kernel_matches_plain(cuda, kind, rows, k, thresh):
    """The kernel's keep mask equals the plain fixpoint's bit for bit, one
    launch a call, on random, SSD-like and edge rows (SSD b64's 1,280 rows
    of 100; k 1, 31, 257, 1,008, 2,000: not a multiple of 32, above the
    block size)."""
    from tf2_tpu_torch.kernels import detection

    boxes = torch.as_tensor(_nms_rows(np.random.default_rng(k + rows), rows, k, kind)).to(cuda)
    before = kernels.launch_counts()["nms"]
    got = detection.greedy_keep(boxes, thresh)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["nms"] == before + 1
    assert got.dtype == torch.bool and torch.equal(got, detection.greedy_keep_plain(boxes, thresh))
    if kind == "chain" and thresh == 0.45:  # IoU 0.54 with a neighbour, 0.25 one further
        assert got[0, ::2].all() and not got[0, 1::2].any()


@pytest.mark.cuda
def test_nms_kernel_at_the_threshold(cuda):
    """IoUs exactly at the threshold: 1 / 2 (boxes 0 and 1) against 0.5 and
    f32(0.1) = 1 / 10 (boxes 0 and 2) against 0.1 (compared in f32, as
    torch and JAX compare) keep the box; the kernel agrees with the plain
    version."""
    from tf2_tpu_torch.kernels import detection

    boxes = torch.tensor([[[0, 0, 1, 1], [0, 0, 2, 1], [0, 0, 10, 1]]], dtype=torch.float32,
                         device=cuda)
    for thresh, want in ((0.5, [True, True, True]), (0.1, [True, False, True]),
                         (0.0999, [True, False, False])):
        got = detection.greedy_keep(boxes, thresh)
        assert got[0].tolist() == want, thresh
        assert torch.equal(got, detection.greedy_keep_plain(boxes, thresh))


@pytest.mark.cuda
def test_nms_kernel_refuses_what_it_does_not_take(cuda):
    from tf2_tpu_torch.kernels import detection

    big = torch.zeros((1, detection.max_k() + 1, 4), device=cuda)
    with pytest.raises(ValueError, match="at most"):
        detection.greedy_keep(big, 0.45)
    with pytest.raises(ValueError, match="dtype"):
        detection.greedy_keep(torch.zeros((1, 8, 4), device=cuda, dtype=torch.float64), 0.45)
    with pytest.raises(ValueError, match="contiguous"):
        detection.greedy_keep(torch.zeros((8, 2, 4), device=cuda).transpose(0, 1), 0.45)
    assert detection.max_k() >= 1008


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,relu,resid", [(1, 64, 16, True, False), (40, 60, 20, False, True),
                                              (3136, 64, 256, True, False),
                                              (64, 2048, 1000, False, False),
                                              (394, 768, 2304, True, True)])
def test_library_matmul_matches_int8_kernel(cuda, m, k, n, relu, resid):
    """The ``library`` route (``torch._int_mm`` and the f32 epilogue) on
    the Engine's K-major weight equals the int8 GEMM kernel bit for bit."""
    from tf2_tpu_torch.kernels import dispatch

    x, _, w, es, eb = _tensors(cuda, *_gemm(np.random.default_rng(m + n), m, k, n))
    r = None
    if resid:
        r = (torch.as_tensor(np.random.default_rng(k).integers(-127, 128, (m, n),
                                                               dtype=np.int8)).to(cuda), 0.21)
    wk = shift_matmul.prepare_weight(w)
    want = shift_matmul.qmatmul_int8(x, wk, es, eb, relu, r)
    assert torch.equal(dispatch.library_matmul(x, wk, es, eb, relu, r), want)
    assert torch.equal(want, shift_matmul.qmatmul_int8_plain(x, w, es, eb, relu, r))


def _routed(art, table_path, route):
    """An Engine on ``route`` for every conv and dense key that has it
    (``library``: ``set_use_kernels(False)``)."""
    import json

    from tf2_tpu_torch.graph.shapes import activation_shapes
    from tf2_tpu_torch.kernels import autotune, dispatch
    from tf2_tpu_torch.runtime import Engine

    if route == "library":
        dispatch.set_use_kernels(False)
    else:
        shapes = activation_shapes(art.graph, art.params)
        routes = {}
        for n in art.graph.nodes:
            a = n.attrs
            if n.op == "qconv2d" and "kernel_int8" in dispatch.conv_choices(
                    a["kshape"], a.get("strides", [1, 1]), a.get("padding", "SAME"),
                    a.get("groups", 1), a["wfmt"]):
                routes[autotune.conv_key(shapes[n.inputs[0]], a["kshape"],
                                         a.get("strides", [1, 1]), a.get("groups", 1),
                                         a["wfmt"])] = route
            elif n.op == "qdense" and a["wfmt"] == "pot4":
                routes[autotune.dense_key(shapes[n.inputs[0]], a["kshape"], a["wfmt"])] = route
        table_path.write_text(json.dumps({"routes": routes, "detail": {}}))
        autotune.set_table_path(str(table_path))
    try:
        return Engine(art.graph, art.params, block_fusion=False)
    finally:
        dispatch.set_use_kernels(None)
        autotune.set_table_path(None)


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["kernel_int8", "library"])
def test_routed_engine_bit_equal_to_kernel(cuda, tmp_path, route):
    """Engines routed through ``kernel_int8`` (every pot4 conv and GEMM
    decoded at load, on the int8 kernels) and ``library`` (every GEMM on
    ``torch._int_mm``) equal ``set_use_kernels(True)``'s node by node,
    eager and built."""
    from tf2_tpu_torch.graph import execute
    from tf2_tpu_torch.kernels import dispatch
    from tf2_tpu_torch.runtime import Engine

    art = _small_resnet()
    dispatch.set_use_kernels(True)
    try:
        base = Engine(art.graph, art.params, block_fusion=False)
    finally:
        dispatch.set_use_kernels(None)
    eng = _routed(art, tmp_path / "t.json", route)
    assert eng.routes and set(eng.routes.values()) == {route}
    assert bool(eng.library_nodes) == (route == "library")
    x = _images(cuda, 1)[0]
    kernels.reset_launch_counts()
    logits = eng.run(image=x)
    counts = kernels.launch_counts()
    if route == "kernel_int8":
        assert counts["qmatmul_pot4"] == 0 and counts["qmatmul_int8"] > 1
    else:
        assert counts["qmatmul_pot4"] + counts["qmatmul_int8"] == 0
    _, env = execute(eng.graph, intermediates=True, library_nodes=eng.library_nodes)(
        eng.params, image=x)
    _, base_env = execute(base.graph, intermediates=True)(base.params, image=x)
    for n in eng.graph.nodes:
        assert torch.equal(env[n.name], base_env[n.name]), n.name
    assert torch.equal(logits, base.run(image=x))
    assert torch.equal(eng.build(image=x).run(image=x), logits)


@pytest.mark.cuda
@pytest.mark.parametrize("k,cout", [(9, 64), (7, 288)])
def test_wide_stem_engine_on_card(cuda, k, cout):
    """A stem ``covers`` takes and the stem kernel's plan has no launch for
    (``coverage_cases.stem_artifact``): outside ``Engine.stem_plan``, on the
    quantize and the stride-2 conv kernel; every node equal to the plain
    path and the logits to the Engine on the CPU, eager and built; and
    ``fused_qstem`` on its weight takes the same two passes (``TWO_PASS``),
    equal to ``qstem_plain``."""
    from tf2_tpu_torch.bench import coverage_cases
    from tf2_tpu_torch.graph import execute
    from tf2_tpu_torch.runtime import Engine

    art = coverage_cases.stem_artifact(k, cout)
    x = _images(cuda, 1, image=32, seed=k)[0]
    eng = Engine(art.graph, art.params)
    assert eng.stem_nodes == frozenset() and eng.plain_nodes == frozenset()
    kernels.reset_launch_counts()
    logits = eng.run(image=x)
    assert kernels.launch_counts()["qstem"] == 0 and kernels.launch_counts()["qconv_s2"] == 1
    _, env = execute(eng.graph, intermediates=True)(eng.params, image=x)
    _, plain = execute(eng.graph, intermediates=True, plain=True)(eng.params, image=x)
    for n in eng.graph.nodes:
        assert torch.equal(env[n.name], plain[n.name]), n.name
    cpu = Engine(art.graph, art.params, device="cpu").run(image=x.cpu())
    assert torch.equal(logits.cpu(), cpu)
    assert torch.equal(eng.build(image=x).run(image=x), logits)
    stem = eng.graph.nodes[0]
    w, es, eb = (eng.params[p] for p in stem.params)
    before = qstem.TWO_PASS["qstem"]
    kw = dict(padding="SAME", relu=stem.attrs["relu"], scale=stem.attrs["s_in"])
    got = qstem.fused_qstem(x, w, es, eb, **kw)
    assert qstem.TWO_PASS["qstem"] == before + 1
    assert torch.equal(got, qstem.fused_qstem(x, w, es, eb, plain=True, **kw))
    assert torch.equal(got, env[stem.name])


@pytest.mark.cuda
def test_tune_graph_and_validate_routes(cuda, tmp_path):
    """The sweep on a small ResNet: every entry's routes timed, each
    detail naming the card, each kept route plausible and past the margin;
    the whole-graph A/B returns its times and demotes what does not win."""
    from tf2_tpu_torch.kernels import autotune

    art = _small_resnet()
    autotune.set_table_path(str(tmp_path / "t.json"))
    autotune.reset_table()  # a fresh sweep, as bench/tune_sweep.py runs it
    try:
        res = autotune.tune_graph(art.graph, art.params, iters=3, reps=2)
        assert res and all("kernel_ms" in d and d["card"] for d in res.values())
        for key, d in res.items():
            if d["winner"] != "kernel":
                assert autotune.plausible(key, d[f"{d['winner']}_ms"])
                assert d[f"{d['winner']}_ms"] * d["margin"] < d["kernel_ms"]
        v = autotune.validate_routes(art.graph, art.params, iters=3, reps=2)
        assert set(v) >= {"routed_ms", "kernel_ms", "kept", "routed"}
        if not v["kept"]:
            assert all(r == "kernel" for r in autotune._load()["routes"].values())
    finally:
        autotune.set_table_path(None)


@pytest.mark.cuda
def test_entry_on_card(cuda):
    from tf2_tpu_torch.entry import entry

    fwd, (params, image) = entry(batch=2, image=64, depths=(1, 1, 1, 1), classes=64)
    assert image.device.type == "cuda"
    y = fwd(params, image)
    assert tuple(y.shape) == (2, 64) and bool(torch.isfinite(y).all())


@pytest.mark.cuda
def test_server_replays_from_its_thread_equal_the_capturing_threads(cuda):
    """``InferenceServer.start`` captures the forward on this thread; the
    batcher's thread replays it. Each served row equals the row of a replay
    from this thread, bit for bit, through client threads."""
    import threading

    from tf2_tpu_torch.models import synthetic_quantized
    from tf2_tpu_torch.runtime import Engine
    from tf2_tpu_torch.serve import InferenceServer

    art = synthetic_quantized("resnet50", seed=0, batch=2, image=64, depths=(1, 1, 1, 1),
                              classes=64)
    eng = Engine(art.graph, art.params)
    x = np.random.default_rng(3).standard_normal((6, 64, 64, 3)).astype(np.float32)
    srv = InferenceServer(eng, 2).start()
    assert eng.built and srv.stats()["captured"] is True
    want = np.concatenate([eng.run(image=x[i:i + 2]).cpu().numpy() for i in range(0, 6, 2)])
    got = {}

    def client(i):
        got[i] = srv.predict(x[i], timeout=60)

    try:
        threads = [threading.Thread(target=client, args=(i,)) for i in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        srv.stop()
    for i in range(6):
        np.testing.assert_array_equal(got[i], want[i])


@pytest.mark.cuda
@pytest.mark.parametrize("flags", [{"block_fusion": False}, {}])
def test_compare_backends_is_empty_on_card(cuda, flags):
    """Every int8 node of a small ResNet's Engine on its kernels equals its
    plain version on the card: ``compare_backends`` at atol 0 finds none."""
    from tf2_tpu_torch.runtime import Engine
    from tf2_tpu_torch.utils.debug import compare_backends

    art = _small_resnet()
    eng = Engine(art.graph, art.params, **flags)
    x = _images(cuda, 1, seed=4)[0]
    assert compare_backends(eng.graph, eng.params, atol_quanta=0, image=x) == []


@pytest.mark.cuda
def test_plain_mode_launches_no_kernel_on_card(cuda):
    """Inside ``plain_mode`` an Engine on the card launches no kernel and
    gives the kernels' logits; after it, the same Engine launches them
    again."""
    from tf2_tpu_torch.runtime import Engine
    from tf2_tpu_torch.utils.debug import plain_mode

    art = _small_resnet()
    x = _images(cuda, 1, seed=5)[0]
    want = Engine(art.graph, art.params).run(image=x)
    with plain_mode():
        eng = Engine(art.graph, art.params)
        kernels.reset_launch_counts()
        got = eng.run(image=x)
        assert set(kernels.launch_counts().values()) == {0}
    assert torch.equal(got, want)
    eng.run(image=x)
    assert sum(kernels.launch_counts().values()) > 0
