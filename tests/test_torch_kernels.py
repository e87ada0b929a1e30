"""The port's four kernels against tf2_tpu's on the CPU.

On the CPU each wrapper takes its plain version; those are held against
the reference's own non-Pallas versions of its kernels, the functions
tests/kernels/test_shift_matmul.py and tests/kernels/test_qconv.py hold
its Pallas kernels against (an int32 ``jnp.dot`` or ``lax`` conv and the
f32 epilogue), on those files' shape matrices, with zero tolerance. No
test enters Pallas interpret mode, which can deadlock. The CUDA kernels
themselves are held against the plain versions on the card in
tests/test_torch_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from tf2_tpu.transform import potq as ref_potq
from tf2_tpu_torch import kernels
from tf2_tpu_torch.kernels import qconv, shift_matmul


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in parallel workers beside multi-process JAX tests;
    one intra-op thread keeps these float64 checks from starving them."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _ref_qmm(x_q, w_q, es, eb, relu):
    """tests/kernels/test_shift_matmul.py's reference: int32 dot + epilogue."""
    acc = jnp.dot(jnp.asarray(x_q, jnp.int32), jnp.asarray(w_q, jnp.int32),
                  preferred_element_type=jnp.int32)
    y = acc.astype(jnp.float32) * jnp.asarray(es)[None, :] + jnp.asarray(eb)[None, :]
    if relu:
        y = jnp.maximum(y, 0.0)
    return np.asarray(jnp.clip(jnp.round(y), -127, 127).astype(jnp.int8))


def _ref_qconv(x_q, w_q, es, eb, relu, strides, padding):
    """tests/kernels/test_qconv.py's reference: int32 lax conv + epilogue."""
    acc = lax.conv_general_dilated(
        jnp.asarray(x_q, jnp.int32), jnp.asarray(w_q, jnp.int32), strides, padding,
        dimension_numbers=("NHWC", "HWIO", "NHWC"), preferred_element_type=jnp.int32)
    y = acc.astype(jnp.float32) * jnp.asarray(es) + jnp.asarray(eb)
    if relu:
        y = jnp.maximum(y, 0.0)
    return np.asarray(jnp.clip(jnp.round(y), -127, 127).astype(jnp.int8))


def _gemm_case(m, k, n, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randint(-127, 128, (m, k)).astype(np.int8)
    q, _ = ref_potq.fit_pot(rng.randn(k, n).astype(np.float32) * 0.05)
    packed = ref_potq.pack_codes(ref_potq.pot_encode_from_int8(q))
    es = rng.uniform(1e-4, 1e-3, n).astype(np.float32)
    eb = rng.randn(n).astype(np.float32)
    return x, q, packed, es, eb


def _t(*arrays):
    return [torch.as_tensor(a) for a in arrays]


@pytest.mark.parametrize("m,k,n", [(32, 128, 128), (256, 512, 256),
                                   (8, 2048, 1000), (100, 576, 64)])
@pytest.mark.parametrize("relu", [False, True])
def test_qmatmul_pot4_plain_matches_reference(m, k, n, relu):
    x, q, packed, es, eb = _gemm_case(m, k, n)
    want = _ref_qmm(x, q, es, eb, relu)
    got = shift_matmul.qmatmul_pot4(*_t(x, packed, es, eb), relu=relu)
    assert got.dtype == torch.int8 and tuple(got.shape) == (m, n)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_qmatmul_int8_plain_matches_reference():
    rng = np.random.RandomState(1)
    m, k, n = 64, 384, 192
    x = rng.randint(-127, 128, (m, k)).astype(np.int8)
    w = rng.randint(-127, 128, (k, n)).astype(np.int8)
    es = rng.uniform(1e-4, 1e-3, n).astype(np.float32)
    eb = rng.randn(n).astype(np.float32)
    want = _ref_qmm(x, w, es, eb, True)
    got = shift_matmul.qmatmul_int8(*_t(x, w, es, eb), relu=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_accumulator_extremes():
    """|acc| = 127 * 64 * K must neither wrap nor saturate."""
    m, k, n = 32, 2048, 128
    x = np.full((m, k), 127, np.int8)
    q = np.full((k, n), 64, np.int8)
    packed = ref_potq.pack_codes(ref_potq.pot_encode_from_int8(q))
    es = np.full((n,), 1e-7, np.float32)
    eb = np.zeros((n,), np.float32)
    want = _ref_qmm(x, q, es, eb, False)
    got = shift_matmul.qmatmul_pot4(*_t(x, packed, es, eb))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(got[0, 0]) == round(127 * 64 * k * 1e-7)


def _conv_case(b, h, w, cin, cout, kh, wfmt, seed=0):
    """-> (x, the kernel's weight param, its int8 HWIO values, es, eb)."""
    rng = np.random.RandomState(seed)
    x = rng.randint(-127, 128, (b, h, w, cin)).astype(np.int8)
    if wfmt == "pot4":
        q, _ = ref_potq.fit_pot(rng.randn(kh * kh * cin, cout).astype(np.float32) * 0.05,
                                n_candidates=3)
        wparam = ref_potq.pack_codes(ref_potq.pot_encode_from_int8(q))
        whwio = q.reshape(kh, kh, cin, cout)
    else:
        wparam = whwio = rng.randint(-30, 31, (kh, kh, cin, cout)).astype(np.int8)
    es = rng.uniform(1e-4, 1e-3, cout).astype(np.float32)
    eb = rng.randn(cout).astype(np.float32)
    return x, wparam, whwio, es, eb


@pytest.mark.parametrize("b,h,w,cin,cout,kh,stride,padding,wfmt", [
    (2, 14, 14, 64, 96, 1, 1, "SAME", "pot4"),    # 1x1 GEMM
    (2, 14, 14, 64, 96, 1, 2, "SAME", "pot4"),    # 1x1 downsample shortcut
    (2, 15, 15, 32, 64, 3, 1, "SAME", "pot4"),    # 3x3 odd extent
    (2, 14, 14, 32, 64, 3, 2, "SAME", "pot4"),    # 3x3 stride-2 transition
    (1, 28, 28, 3, 64, 7, 2, "SAME", "int8"),     # the ResNet stem
    (2, 16, 16, 12, 64, 4, 1, "VALID", "int8"),   # even kernel, VALID
    (2, 9, 9, 130, 40, 3, 1, "SAME", "pot4"),     # ragged cin/cout
    (2, 13, 13, 24, 32, 3, 2, "VALID", "int8"),   # strided VALID
    (2, 12, 12, 144, 48, 3, 1, "SAME", "pot4"),   # cin > 128
])
@pytest.mark.parametrize("relu", [False, True])
def test_qconv_plain_matches_reference(b, h, w, cin, cout, kh, stride, padding,
                                       wfmt, relu):
    x, wparam, whwio, es, eb = _conv_case(b, h, w, cin, cout, kh, wfmt)
    kw = dict(strides=(stride, stride), padding=padding, groups=1, relu=relu,
              wfmt=wfmt, kshape=(kh, kh, cin, cout))
    want = _ref_qconv(x, whwio, es, eb, relu, (stride, stride), padding)
    got = qconv.fused_qconv2d(*_t(x, wparam, es, eb), **kw)
    assert got.is_contiguous()  # a kernel downstream takes only contiguous input
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_explicit_padding():
    x, wparam, whwio, es, eb = _conv_case(2, 14, 14, 64, 64, 5, "pot4")
    kw = dict(strides=(1, 1), padding=[(2, 2), (2, 2)], groups=1, relu=True,
              wfmt="pot4", kshape=(5, 5, 64, 64))
    want = _ref_qconv(x, whwio, es, eb, True, (1, 1), [(2, 2), (2, 2)])
    got = qconv.fused_qconv2d(*_t(x, wparam, es, eb), **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_uncovered_convs_raise():
    """A conv the kernels do not take raises off the CPU (here on ``meta``
    tensors, before any launch; tests/test_torch_cuda.py on the card) and
    runs its plain version on a CPU tensor (tests/test_torch_coverage.py
    holds it against the reference)."""
    x, wparam, _, es, eb = _conv_case(1, 8, 8, 16, 32, 3, "pot4")
    assert qconv.covers((3, 3, 64, 64), (2, 2), 1)
    assert not qconv.covers((3, 3, 8, 32), (1, 1), 2)
    assert not qconv.covers((3, 3, 64, 64), (4, 4), 1)
    assert not qconv.covers((3, 3, 64, 64), (1, 2), 1)
    kw = dict(strides=(1, 1), padding="SAME", groups=2, relu=True, wfmt="pot4",
              kshape=(3, 3, 8, 32))
    with pytest.raises(NotImplementedError):
        qconv.fused_qconv2d(*(t.to("meta") for t in _t(x, wparam, es, eb)), **kw)
    assert qconv.fused_qconv2d(*_t(x, wparam, es, eb), **kw).shape == (1, 8, 8, 32)


def test_cpu_wrappers_count_no_launches():
    kernels.reset_launch_counts()
    x, _, packed, es, eb = _gemm_case(16, 64, 32)
    shift_matmul.qmatmul_pot4(*_t(x, packed, es, eb))
    xc, wparam, _, esc, ebc = _conv_case(1, 8, 8, 32, 16, 3, "pot4")
    qconv.qconv_s2(*_t(xc, wparam, esc, ebc), kshape=(3, 3, 32, 16),
                   pads=((0, 1), (0, 1)), relu=False, wfmt="pot4")
    assert kernels.launch_counts() == dict.fromkeys(kernels.launch_counts(), 0)
