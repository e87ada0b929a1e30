"""The redesigned LRN kernel's arithmetic (``tf2_tpu_torch/kernels/csrc/
qlrn.cu``), modelled in numpy on the CPU:

- the sliding window (each run of 16 channels sums its first window, then
  adds the entering square and subtracts the leaving one) equals the plain
  version's double window sum bit for bit, and so does its rounding to f32,
  on random, +-127 and alternating codes, C = 1 to 832, r = 0 to 5;
- the certified epilogue's decision (``fast_075``: the fast value, its
  bound, the half-integer test), given any fast value within the kernel's
  stated error (2^-20) of the true one, gives ``qlrn_plain``'s int8
  wherever it certifies, on all 255 codes x a dense sweep of t around every
  rounding boundary, at the synthetic scales and three others;
- the plain version's square root (``build.sqrt_rn``) is correctly
  rounded;
- a clipped fast value is certified and gives the plain version's +-127,
  and t outside [2^-40, 2^40] is never certified;
- the kernel's model as a whole (sliding window, certified epilogue, exact
  steps elsewhere) equals ``qlrn_plain`` with tolerance 0, and the
  reference's ``reference_qlrn`` (``tf2_tpu/kernels/qlrn.py``) within the
  bar tests/test_torch_qlrn.py states (max |diff| 1, more than 99.9%
  exact).

The kernel itself is held against ``qlrn_plain`` on the card in
tests/test_torch_cuda.py and chip_smoke.py.
"""
import ctypes
import ctypes.util
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tf2_tpu.kernels.qlrn import reference_qlrn
from tf2_tpu_torch.kernels import build, qlrn

F32 = np.float32
MAGIC = F32(12582912.0)  # 1.5 * 2^23
# (s_in, s_out, alpha): the synthetic scales, then chip_smoke.py's QLRN_SCALES
SCALES = [(0.02, 0.02, 1e-4), (0.0312, 0.0279, 2e-4), (0.5, 0.37, 1e-4), (0.2, 0.05, 1e-3)]
FAST_ERR = 2.0 ** -20  # the fast value's bound against the true one (qlrn.cu)


def _codes(kind: str, m: int, c: int, rng) -> np.ndarray:
    if kind == "random":
        return rng.integers(-128, 128, (m, c)).astype(np.int8)
    if kind == "pm127":
        return rng.choice(np.array([-127, 127], np.int8), (m, c))
    # alternating largest and smallest squares: the widest span a window holds
    alt = np.where(np.arange(c) % 2 == 0, 127, 1).astype(np.int8)
    return np.tile(alt, (m, 1)) * rng.choice(np.array([-1, 1], np.int8), (m, 1))


def _squares(codes: np.ndarray, s_in: float) -> np.ndarray:
    """sq = f32(f32(q) * s_in)^2 in f32, as a double."""
    xf = codes.astype(F32) * F32(s_in)
    return (xf * xf).astype(np.float64)


def _window_plain(sq: np.ndarray, r: int) -> torch.Tensor:
    """qlrn.lrn_f32's window: the padded squares summed in float64, in its
    order."""
    c = sq.shape[-1]
    p = F.pad(torch.as_tensor(sq), (r, r))
    win = p[..., 0:c]
    for j in range(1, 2 * r + 1):
        win = win + p[..., j:j + c]
    return win


def _window_sliding(sq: np.ndarray, r: int) -> np.ndarray:
    """The kernels' window: each run of 16 channels sums its first window
    (the channels within [0, C)) and slides it, + the entering square, -
    the leaving one."""
    m, c = sq.shape
    out = np.empty_like(sq)
    for c0 in range(0, c, 16):
        acc = np.zeros(m)
        for j in range(max(c0 - r, 0), min(c0 + r, c - 1) + 1):
            acc = acc + sq[:, j]
        for ch in range(c0, min(c0 + 16, c)):
            out[:, ch] = acc
            if ch + r + 1 < c:
                acc = acc + sq[:, ch + r + 1]
            if ch - r >= 0:
                acc = acc - sq[:, ch - r]
    return out


@pytest.mark.parametrize("c", [1, 3, 13, 16, 64, 192, 832])
@pytest.mark.parametrize("r", [0, 1, 2, 3, 4, 5])
def test_sliding_window_equals_the_double_window(c, r):
    rng = np.random.default_rng(c * 7 + r)
    for kind in ("random", "pm127", "alternating"):
        codes = _codes(kind, 16, c, rng)
        for s_in in (0.02, 0.0312, 0.5, 1e-3, 7.3):
            sq = _squares(codes, s_in)
            want = _window_plain(sq, r).numpy()
            got = _window_sliding(sq, r)
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(got.astype(F32), want.astype(F32))


def _plain_out(xf: np.ndarray, t: np.ndarray, s_out: float) -> np.ndarray:
    """qlrn_plain's steps at beta 0.75 from f32 xf and t: rs = 1 / sqrt(t),
    (xf * rs) * sqrt(rs), / s_out, round half to even, clip, each square
    root correctly rounded (``build.sqrt_rn``)."""
    xf, t = torch.as_tensor(xf), torch.as_tensor(t)
    rs = torch.tensor(1.0, dtype=torch.float32) / build.sqrt_rn(t)
    v = (xf * rs) * build.sqrt_rn(rs)
    y = torch.round(v / torch.tensor(F32(s_out)))
    return torch.clamp(y, -127, 127).to(torch.int8).numpy()


@pytest.mark.parametrize("lo,hi", [(2.0 ** -40, 1.0), (1.0, 1.0 + 1 / 16), (1.0, 4096.0),
                                   (1.0, 2.0 ** 40)])
def test_sqrt_rn_is_correctly_rounded(lo, hi):
    """build.sqrt_rn, the plain version's square root, is the correctly
    rounded f32 square root (numpy's float64 root rounded once) at every
    value, at every address of the tensor: the bits the kernels'
    __fsqrt_rn gives."""
    rng = np.random.default_rng(int(hi))
    a = np.exp(rng.uniform(np.log(lo), np.log(hi), 100003)).astype(F32)
    want = np.sqrt(a.astype(np.float64)).astype(F32)
    buf = torch.zeros(a.size + 8)
    for off in (0, 1, 3):
        t = buf[off:off + a.size]
        t.copy_(torch.as_tensor(a))
        np.testing.assert_array_equal(build.sqrt_rn(t).numpy(), want)


def _sqrt_cases() -> tuple[torch.Tensor, np.ndarray]:
    """f32 values over [2^-40, 2^40] and numpy's correctly rounded roots."""
    rng = np.random.default_rng(40)
    a = np.exp(rng.uniform(np.log(2.0 ** -40), np.log(2.0 ** 40), 300007)).astype(F32)
    a[:3] = (0.0, 1.0, 4.0)
    return torch.as_tensor(a), np.sqrt(a.astype(np.float64)).astype(F32)


@pytest.mark.parametrize("threads", [1, 2, 8])
def test_sqrt_rn_is_correctly_rounded_on_every_thread_count(threads):
    """build.sqrt_rn at 1, 2 and 8 intra-op threads (the pool's threads
    take the work of a tensor this long) gives the correctly rounded root."""
    t, want = _sqrt_cases()
    prev = torch.get_num_threads()
    torch.set_num_threads(threads)
    try:
        np.testing.assert_array_equal(build.sqrt_rn(t).numpy(), want)
    finally:
        torch.set_num_threads(prev)


@pytest.mark.parametrize("mode", [0x400, 0x800, 0xC00], ids=["down", "up", "toward_zero"])
def test_sqrt_rn_is_correctly_rounded_in_every_rounding_mode(mode):
    """With the thread's FP rounding mode set to a directed one (fesetround,
    x86-64 values), a root taken in float64 and cast to f32 is off by one
    ulp in about half the elements; build.sqrt_rn's exact check keeps every
    root correctly rounded. One intra-op thread, so torch computes on the
    thread whose mode is set; the mode is restored after."""
    libm = ctypes.CDLL(ctypes.util.find_library("m"))
    t, want = _sqrt_cases()
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    libm.fesetround(mode)
    try:
        naive = torch.sqrt(t.to(torch.float64)).to(torch.float32).numpy()
        got = build.sqrt_rn(t).numpy()
    finally:
        libm.fesetround(0)
        torch.set_num_threads(prev)
    assert (naive != want).mean() > 0.3
    np.testing.assert_array_equal(got, want)


def _fast_075(z: np.ndarray, t: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """qlrn.cu: fast_075's decision on fast values z (f32): zc = z clipped
    to +-127, zb = zc + 1.5 * 2^23 (its low byte the output), off = zc -
    (zb - 1.5 * 2^23), certified where t is in [2^-40, 2^40] and
    fma(cert, |zc|, |off| - 0.5) < 0, the FMA rounded once to f32."""
    zc = np.clip(z.astype(F32), F32(-127), F32(127))
    zb = (zc + MAGIC).astype(F32)
    off = (zc - (zb - MAGIC)).astype(F32)
    e = (qlrn.CERT_REL * np.abs(zc).astype(np.float64)
         + (np.abs(off) - F32(0.5)).astype(F32).astype(np.float64)).astype(F32)
    ok = (t >= 2.0 ** -40) & (t <= 2.0 ** 40) & (e < 0)
    byte = (zb.view(np.uint32) & 0xFF).astype(np.uint8).view(np.int8)
    return byte, ok


def _t_around_boundaries(xz: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(code index, t): for each code's xz and each half-integer h = k +
    1/2 (k = 0 .. 126) of its sign, the t where xz * t^-0.75 = h, the 4
    f32 values on either side of it, and t * (1 +- 2^-18), (1 +- 2^-16)."""
    idx, ts = [], []
    h = np.arange(127) + 0.5
    for i, v in enumerate(xz):
        if v == 0:
            continue
        tstar = (abs(float(v)) / h) ** (4.0 / 3.0)
        tstar = tstar[(tstar >= 2.0 ** -40) & (tstar <= 2.0 ** 40)].astype(F32)
        sweep = [tstar]
        for toward in (F32(np.inf), F32(0)):
            t2 = tstar
            for _ in range(4):
                t2 = np.nextafter(t2, toward)
                sweep.append(t2)
        for rel in (2.0 ** -18, 2.0 ** -16):
            sweep += [(tstar * (1 + rel)).astype(F32), (tstar * (1 - rel)).astype(F32)]
        tt = np.concatenate(sweep)
        idx.append(np.full(tt.size, i))
        ts.append(tt)
    return np.concatenate(idx), np.concatenate(ts)


@pytest.mark.parametrize("s_in,s_out,alpha", SCALES)
def test_certified_epilogue_gives_the_plain_int8(s_in, s_out, alpha):
    """Around every rounding boundary of every code, a fast value anywhere
    within the stated bound of the true z is either certified and rounds
    as qlrn_plain does, or left to the exact steps; away from the
    boundaries nearly every element is certified."""
    q = np.arange(-128, 128).astype(np.int8)
    xf = q.astype(F32) * F32(s_in)
    xz = (xf * (F32(1.0) / F32(s_out))).astype(F32)
    i, t = _t_around_boundaries(xz)
    # and a plain grid of t over [1, 5]
    grid = np.linspace(1.0, 5.0, 257).astype(F32)
    i = np.concatenate([i, np.repeat(np.arange(256), grid.size)])
    t = np.concatenate([t, np.tile(grid, 256)])
    want = _plain_out(xf[i], t, s_out)
    z_true = xz[i].astype(np.float64) * t.astype(np.float64) ** -0.75
    certified = 0
    for err in (-FAST_ERR, -FAST_ERR / 2, 0.0, FAST_ERR / 2, FAST_ERR):
        byte, ok = _fast_075((z_true * (1 + err)).astype(F32), t)
        np.testing.assert_array_equal(byte[ok], want[ok])
        certified += int(ok.sum())
    on_grid = np.arange(t.size) >= t.size - 256 * grid.size
    byte, ok = _fast_075(z_true.astype(F32), t)
    assert ok[on_grid].mean() > 0.99
    assert (~ok[~on_grid]).any()  # the boundaries take the exact steps
    assert certified > 0


@pytest.mark.parametrize("s_in,s_out,alpha", SCALES)
def test_certified_epilogue_clips_to_127(s_in, s_out, alpha):
    """Fast values past +-127 (t near 1, the largest codes against a small
    s_out) are clipped, certified and give qlrn_plain's +-127, within the
    stated bound of the true z either way."""
    q = np.array([-128, -127, -100, 100, 127], np.int8)
    xf = q.astype(F32) * F32(s_in)
    xz = (xf * (F32(1.0) / F32(s_out / 200))).astype(F32)
    t = np.repeat(np.linspace(1.0, 1.5, 64).astype(F32)[None], q.size, 0)
    z_true = xz[:, None].astype(np.float64) * t.astype(np.float64) ** -0.75
    want = _plain_out(np.repeat(xf[:, None], t.shape[1], 1), t, s_out / 200)
    assert (np.abs(want) == 127).all()
    for err in (-FAST_ERR, 0.0, FAST_ERR):
        byte, ok = _fast_075((z_true * (1 + err)).astype(F32), t)
        assert ok.all()
        np.testing.assert_array_equal(byte, want)


@pytest.mark.parametrize("t,certified", [(2.0 ** -41, False), (2.0 ** -40, True),
                                         (2.0 ** 40, True), (2.0 ** 41, False)])
def test_certified_epilogue_range_of_t(t, certified):
    """rsqrtf's bound is stated for t in [2^-40, 2^40]: outside it no
    element is certified (the exact steps take it), inside it elements away
    from a half-integer are, and give qlrn_plain's int8."""
    q = np.arange(-128, 128).astype(np.int8)
    tt = np.full(q.size, t, F32)
    xf = q.astype(F32) * F32(0.0312)
    s_out = float(F32(0.0312) * F32(t) ** -0.75 / 3.3)  # z = 3.3 q: off the boundaries
    xz = (xf * (F32(1.0) / F32(s_out))).astype(F32)
    z = (xz.astype(np.float64) * tt.astype(np.float64) ** -0.75).astype(F32)
    byte, ok = _fast_075(z, tt)
    if not certified:
        assert not ok.any()
    else:
        assert ok.mean() > 0.9
        np.testing.assert_array_equal(byte[ok], _plain_out(xf, tt, s_out)[ok])


def _kernel_model(codes: np.ndarray, r: int, s_in: float, s_out: float, alpha: float):
    """The fast kernel as a whole, in numpy: the sliding window, t, the
    certified epilogue on the true z (rounded to f32), the exact steps
    where it does not certify. Returns (int8 out, elements on the exact
    steps)."""
    m, c = codes.shape
    sq = _squares(codes, s_in)
    win = _window_sliding(sq, r).astype(F32)
    t = (win * F32(alpha)).astype(F32) + F32(1.0)
    xf = codes.astype(F32) * F32(s_in)
    xz = (xf * (F32(1.0) / F32(s_out))).astype(F32)
    z = (xz.astype(np.float64) * t.astype(np.float64) ** -0.75).astype(F32)
    byte, ok = _fast_075(z, t)
    exact = _plain_out(xf, t, s_out)
    return np.where(ok, byte, exact), int((~ok).sum())


@pytest.mark.parametrize("s_in,s_out,alpha", SCALES)
@pytest.mark.parametrize("shape,r", [((2, 8, 8, 64), 2), ((2, 14, 14, 192), 2),
                                     ((3, 5, 7, 96), 1)])
def test_kernel_model_equals_plain_and_reference(shape, r, s_in, s_out, alpha):
    rng = np.random.default_rng(shape[-1] + r)
    x = rng.integers(-127, 128, shape).astype(np.int8)
    kw = dict(radius=r, alpha=alpha, beta=0.75, bias=1.0, s_in=s_in, s_out=s_out)
    got, _ = _kernel_model(x.reshape(-1, shape[-1]), r, s_in, s_out, alpha)
    got = got.reshape(shape)
    np.testing.assert_array_equal(got, qlrn.qlrn_plain(torch.as_tensor(x), **kw).numpy())
    want = np.asarray(jax.jit(functools.partial(reference_qlrn, **kw))(jnp.asarray(x)))
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 1 and (diff == 0).mean() > 0.999
