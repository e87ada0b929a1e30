"""The work of a conv kernel call, for its bound (``chip_smoke.py`` and
``bench/qconv_ab.py`` count it the same way): each input element the conv
reads, read once (a strided 1x1 conv reads one pixel in four), the
weights, es and eb read once, the output written once; 2 operations per
multiply-accumulate, counting only the taps inside the image (not those on
the zero padding)."""
from __future__ import annotations

import numpy as np

H100_BYTES_PER_S = 3.35e12     # HBM3, NVIDIA data sheet (SXM)
H100_INT8_OPS_PER_S = 1979e12  # dense int8 tensor-core peak, same source


def taps(size: int, k: int, s: int, p0: int, out: int) -> tuple[int, int]:
    """Along one axis of a conv: (input positions read, taps that fall
    inside the input summed over the outputs)."""
    idx = np.arange(out)[:, None] * s - p0 + np.arange(k)[None, :]
    inside = (idx >= 0) & (idx < size)
    return len(np.unique(idx[inside])), int(inside.sum())


def conv_work(x_shape, kshape, strides, pads, wfmt: str, y_shape) -> tuple[int, float]:
    """(bytes, operations) of one conv: x (B, H, W, C), kshape (kh, kw, cin,
    cout), strides (sh, sw), pads ((top, bottom), (left, right)), y (B, OH,
    OW, cout)."""
    kh, kw, cin, cout = kshape
    b, h, w, _ = x_shape
    (ph0, _), (pw0, _) = pads
    rows, taps_y = taps(h, kh, strides[0], ph0, y_shape[1])
    cols, taps_x = taps(w, kw, strides[1], pw0, y_shape[2])
    k = kh * kw * cin
    w_bytes = k * cout // 2 if wfmt == "pot4" else k * cout
    y_bytes = int(np.prod(y_shape))
    return (b * rows * cols * cin + w_bytes + 8 * cout + y_bytes,
            2.0 * b * taps_y * taps_x * cin * cout)


def bound_ms(nbytes: float, ops: float) -> tuple[float, float]:
    """(bytes over the memory rate, operations over the int8 peak) in ms."""
    return nbytes / H100_BYTES_PER_S * 1e3, ops / H100_INT8_OPS_PER_S * 1e3
