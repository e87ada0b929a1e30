"""TF padding arithmetic (SAME puts the odd pixel after)."""
from __future__ import annotations


def pad_amount(size: int, k: int, stride: int) -> tuple[int, int]:
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def resolve_pads(padding, kh: int, kw: int, sh: int, sw: int, h: int, w: int):
    """-> ((top, bottom), (left, right)) for SAME, VALID or explicit pads."""
    if isinstance(padding, str):
        if padding.upper() == "VALID":
            return (0, 0), (0, 0)
        return pad_amount(h, kh, sh), pad_amount(w, kw, sw)
    (ph0, ph1), (pw0, pw1) = padding
    return (ph0, ph1), (pw0, pw1)


def out_size(size: int, k: int, s: int, p0: int, p1: int) -> int:
    return (size + p0 + p1 - k) // s + 1
