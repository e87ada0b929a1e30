"""Power-of-two ("shift") weight quantization.

Each weight is approximated as ``w ~ s_c * q`` with a per-output-channel
fp32 scale ``s_c`` and ``q in {0, +-1, +-2, ..., +-64}``: sign times a power
of two, which fits int8, so the kernels feed it to int8 tensor-core MMA.

4-bit code layout (bit 3 = sign, bits 2:0 = magnitude field m):
    m == 0      -> 0 (canonical zero has sign 0)
    m in 1..7   -> magnitude 2^(m-1)
so ``decode(c) = (-1)^s * (m ? 1 << (m-1) : 0)``.

Codes pack two per byte along K in split-half layout:
``byte[i] = code[i] | code[i + Kp/2] << 4`` with Kp = K rounded up to even.

The fitters are offline numpy code; ``pot_decode`` and ``unpack_codes`` act
on torch tensors for the plain kernel versions.
"""
from __future__ import annotations

import numpy as np
import torch

POT_MAGS = np.array([0, 1, 2, 4, 8, 16, 32, 64], dtype=np.float32)
_POT_MIDPOINTS = (POT_MAGS[1:] + POT_MAGS[:-1]) / 2.0  # [0.5,1.5,3,6,12,24,48]
POT_MAX = 64.0


def pot_decode(codes: torch.Tensor) -> torch.Tensor:
    """uint8 4-bit codes (values 0..15) -> int8 PoT values."""
    c = codes.to(torch.int32)
    m = c & 7
    mag = torch.where(m == 0, 0, torch.bitwise_left_shift(
        torch.ones_like(c), torch.clamp_min(m - 1, 0)))
    return torch.where(((c >> 3) & 1) == 1, -mag, mag).to(torch.int8)


def pot_decode_np(codes: np.ndarray) -> np.ndarray:
    """numpy mirror of pot_decode (host-side weight prep)."""
    c = codes.astype(np.int32)
    m = c & 7
    s = (c >> 3) & 1
    mag = np.where(m == 0, 0, np.left_shift(1, np.maximum(m - 1, 0)))
    return np.where(s == 1, -mag, mag).astype(np.int8)


def pot_encode_from_int8(q) -> np.ndarray:
    """int8 PoT values -> uint8 4-bit codes."""
    q = np.asarray(q)
    a = np.abs(q.astype(np.int32))
    m = np.where(a == 0, 0, np.round(np.log2(np.maximum(a, 1))).astype(np.int32) + 1)
    s = np.where(m == 0, 0, (q < 0).astype(np.int32))  # canonical zero
    return (m | (s << 3)).astype(np.uint8)


def pot_quantize_with_scale(w: np.ndarray, scale: np.ndarray) -> np.ndarray:
    """Quantize ``w`` (K, C) with per-channel ``scale`` (C,) -> int8 PoT,
    each magnitude rounded to the MSE-nearest power of two."""
    idx = np.searchsorted(_POT_MIDPOINTS, np.abs(w) / scale).astype(np.int32)
    return (np.sign(w) * POT_MAGS[idx]).astype(np.int8)


def fit_pot(w, n_candidates: int = 33, span: float = 1.0
            ) -> tuple[np.ndarray, np.ndarray]:
    """Per-channel PoT fit for ``w`` (K, C), output channel last. Returns
    (q int8 (K, C), scale (C,)). Scale candidates are
    ``absmax/POT_MAX * 2^t`` for t in [-span, span]; the per-channel MSE
    argmin wins."""
    w = np.asarray(w, np.float32)
    base = np.maximum(np.max(np.abs(w), axis=0), 1e-12) / POT_MAX
    ts = (np.linspace(-span, span, n_candidates) if n_candidates > 1
          else np.zeros((1,)))
    best_mse = np.full(w.shape[1], np.inf, np.float32)
    best_scale = base.copy()
    for t in ts:
        scale = (base * (2.0 ** t)).astype(np.float32)
        q = pot_quantize_with_scale(w, scale)
        mse = np.mean(np.square(w - scale[None, :] * q.astype(np.float32)), axis=0)
        better = mse < best_mse
        best_mse = np.where(better, mse, best_mse)
        best_scale = np.where(better, scale, best_scale)
    return pot_quantize_with_scale(w, best_scale), best_scale.astype(np.float32)


def fit_int8(w, n_candidates: int = 17, span: float = 0.3
             ) -> tuple[np.ndarray, np.ndarray]:
    """Per-channel symmetric linear int8 fit for (K, C) weights (first and
    last layers). Returns (q int8, scale)."""
    w = np.asarray(w, np.float32)
    base = np.maximum(np.max(np.abs(w), axis=0), 1e-12) / 127.0
    ts = (np.linspace(-span, 0.0, n_candidates) if n_candidates > 1
          else np.zeros((1,)))
    best_mse = np.full(w.shape[1], np.inf, np.float32)
    best_scale = base.copy()
    for t in ts:
        scale = (base * (2.0 ** t)).astype(np.float32)
        q = np.clip(np.round(w / scale[None, :]), -127, 127)
        mse = np.mean(np.square(w - scale[None, :] * q), axis=0)
        better = mse < best_mse
        best_mse = np.where(better, mse, best_mse)
        best_scale = np.where(better, scale, best_scale)
    q = np.clip(np.round(w / best_scale[None, :]), -127, 127).astype(np.int8)
    return q, best_scale.astype(np.float32)


def pack_codes(codes) -> np.ndarray:
    """(K, C) uint8 4-bit codes -> (ceil(K/2), C) packed uint8, split-half."""
    codes = np.asarray(codes)
    if codes.shape[0] % 2:
        codes = np.concatenate([codes, np.zeros((1,) + codes.shape[1:], np.uint8)], 0)
    half = codes.shape[0] // 2
    lo = codes[:half].astype(np.uint8)
    hi = codes[half:].astype(np.uint8)
    return (lo | (hi << 4)).astype(np.uint8)


def unpack_codes(packed: torch.Tensor, k: int) -> torch.Tensor:
    """(ceil(K/2), C) split-half packed -> (K, C) uint8 codes."""
    return torch.cat([packed & 0xF, (packed >> 4) & 0xF], dim=0)[:k]


def unpack_codes_np(packed: np.ndarray, k: int) -> np.ndarray:
    """numpy mirror of unpack_codes (host-side weight prep)."""
    return np.concatenate([packed & 0xF, (packed >> 4) & 0xF], axis=0)[:k].astype(np.uint8)
