"""The weight fits that make a configuration's artifact from its float
weights, in torch on the device: per output channel, 4-bit power-of-two
codes (sign and magnitude 0 or 2^0..2^6, two codes a byte in split-half
order) or linear int8, the scale chosen by mean squared error among a few
candidates around absmax / 64 (PoT) or absmax / 127 (int8)."""
from __future__ import annotations

import torch

_POT_MIDS = (0.5, 1.5, 3.0, 6.0, 12.0, 24.0, 48.0)
_POT_MAGS = (0.0, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0)


def _pot_values(w: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    mids = torch.tensor(_POT_MIDS, device=w.device)
    mags = torch.tensor(_POT_MAGS, device=w.device)
    idx = torch.searchsorted(mids, (w.abs() / scale).contiguous())
    return torch.sign(w) * mags[idx]


def _best_scale(w, base, ts, values) -> torch.Tensor:
    best_mse = torch.full_like(base, float("inf"))
    best = base.clone()
    for t in ts:
        scale = (base.double() * 2.0 ** t).float()
        mse = torch.mean(torch.square(w - scale * values(w, scale)), dim=0)
        better = mse < best_mse
        best_mse = torch.where(better, mse, best_mse)
        best = torch.where(better, scale, best)
    return best


def _candidates(lo: float, hi: float, n: int) -> list[float]:
    return [lo + (hi - lo) * i / (n - 1) for i in range(n)] if n > 1 else [0.0]


def fit_pot(w: torch.Tensor, n_candidates: int) -> tuple[torch.Tensor, torch.Tensor]:
    """w (K, C) f32 -> (int8 PoT values (K, C), scale (C,))."""
    base = torch.clamp_min(w.abs().amax(dim=0), 1e-12) / 64.0
    scale = _best_scale(w, base, _candidates(-1.0, 1.0, n_candidates), _pot_values)
    return _pot_values(w, scale).to(torch.int8), scale


def _int8_values(w, scale):
    return torch.clamp(torch.round(w / scale), -127, 127)


def fit_int8(w: torch.Tensor, n_candidates: int) -> tuple[torch.Tensor, torch.Tensor]:
    """w (K, C) f32 -> (int8 (K, C), scale (C,))."""
    base = torch.clamp_min(w.abs().amax(dim=0), 1e-12) / 127.0
    scale = _best_scale(w, base, _candidates(-0.3, 0.0, n_candidates), _int8_values)
    return _int8_values(w, scale).to(torch.int8), scale


def pack_pot4(q: torch.Tensor) -> torch.Tensor:
    """int8 PoT values (K, C) -> (ceil(K/2), C) uint8: code = m | sign << 3
    with m = 0 for 0, else log2|q| + 1; byte i = code[i] | code[i + Kp/2] << 4."""
    a = q.to(torch.int32).abs()
    m = torch.where(a == 0, 0, torch.round(torch.log2(a.clamp_min(1).float())).to(torch.int32) + 1)
    s = torch.where(m == 0, 0, (q < 0).to(torch.int32))
    codes = (m | (s << 3)).to(torch.uint8)
    if codes.shape[0] % 2:
        codes = torch.cat([codes, torch.zeros_like(codes[:1])], 0)
    half = codes.shape[0] // 2
    return codes[:half] | (codes[half:] << 4)
