"""Derived seeds: one stream of random numbers for each use of ``--seed``."""
from __future__ import annotations

import hashlib


def derive(seed: int, use: str) -> int:
    """A 63-bit seed for ``use`` (weights, images, sample) from the run's
    seed, any whole number."""
    h = hashlib.sha256(f"{seed}:{use}".encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1
