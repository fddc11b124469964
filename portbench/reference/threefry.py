"""A frozen copy of the counter-based draw that ``rank:ndcg`` samples its
pairs from: ``jax.random``'s partitionable threefry2x32 stream, in plain
integer tensor arithmetic.

The ranking objective of the system under test draws each row's opponent
from this stream, so the reference has to draw the same opponents to
compute the same gradient. This file is a copy of the arithmetic (the
threefry2x32 block function of Salmon et al., "Parallel random numbers:
as easy as 1, 2, 3", SC 2011, with JAX's key and counter layout), kept
here so that the benchmark's yardstick does not move when the program
does. Every uint32 value is held in int64 and masked after each add and
shift.
"""

from __future__ import annotations

import torch

_M = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x, r: int):
    return ((x << r) & _M) | (x >> (32 - r))


def threefry_2x32(k1, k2, x1, x2):
    """20 rounds of threefry2x32 on the counter pair ``(x1, x2)`` under the
    key ``(k1, k2)``; ints or int64 tensors of uint32 values."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x0 = (x1 + ks[0]) & _M
    x1 = (x2 + ks[1]) & _M
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _M
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M
    return x0, x1


def key_words(seed: int):
    """``PRNGKey(seed)``'s two words."""
    seed = int(seed)
    return (seed >> 32) & _M, seed & _M


def uniform(seed: int, n: int, m: int, device) -> torch.Tensor:
    """``[n, m]`` float32 uniforms in [0, 1) under ``PRNGKey(seed)``: the
    hash of each element's row-major index, the two output words xored,
    its top 23 bits as the mantissa of a float in [1, 2), minus 1."""
    k1, k2 = key_words(seed)
    idx = torch.arange(n * m, dtype=torch.int64, device=device).reshape(n, m)
    b1, b2 = threefry_2x32(k1, k2, idx >> 32, idx & _M)
    bits = b1 ^ b2
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return torch.clamp(f - 1.0, min=0.0)
