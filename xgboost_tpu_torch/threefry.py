"""Counter-based random draws: ``jax.random``'s default threefry2x32 stream.

The JAX package draws every row and column sample with ``jax.random``
(threefry2x32, partitionable). This module computes the same bits with
plain integer tensor operations, so the port grows the JAX package's
sampled trees and the card and the CPU draw identical values. A key is a
``[2]`` int64 CPU tensor holding two uint32 words, threaded explicitly;
there is no global state.

Every uint32 value is held in int64 and masked with ``0xFFFFFFFF`` after
each add and shift, which makes the arithmetic exact on any device. A key
lives on the CPU: its derivations (``prng_key``, ``split``, ``fold_in``)
hash host integers and launch nothing. The draws (``random_bits`` and the
samplers above it) pass the key's words to the hash as host scalars and
build their counters on the ``device`` they are given, so an ``[n]`` draw
for the card is made on the card and nothing crosses the bus.

The stream is the partitionable one (``jax_threefry_partitionable``, the
default since JAX 0.5): element ``i`` of a draw hashes the 64-bit counter
``i`` (its high and low words), so a draw of ``[n]`` is the first ``n``
values of a draw of ``[m > n]`` and a ``[K, F]`` draw is the first ``K``
rows of a ``[Km, F]`` one.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

__all__ = ["prng_key", "threefry_2x32", "split", "fold_in", "fold_in_many",
           "random_bits", "uniform", "uniform_rows", "bernoulli",
           "permutation", "randint", "gumbel"]

_M = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_TINY_F32 = 1.1754943508222875e-38  # float32's smallest normal

Word = Union[int, torch.Tensor]  # a uint32 value: host int or int64 tensor
Shape = Union[int, Sequence[int]]


def _rotl(x: Word, r: int) -> Word:
    return ((x << r) & _M) | (x >> (32 - r))


def threefry_2x32(k1: Word, k2: Word, x1: Word, x2: Word
                  ) -> Tuple[Word, Word]:
    """The threefry2x32 block function (20 rounds, ``jax/_src/prng.py``
    ``_threefry2x32_lowering``) on the counter pairs ``(x1, x2)`` under the
    key ``(k1, k2)``. Each argument is a host int or an int64 tensor of
    uint32 values; tensors broadcast."""
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


def _words(key: torch.Tensor) -> Tuple[int, int]:
    k1, k2 = key.tolist()
    return int(k1), int(k2)


def _key(k1: int, k2: int) -> torch.Tensor:
    return torch.tensor([k1, k2], dtype=torch.int64)


def prng_key(seed: int) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``: ``[seed >> 32, seed & 0xFFFFFFFF]``,
    i.e. ``[0, seed]`` for a seed below 2^32."""
    seed = int(seed)
    return _key((seed >> 32) & _M, seed & _M)


def _shape(shape: Shape) -> Tuple[int, ...]:
    return (int(shape),) if isinstance(shape, int) else tuple(int(s)
                                                              for s in shape)


def _counters(shape: Tuple[int, ...], device) -> Tuple[torch.Tensor,
                                                        torch.Tensor]:
    """The high and low words of the row-major linear index of every
    element of ``shape`` (``iota_2x32_shape``)."""
    idx = torch.arange(math.prod(shape), dtype=torch.int64,
                       device=device).reshape(shape)
    return idx >> 32, idx & _M


def split(key: torch.Tensor, n: int = 2) -> torch.Tensor:
    """``jax.random.split(key, n)``: ``[n, 2]`` keys, key ``i`` the hash of
    counter ``i``."""
    k1, k2 = _words(key)
    return torch.tensor([threefry_2x32(k1, k2, 0, i) for i in range(n)],
                        dtype=torch.int64).reshape(n, 2)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in(key, data)``: the hash of the counter pair
    ``(0, data)`` (the raw key of the 32-bit ``data``)."""
    return _key(*threefry_2x32(*_words(key), 0, int(data) & _M))


def fold_in_many(keys: torch.Tensor, data: Union[int, torch.Tensor]
                 ) -> torch.Tensor:
    """``fold_in`` of many keys or many data, as ``jax.vmap(fold_in)``:
    ``keys`` is one ``[2]`` CPU key or ``[..., 2]`` keys on a device, ``data``
    an int or an integer tensor; the result is ``[..., 2]`` int64 keys on
    the tensors' device (keys derived on the device from data that lives
    there, so nothing crosses the bus)."""
    if keys.dim() == 1:
        k1, k2 = _words(keys)
    else:
        k1, k2 = keys[..., 0], keys[..., 1]
    d = data.long() & _M if torch.is_tensor(data) else int(data) & _M
    return torch.stack(torch.broadcast_tensors(*threefry_2x32(k1, k2, 0, d)),
                       dim=-1)


def random_bits(key: torch.Tensor, shape: Shape,
                device: Optional[Union[str, torch.device]] = None
                ) -> torch.Tensor:
    """32 random bits per element (``_threefry_random_bits_partitionable``):
    ``bits1 ^ bits2`` of the hash of each element's linear index, as int64
    values in ``[0, 2^32)`` on ``device`` (default: the CPU)."""
    k1, k2 = _words(key)
    hi, lo = _counters(_shape(shape), device or "cpu")
    b1, b2 = threefry_2x32(k1, k2, hi, lo)
    return b1 ^ b2


def uniform(key: torch.Tensor, shape: Shape, minval: float = 0.0,
            maxval: float = 1.0,
            device: Optional[Union[str, torch.device]] = None
            ) -> torch.Tensor:
    """``jax.random.uniform`` in float32: the top 23 bits as the mantissa
    of a float in [1, 2), minus 1, scaled to ``[minval, maxval)`` and
    clamped below at ``minval``, each step in float32."""
    return _unit_floats(random_bits(key, shape, device), minval, maxval)


def _unit_floats(bits: torch.Tensor, minval: float, maxval: float
                 ) -> torch.Tensor:
    """32-bit draws -> ``jax.random.uniform``'s float32 values."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    # float32 scalars as host numbers (a device tensor made from a host
    # value would synchronize the stream); a float32 tensor computes with
    # them in float32
    lo = float(np.float32(minval))
    width = float(np.float32(maxval) - np.float32(minval))
    return torch.clamp(f * width + lo, min=lo)


def uniform_rows(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``[m, n]`` float32: row ``i`` is ``uniform(keys[i], (n,))`` for the
    ``[m, 2]`` device keys ``keys`` (``jax.vmap`` of ``uniform``), drawn on
    their device."""
    hi, lo = _counters((n,), keys.device)
    b1, b2 = threefry_2x32(keys[:, :1], keys[:, 1:], hi, lo)
    return _unit_floats(b1 ^ b2, 0.0, 1.0)


def bernoulli(key: torch.Tensor, p: float, shape: Shape,
              device: Optional[Union[str, torch.device]] = None
              ) -> torch.Tensor:
    """``jax.random.bernoulli(key, p, shape)``: ``uniform < p`` with ``p``
    rounded to float32."""
    return uniform(key, shape, device=device) < float(np.float32(p))


def permutation(key: torch.Tensor, n: int,
                device: Optional[Union[str, torch.device]] = None
                ) -> torch.Tensor:
    """``jax.random.permutation(key, n)`` (``_shuffle``): ``ceil(3 ln n /
    ln(2^32 - 1))`` rounds, each splitting the key and stably sorting by
    fresh 32-bit keys."""
    device = device or "cpu"
    x = torch.arange(n, dtype=torch.int64, device=device)
    rounds = int(math.ceil(3 * math.log(max(1, n)) / math.log(_M)))
    for _ in range(rounds):
        keys = split(key)
        key, sub = keys[0], keys[1]
        order = torch.sort(random_bits(sub, (n,), device), stable=True)[1]
        x = x[order]
    return x


def randint(key: torch.Tensor, shape: Shape, minval: int, maxval: int,
            device: Optional[Union[str, torch.device]] = None
            ) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` for int32 (``0 <=
    minval``, ``maxval < 2^31``): the key split in two, 32 bits from each
    (``higher``, ``lower``), and ``minval + (higher % span * m + lower %
    span) % span`` in uint32 arithmetic, ``m = 2^32 % span`` computed as
    ``((2^16 % span)^2) % span``. ``maxval <= minval`` gives ``minval``."""
    minval, maxval = int(minval), int(maxval)
    if not 0 <= minval and maxval < 2 ** 31:
        raise ValueError("randint takes 0 <= minval and maxval < 2^31")
    span = max(maxval - minval, 1)
    mult = ((((1 << 16) % span) ** 2) & _M) % span
    k1, k2 = split(key)
    higher = random_bits(k1, shape, device)
    lower = random_bits(k2, shape, device)
    # every product and sum below stays under 2^62: exact in int64
    off = ((((higher % span) * mult) & _M) + lower % span) & _M
    return (minval + off % span).to(torch.int32)


def gumbel(key: torch.Tensor, shape: Shape,
           device: Optional[Union[str, torch.device]] = None
           ) -> torch.Tensor:
    """``jax.random.gumbel`` (the default low-range mode):
    ``-log(-log(u))`` with ``u`` uniform on ``[tiny, 1)``."""
    u = uniform(key, shape, minval=_TINY_F32, maxval=1.0, device=device)
    return -torch.log(-torch.log(u))
