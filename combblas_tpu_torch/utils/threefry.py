"""Threefry2x32 random streams — the parts of ``jax.random`` that the
reference draws from (``utils/rmat.py:rmat_edges``, ``DistVec.randperm``,
``models/graph500.py:kernel1_device``), bit for bit.

The stream is JAX's with ``jax_threefry_partitionable=True`` (the default
of the JAX release the reference runs on):

  * a key is two uint32 words; ``key(seed)`` is ``jax.random.key(seed)``;
  * ``split(key, num)`` hashes the counters ``(0, i)`` for i < num, and
    ``fold_in(key, d)`` the counter ``(0, d)``; the two output words are
    the new key;
  * ``bits(key, shape)`` hashes the counters ``(i >> 32, i & 0xFFFFFFFF)``
    of the flat index i over the whole shape and xors the two words;
  * ``uniform`` puts the top 23 bits of ``bits`` in the mantissa of a
    float32 in [1, 2), subtracts 1, then scales to [minval, maxval);
  * ``permutation(key, n)`` sorts ``arange(n)`` by fresh 32-bit keys,
    ``ceil(3 ln n / ln(2^32 - 1))`` times, stably.

uint32 words are held in int64 tensors, masked to 32 bits after every add
and shifted logically, so the arithmetic is exact on every device. Keys
are host values; only ``bits`` and what draws on it run on a device, and
``offset`` lets a caller draw a long stream in pieces: the flat index
starts there.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


@dataclasses.dataclass(frozen=True)
class ThreefryKey:
    """A threefry2x32 key: the two uint32 words of ``jax.random.key_data``."""

    hi: int
    lo: int

    def data(self) -> np.ndarray:
        return np.array([self.hi, self.lo], np.uint32)


def key(seed: int) -> ThreefryKey:
    """``jax.random.key(seed)`` for a seed in the int32 or uint32 range, or
    any non-negative 64-bit seed: the high word is ``seed >> 32`` (0 for a
    negative int32 seed, whose low word is its two's complement)."""
    seed = int(seed)
    if seed < 0:
        if seed < -(1 << 31):
            raise ValueError(f"seed {seed} is below the int32 range")
        return ThreefryKey(0, seed & MASK)
    if seed >= 1 << 64:
        raise ValueError(f"seed {seed} does not fit 64 bits")
    return ThreefryKey((seed >> 32) & MASK, seed & MASK)


def _rotl(x, r: int):
    return ((x << r) & MASK) | (x >> (32 - r))


def threefry2x32(k1: int, k2: int, x1, x2):
    """The threefry2x32 hash (20 rounds) of the counter pairs ``(x1, x2)``
    under key ``(k1, k2)``: int64 tensors (or Python ints) holding uint32
    values, returned the same way."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & MASK
    x2 = (x2 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & MASK
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & MASK
    return x1, x2


def split(k: ThreefryKey, num: int = 2) -> list[ThreefryKey]:
    """``jax.random.split(k, num)``."""
    out = []
    for i in range(num):
        y1, y2 = threefry2x32(k.hi, k.lo, 0, i)
        out.append(ThreefryKey(y1, y2))
    return out


def fold_in(k: ThreefryKey, data: int) -> ThreefryKey:
    """``jax.random.fold_in(k, data)``."""
    y1, y2 = threefry2x32(k.hi, k.lo, 0, int(data) & MASK)
    return ThreefryKey(y1, y2)


def _device(device) -> torch.device:
    return torch.device("cuda" if device is None else device)


def bits(k: ThreefryKey, shape, device=None, offset: int = 0) -> torch.Tensor:
    """``jax.random.bits(k, shape)`` (uint32) as int64 values in
    [0, 2^32), on ``device`` (default: the CUDA card). With ``offset`` the
    flat index starts there: element e of the result is element
    ``offset + e`` of a draw over a larger shape."""
    shape = tuple(shape)
    n = math.prod(shape)
    idx = torch.arange(offset, offset + n, dtype=torch.int64, device=_device(device))
    y1, y2 = threefry2x32(k.hi, k.lo, idx >> 32, idx & MASK)
    return (y1 ^ y2).view(shape)


def uniform(k: ThreefryKey, shape, minval: float = 0.0, maxval: float = 1.0,
            device=None, offset: int = 0) -> torch.Tensor:
    """``jax.random.uniform(k, shape, minval=, maxval=)`` in float32: the top
    23 of ``bits`` as the mantissa of a float in [1, 2), minus 1. Then
    ``minval`` and ``maxval`` round to float32, their difference is taken
    in float32, and ``floats * diff + minval`` is rounded once, as the
    reference's XLA program fuses it into one multiply-add. The product of
    two float32 values is exact in float64, and so is the sum while
    ``|minval| < 32 * diff`` (the reference's noise range [0.95, 1.05) is):
    float64 arithmetic rounded to float32 then gives the fused result.
    Other ranges raise, as float64 could round twice there."""
    b = bits(k, shape, device, offset)
    floats = ((b >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    if (minval, maxval) == (0.0, 1.0):
        return floats
    lo = float(np.float32(minval))
    diff = float(np.float32(maxval) - np.float32(minval))
    if not abs(lo) < 32 * diff:
        raise ValueError(f"uniform over [{minval}, {maxval}) is not drawn bit for bit here")
    return torch.clamp((floats.double() * diff + lo).float(), min=lo)


def permutation(k: ThreefryKey, n: int, device=None) -> torch.Tensor:
    """``jax.random.permutation(k, n)``: int32 [n]."""
    x = torch.arange(n, dtype=torch.int32, device=_device(device))
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(np.iinfo(np.uint32).max)))
    for _ in range(rounds):
        k, sub = split(k)
        order = torch.sort(bits(sub, (n,), x.device), stable=True).indices
        x = x[order]
    return x
