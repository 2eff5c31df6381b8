"""Threefry-2x32 and the parts of `jax.random` the seeded switching key uses,
as torch ops on an explicit device.

The JAX package draws the uniform A block of its seeded switching key from
`jax.random.bits` (threefry2x32, partitionable mode). This module is the
port's own copy of that stream, so a key built by either package has the
same A bit for bit:

- `prng_key(seed)` is `jax.random.PRNGKey(seed)` for a u32 seed: (0, seed);
- `fold_in(key, c)` is `threefry2x32(key, (0, c))`, its two words the new key;
- `bits(key, counters)` is `jax.random.bits` in partitionable mode: element
  i of the flattened shape has the counter words (hi, lo) = (0, i), and its
  value is x0 ^ x1 of `threefry2x32(key, (0, i))`. Any block of a draw can
  therefore be generated alone from its flat indices.

Words are kept in int64 tensors below 2^32 and masked after every add and
shift (torch has no unsigned 32-bit arithmetic on every device).
"""

from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry2x32(key: tuple[int, int], x0: torch.Tensor,
                 x1: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32 with 20 rounds of the key `key` (two u32 words) on the
    counter words x0, x1 (int64 tensors of u32 values; consumed in place).
    Returns the two output words."""
    k0, k1 = int(key[0]) & _M32, int(key[1]) & _M32
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0.add_(ks[0]).bitwise_and_(_M32)
    x1.add_(ks[1]).bitwise_and_(_M32)
    for i in range(5):
        for r in _ROT[i % 2]:
            x0.add_(x1).bitwise_and_(_M32)
            hi = x1 << r
            x1.bitwise_right_shift_(32 - r).bitwise_or_(hi).bitwise_and_(_M32)
            x1.bitwise_xor_(x0)
        x0.add_(ks[(i + 1) % 3]).bitwise_and_(_M32)
        x1.add_(ks[(i + 2) % 3] + i + 1).bitwise_and_(_M32)
    return x0, x1


def prng_key(seed: int) -> tuple[int, int]:
    """`jax.random.PRNGKey(seed)` for a seed below 2^32."""
    return 0, int(seed) & _M32


def fold_in(key: tuple[int, int], data: int) -> tuple[int, int]:
    """`jax.random.fold_in(key, data)` for a u32 `data`."""
    x0 = torch.zeros(1, dtype=torch.int64)
    x1 = torch.full((1,), int(data) & _M32, dtype=torch.int64)
    y0, y1 = threefry2x32(key, x0, x1)
    return int(y0), int(y1)


def bits(key: tuple[int, int], counters: torch.Tensor) -> torch.Tensor:
    """The u32 words of `jax.random.bits(key, shape, uint32)` at the flat
    indices `counters` (int64, below 2^32) of the draw, on their device."""
    x0 = torch.zeros_like(counters)
    x1 = counters.clone()
    y0, y1 = threefry2x32(key, x0, x1)
    return y0.bitwise_xor_(y1)
