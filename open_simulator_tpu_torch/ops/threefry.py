"""Threefry-2x32: the port's copy of the counter-based generator behind the
reference's ``tie_break_seed`` jitter.

The reference draws ``jax.random.uniform(fold_in(PRNGKey(seed), p), (N,),
minval=0.0, maxval=0.5)`` per pod (``engine/scheduler.py:1238-1243``).
This module computes the same bits and floats without JAX, as JAX 0.9.0
does with ``jax_threefry_partitionable`` on (its default):

- ``PRNGKey(seed)`` is the pair ``(0, seed & 0xFFFFFFFF)``: without x64
  the seed is a 32-bit integer, whose logical shift by 32 is 0;
- ``fold_in(key, d)`` hashes the counter pair ``(0, d)`` under ``key`` and
  the two output words are the new key;
- element ``n`` of ``random_bits(key, 32, (N,))`` hashes the counter pair
  ``(0, n)`` (the hi and lo words of the element's index) and XORs the two
  output words;
- ``uniform`` keeps the top 23 bits as the mantissa of a float in [1, 2),
  subtracts 1, scales by ``maxval - minval`` and adds ``minval``.

Threefry-2x32 is 20 rounds of add, rotate and XOR over two 32-bit words,
with a key injection after every 4 rounds. The arithmetic here is int64
(numpy or torch) masked to 32 bits, since torch's uint32 support is
partial. The kernel (``csrc/plain_step.cu``) has a ``__device__`` twin
of ``threefry2x32`` and ``jitter_of``.
"""

from __future__ import annotations

from typing import Tuple

import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x, d: int):
    return ((x << d) | (x >> (32 - d))) & MASK


def threefry2x32(k0: int, k1: int, x0, x1):
    """The hash of the counter words (x0, x1) under the key (k0, k1): two
    output words. The counters are Python ints or int64 tensors holding
    values below 2^32; the result has their type."""
    ks = (k0 & MASK, k1 & MASK, (k0 ^ k1 ^ _PARITY) & MASK)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK
    return x0, x1


def prng_key(seed: int) -> Tuple[int, int]:
    """``jax.random.PRNGKey(seed)``'s key words (the seed as int32)."""
    return 0, int(seed) & MASK


def fold_in(key: Tuple[int, int], data: int) -> Tuple[int, int]:
    """``jax.random.fold_in(key, data)`` for a data value below 2^32."""
    return threefry2x32(key[0], key[1], 0, int(data) & MASK)


def random_bits(key: Tuple[int, int], n: int, device=None) -> torch.Tensor:
    """``jax.random.bits(key, (n,))``: [n] int64 holding uint32 values."""
    lo = torch.arange(n, dtype=torch.int64, device=device)
    b0, b1 = threefry2x32(key[0], key[1], torch.zeros_like(lo), lo)
    return b0 ^ b1


def tie_break_jitter(seed: int, pod_index: int, n: int, device=None) -> torch.Tensor:
    """The reference's tie-break jitter of pod `pod_index` over `n` nodes:
    ``uniform(fold_in(PRNGKey(seed), pod_index), (n,), 0.0, 0.5)``, f32.
    jax.random.uniform keeps the top 23 bits as the mantissa of [1, 2),
    subtracts 1, scales by maxval - minval and adds minval; over [0, 0.5)
    the scale is exact and the shift and its max(minval, .) are no-ops."""
    bits = random_bits(fold_in(prng_key(seed), pod_index), n, device)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return (f - 1.0) * 0.5
