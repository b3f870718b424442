"""Threefry2x32 keys and Bernoulli masks, as `jax.random` draws them.

A frozen copy for the benchmark's training reference, which draws the
dropout masks again from the keys the trainer derives from the seed.  It
imports nothing of the program.  Keys are numpy uint32 pairs; draws are
plain int64 torch arithmetic masked to 32 bits, on any device:

  * PRNGKey(seed) = (0, seed mod 2^32);
  * split(key, n)[i] hashes the counters (0, i); fold_in hashes (0, data);
  * element i of a draw (plus a counter offset) hashes (i >> 32, i mod
    2^32) and takes the XOR of the two output words; a uniform on [0, 1)
    is ((bits >> 9) | 0x3F800000) as a float32 minus 1; bernoulli(p) is
    uniform < float32(p).
"""

from __future__ import annotations

import math

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
PARITY = 0x1BD11BDA
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
# Elements hashed per pass: bounds the int64 temporaries of a large mask.
PIECE = 1 << 24


def hash2x32(k0, k1, x0, x1):
    """Threefry2x32 of the counter pair (x0, x1) under the key (k0, k1):
    20 rounds and five key injections.  Python ints or int64 tensors
    holding uint32 values."""
    ks = (k0, k1, k0 ^ k1 ^ PARITY)
    x0, x1 = (x0 + ks[0]) & MASK32, (x1 + ks[1]) & MASK32
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = (((x1 << r) & MASK32) | (x1 >> (32 - r))) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + (ks[(i + 2) % 3] + i + 1)) & MASK32
    return x0, x1


def _words(key) -> tuple[int, int]:
    k = np.asarray(key)
    return int(k[0]) & MASK32, int(k[1]) & MASK32


def prng_key(seed: int) -> np.ndarray:
    return np.array([0, int(seed) & MASK32], dtype=np.uint32)


def split(key, num: int = 2) -> np.ndarray:
    k0, k1 = _words(key)
    return np.array([hash2x32(k0, k1, 0, i) for i in range(num)],
                    dtype=np.uint32).reshape(num, 2)


def bernoulli(key, p: float, shape, device, offset: int = 0) -> torch.Tensor:
    """The keep mask P(True) = p of `shape`, its first element at counter
    `offset` of the array drawn."""
    n = math.prod(tuple(shape))
    k0, k1 = _words(key)
    p32 = float(np.float32(p))
    out = torch.empty(n, dtype=torch.bool, device=device)
    for lo in range(0, n, PIECE):
        i = torch.arange(lo, min(n, lo + PIECE), dtype=torch.int64, device=device) + offset
        x0, x1 = hash2x32(k0, k1, i >> 32, i & MASK32)
        f = (((x0 ^ x1) >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
        out[lo:lo + i.numel()] = f < p32
    return out.reshape(shape)
