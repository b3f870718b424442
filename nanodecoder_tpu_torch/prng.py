"""`jax.random` as the JAX package uses it: threefry2x32 keys and draws.

JAX 0.9's default generator is threefry2x32 with `jax_threefry_partitionable`
on.  Everything here is that function, so the port draws the JAX package's
numbers from the same seed:

  * keys are host values, numpy uint32 arrays of shape (2,) as JAX's raw
    keys are, in exact integer arithmetic: `PRNGKey` (jax/_src/prng.py:817,
    the seed's low and high words, 0 and seed mod 2^32 with x64 off),
    `split` (:1156, threefry of the counters (0, i)) and `fold_in` (:1168,
    threefry of (0, data)).  Every key of the port comes from a seed and
    host counters (step, micro-batch, layer, batch, decode step), so no key
    needs the device and deriving one costs no launch or sync;
  * draws go through kernel R1 (`ops.threefry.threefry_draw`): element i of
    the row-major flat index, plus an offset, is hashed as the counter pair
    (i >> 32, i & 0xFFFFFFFF) and its 32 bits are the XOR of the two output
    words (:1184).  The offset lets a data-parallel rank draw its rows of
    the global array: JAX draws one array for the global shape whatever
    the sharding;
  * `uniform`, `bernoulli`, `normal`, `gumbel` and `categorical` compute
    what jax/_src/random.py computes from those bits.  `normal` evaluates
    XLA's f32 erf_inv polynomial, never torch.erfinv (which is another
    function); its float steps may round differently from XLA's by a few
    ulps (3 at most on 2^20 draws), and `gumbel`'s logs by up to about
    1e-6 absolute.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from nanodecoder_tpu_torch.ops.threefry import MASK32, key_words, threefry2x32, threefry_draw

# XLA's f32 erf_inv (Giles' polynomial): coefficients for w < 5 and w >= 5,
# highest degree first.
_ERFINV_LOW = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
               0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_HIGH = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
                0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)
_SQRT2 = float(np.float32(math.sqrt(2.0)))
_TINY = float(np.finfo(np.float32).tiny)


def PRNGKey(seed: int) -> np.ndarray:  # noqa: N802 (JAX's name)
    """JAX's `PRNGKey(seed)` with x64 off: (0, seed mod 2^32), for a seed
    in [-2^63, 2^63)."""
    seed = int(seed)
    if not -2**63 <= seed < 2**63:
        raise OverflowError(f"seed {seed} does not fit a 64-bit signed integer")
    return np.array([0, seed & MASK32], dtype=np.uint32)


def split(key, num: int = 2) -> np.ndarray:
    """`num` new keys, (num, 2) uint32: row i hashes the counters (0, i)."""
    k0, k1 = key_words(key)
    return np.array([threefry2x32(k0, k1, 0, i) for i in range(num)],
                    dtype=np.uint32).reshape(num, 2)


def fold_in(key, data: int) -> np.ndarray:
    """The key with `data` (in [0, 2^32)) folded in: the hash of (0, data).
    Raises OverflowError outside uint32, as JAX does."""
    data = int(data)
    if not 0 <= data <= MASK32:
        raise OverflowError(f"Python integer {data} out of bounds for uint32")
    return np.array(threefry2x32(*key_words(key), 0, data), dtype=np.uint32)


def _numel(shape) -> int:
    return math.prod(tuple(shape))


def bits(key, shape, *, device, offset: int = 0) -> torch.Tensor:
    """`jax.random.bits(key, shape)` (uint32) as an int32 tensor holding the
    same bit patterns.  `offset`: the flat index of this tensor's first
    element in the array JAX draws."""
    return threefry_draw(key, _numel(shape), "bits", offset=offset,
                         device=device).reshape(shape)


def uniform(key, shape, minval: float = 0.0, maxval: float = 1.0, *, device,
            offset: int = 0) -> torch.Tensor:
    """`jax.random.uniform(key, shape, float32, minval, maxval)`."""
    return threefry_draw(key, _numel(shape), "uniform", lo=minval, hi=maxval,
                         offset=offset, device=device).reshape(shape)


def bernoulli(key, p: float, shape, *, device, offset: int = 0) -> torch.Tensor:
    """`jax.random.bernoulli(key, p, shape)` (mode "low"): uniform < p, p
    as float32; a bool tensor."""
    return threefry_draw(key, _numel(shape), "bernoulli", p=p, offset=offset,
                         device=device).reshape(shape)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 erf_inv: w = -log1p(-x^2); for w < 5 the first
    coefficient set at w - 2.5, else the second at sqrt(w) - 3; Horner,
    times x; +-inf at |x| = 1.  XLA evaluates each Horner step as a fused
    multiply-add, which this takes in float64 and rounds once."""
    w = -torch.log1p(-(x * x))
    low = w < 5.0
    w = torch.where(low, w - 2.5, torch.sqrt(w) - 3.0).to(torch.float64)

    def coefficient(i: int) -> torch.Tensor:
        return torch.where(low, torch.tensor(np.float32(_ERFINV_LOW[i]), device=x.device),
                           torch.tensor(np.float32(_ERFINV_HIGH[i]), device=x.device))

    p = coefficient(0)
    for i in range(1, len(_ERFINV_LOW)):
        p = (coefficient(i).to(torch.float64) + p.to(torch.float64) * w).to(torch.float32)
    return torch.where(x.abs() == 1.0, x * torch.finfo(torch.float32).max, p * x)


def normal(key, shape, *, device, offset: int = 0) -> torch.Tensor:
    """`jax.random.normal(key, shape)`: sqrt(2) * erf_inv(u) with u uniform
    on (nextafter(-1, 0), 1) (jax/_src/random.py:867)."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    return _SQRT2 * erf_inv(uniform(key, shape, lo, 1.0, device=device, offset=offset))


def gumbel(key, shape, *, device, offset: int = 0) -> torch.Tensor:
    """`jax.random.gumbel(key, shape)` (mode "low"): -log(-log(u)), u
    uniform on [tiny, 1) (jax/_src/random.py:1723)."""
    u = uniform(key, shape, _TINY, 1.0, device=device, offset=offset)
    return -torch.log(-torch.log(u))


def categorical(key, logits: torch.Tensor, *, row0: int = 0) -> torch.Tensor:
    """`jax.random.categorical(key, logits, axis=-1)`: the argmax over the
    last axis of logits plus Gumbel noise drawn at the logits' shape, ties
    to the lowest index (jax/_src/random.py:1739).  `row0`: the place of
    the first row of `logits` (flattened to (rows, V)) in the array JAX
    draws, as a data-parallel rank's or a packed batch's rows take it."""
    noise = gumbel(key, logits.shape, device=logits.device,
                   offset=row0 * logits.shape[-1])
    return (noise + logits).argmax(dim=-1)
