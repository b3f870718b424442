"""Threefry2x32 random draws (kernel R1): raw bits, uniform floats or a
Bernoulli mask for a key, a count and a counter offset.

R1 replaces no Pallas kernel: it is the port's counterpart of the XLA op
behind `jax.random` (`jax._src.prng.threefry2x32_p`, which XLA runs for
every draw of the JAX package), added because the same hash as plain
PyTorch ops costs about 160 elementwise launches a draw.  Element i
(i = offset + 0 .. n-1) hashes the counter pair (i >> 32, i & 0xFFFFFFFF)
and takes the XOR of the two output words (jax/_src/prng.py:1184, the
partitionable mode).  From those 32 bits:

  * "bits": the bits, stored as int32 (the same bit pattern as JAX's uint32);
  * "uniform": ((bits >> 9) | 0x3F800000) as a float32 in [1, 2), minus 1,
    then fma(f, hi - lo, lo) with hi - lo rounded to float32, and at least
    lo (jax/_src/random.py:435).  JAX on the CPU compiles that multiply-add
    as one fused multiply-add; the plain version takes it in float64 (the
    product of two float32s is exact there) and rounds once;
  * "bernoulli": f < p with p as float32, where f is the uniform on [0, 1)
    (random.py:1075, mode "low"); a bool tensor.

On a CUDA device `threefry_draw` launches the kernel of
`csrc/threefry.cu`, whatever `use_pallas` says (as the lean step runs K2:
the JAX package's draws are XLA ops on either route); on the CPU it runs
`threefry_draw_plain`, the same arithmetic on int64 tensors masked to 32
bits.  R1 takes no differentiable input, so it has no backward.

A draw captured in a CUDA graph keeps the key words it was launched with,
so the train step's graph draws through `threefry_draw_table` instead:
the same hash with the key read from a row of a device key table, which
the host rewrites before each replay.  Inside `keys_from_table(table)`,
each `threefry_draw` on the card takes the table's next row so (the key
it is handed is only collected, for the caller to check against the
table); `threefry_draw_table_plain` is that launcher's plain version.
"""

from __future__ import annotations

import contextlib
import threading

import numpy as np
import torch

from nanodecoder_tpu_torch.ops import _build

KINDS = {"bits": 0, "uniform": 1, "bernoulli": 2}
OUT_DTYPES = {"bits": torch.int32, "uniform": torch.float32, "bernoulli": torch.bool}
MASK32 = 0xFFFFFFFF
KEY_PARITY = 0x1BD11BDA
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry2x32(k0, k1, x0, x1):
    """JAX's threefry2x32 hash of the counter pair (x0, x1) under the key
    (k0, k1): 20 rounds of add, rotate and xor (rotations 13, 15, 26, 6 /
    17, 29, 16, 24) and five key injections with the parity 0x1BD11BDA
    (jax/_src/prng.py:883).  On Python ints (the host's keys) or on int64
    tensors of uint32 values (the plain version's draws), every step
    masked to 32 bits.  Returns the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ KEY_PARITY)
    x0, x1 = (x0 + ks[0]) & MASK32, (x1 + ks[1]) & MASK32
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = (((x1 << r) & MASK32) | (x1 >> (32 - r))) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + (ks[(i + 2) % 3] + i + 1)) & MASK32
    return x0, x1


def key_words(key) -> tuple[int, int]:
    """A key (two uint32 words, as JAX's raw keys) as two Python ints."""
    k = np.asarray(key)
    if k.shape != (2,):
        raise ValueError(f"a key is two uint32 words, got shape {k.shape}")
    return int(k[0]) & MASK32, int(k[1]) & MASK32


def _float32(x: float) -> float:
    return float(np.float32(x))


def _uniform_terms(lo: float, hi: float) -> tuple[float, float]:
    """lo and hi - lo, each rounded to float32 as JAX rounds them."""
    lo32 = np.float32(lo)
    return float(lo32), float(np.float32(hi) - lo32)


def _draw_plain(k0, k1, n: int, kind: str, offset: int, lo: float, hi: float, p: float,
                device) -> torch.Tensor:
    """n draws of `kind` under the key words k0, k1 (Python ints, or 0-d
    int64 tensors of uint32 values on `device`)."""
    i = torch.arange(n, dtype=torch.int64, device=device) + int(offset)
    x0, x1 = threefry2x32(k0, k1, i >> 32, i & MASK32)
    word = x0 ^ x1
    if kind == "bits":
        return torch.where(word >= 2**31, word - 2**32, word).to(torch.int32)
    f = ((word >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    if kind == "bernoulli":
        return f < _float32(p)
    if kind != "uniform":
        raise ValueError(f"unknown draw kind {kind!r}")
    lo32, span = _uniform_terms(lo, hi)
    u = (f.to(torch.float64) * span + lo32).to(torch.float32)
    return torch.clamp_min(u, lo32)


def threefry_draw_plain(key, n: int, kind: str, *, offset: int = 0, lo: float = 0.0,
                        hi: float = 1.0, p: float = 0.5,
                        device: torch.device | str = "cpu") -> torch.Tensor:
    """The kernel's plain version: threefry2x32 on int64 tensors masked to
    32 bits, on `device`.  Returns a 1-D tensor of n values."""
    return _draw_plain(*key_words(key), n, kind, offset, lo, hi, p, device)


def threefry_draw_table_plain(table: torch.Tensor, row: int, n: int, kind: str, *,
                              offset: int = 0, lo: float = 0.0, hi: float = 1.0,
                              p: float = 0.5) -> torch.Tensor:
    """The table-keyed kernel's plain version, on the table's device: the
    key words are row `row` of `table` ((rows, 2) int32 holding the uint32
    words' bit patterns), read as tensors, never on the host."""
    k = table[row].to(torch.int64) & MASK32
    return _draw_plain(k[0], k[1], n, kind, offset, lo, hi, p, table.device)


def _checked(n: int, offset: int, kind: str) -> tuple[int, int]:
    if kind not in KINDS:
        raise ValueError(f"unknown draw kind {kind!r}")
    n, offset = int(n), int(offset)
    if n < 0 or offset < 0 or offset + n > 2**63:
        raise ValueError(f"counters [{offset}, {offset + n}) outside [0, 2^63)")
    return n, offset


def threefry_draw_table(table: torch.Tensor, row: int, n: int, kind: str, *,
                        offset: int = 0, lo: float = 0.0, hi: float = 1.0,
                        p: float = 0.5) -> torch.Tensor:
    """`threefry_draw` under the key in row `row` of the device table
    `table` ((rows, 2) int32, the key words' bit patterns), read by the
    kernel when it runs: on the table's device, the table-keyed kernel on
    a card, the plain version on the CPU."""
    n, offset = _checked(n, offset, kind)
    if table.dim() != 2 or table.shape[1] != 2 or table.dtype != torch.int32 \
            or not table.is_contiguous():
        raise ValueError(f"a key table is a contiguous (rows, 2) int32 tensor, got "
                         f"{tuple(table.shape)} {table.dtype}")
    if not 0 <= row < table.shape[0]:
        raise IndexError(f"key table row {row} outside its {table.shape[0]} rows")
    if table.device.type == "cpu":
        return threefry_draw_table_plain(table, row, n, kind, offset=offset, lo=lo, hi=hi, p=p)
    lo32, span = _uniform_terms(lo, hi)
    out = torch.empty(n, dtype=OUT_DTYPES[kind], device=table.device)
    if n:
        lib = _build.load()
        stream = torch.cuda.current_stream(table.device).cuda_stream
        _build.check(lib.nd_threefry_table(out.data_ptr(), n, table.data_ptr() + 8 * row,
                                           offset, KINDS[kind], lo32, span, _float32(p),
                                           stream), "threefry table kernel")
        threefry_draw.launches += 1
    return out


class _KeyTable(threading.local):
    table: torch.Tensor | None = None
    row = 0
    keys: list = []


_TABLE = _KeyTable()


@contextlib.contextmanager
def keys_from_table(table: torch.Tensor):
    """On this thread, while active: the i-th `threefry_draw` on the table's
    device draws under row i of `table` (`threefry_draw_table`), whatever
    key it is handed.  Yields the list of the keys handed (as (k0, k1)
    ints), in order, for the caller to check the table against."""
    if _TABLE.table is not None:
        raise RuntimeError("keys_from_table is already active on this thread")
    _TABLE.table, _TABLE.row, _TABLE.keys = table, 0, []
    try:
        yield _TABLE.keys
    finally:
        _TABLE.table = None


def threefry_draw(key, n: int, kind: str, *, offset: int = 0, lo: float = 0.0,
                  hi: float = 1.0, p: float = 0.5,
                  device: torch.device | str) -> torch.Tensor:
    """n draws of `kind` ("bits", "uniform" on [lo, hi), "bernoulli" with
    P(True) = p) for the flat indices offset .. offset + n - 1 under `key`
    (two uint32 words), as a 1-D tensor on `device`: the kernel on a CUDA
    device, the plain version on the CPU; inside `keys_from_table`, the
    table-keyed kernel under the table's next row.  offset + n must not
    pass 2^63 (JAX's own limit is 2^64)."""
    n, offset = _checked(n, offset, kind)
    device = torch.device(device)
    if device.type == "cpu":
        return threefry_draw_plain(key, n, kind, offset=offset, lo=lo, hi=hi, p=p,
                                   device=device)
    if device.type != "cuda":
        raise ValueError(f"threefry draws run on a CUDA device or the CPU, not {device}")
    table = _TABLE.table
    if table is not None and (table.device == device or device.index is None):
        row = _TABLE.row
        _TABLE.row += 1
        _TABLE.keys.append(key_words(key))
        return threefry_draw_table(table, row, n, kind, offset=offset, lo=lo, hi=hi, p=p)
    k0, k1 = key_words(key)
    lo32, span = _uniform_terms(lo, hi)
    out = torch.empty(n, dtype=OUT_DTYPES[kind], device=device)
    if n:
        lib = _build.load()
        stream = torch.cuda.current_stream(device).cuda_stream
        _build.check(lib.nd_threefry(out.data_ptr(), n, k0, k1, offset, KINDS[kind], lo32,
                                     span, _float32(p), stream), "threefry kernel")
        threefry_draw.launches += 1
    return out


threefry_draw.launches = 0
