"""zarr v2 arrays over a key-value store (`io.ocdbt.OcdbtStore`): the
arrays of the JAX package's orbax checkpoints.

An array `name` is described by `name/.zarray` (JSON: `shape`, `chunks`,
`dtype`, `fill_value`, `order`, `compressor`, `filters`,
`dimension_separator`) and stored chunk by chunk under
`name/<i>.<j>...` (`name/0` for a 0-d array).  Chunks at the grid's far
edges are whole chunks on disk and are cut to the shape when read; a
missing chunk reads as `fill_value`.  Compressors `zstd` and none are
read; any other compressor, any filter or any other dtype raises with
its name.

numpy has no bfloat16: a `bfloat16` array reads as `<u2` holding the
bits (`ZarrArray.dtype` says "bfloat16"), and `as_float32` widens them
exactly, as the port's float32 params take them.
"""

from __future__ import annotations

import itertools
import json
import math

import numpy as np

from nanodecoder_tpu_torch.native import zstd

DTYPES = {"<f4": "<f4", "<f2": "<f2", "<i4": "<i4", "<i8": "<i8", "|u1": "|u1",
          "bfloat16": "<u2"}


class ZarrError(ValueError):
    """A zarr array this reader does not take, or that is malformed."""


def _bf16_bits(value: float) -> int:
    """float -> bfloat16 bits, rounded to nearest even."""
    bits = int(np.float32(value).view(np.uint32))
    if math.isnan(value):
        return 0x7FC0
    return ((bits + 0x7FFF + ((bits >> 16) & 1)) >> 16) & 0xFFFF


def _fill(value, zdtype: str, np_dtype: np.dtype):
    if value is None:
        return 0
    if isinstance(value, str):  # "NaN", "Infinity", "-Infinity"
        value = float(value.replace("Infinity", "inf"))
    if zdtype == "bfloat16":
        return _bf16_bits(float(value))
    return np.asarray(value).astype(np_dtype)


class ZarrArray:
    """The zarr v2 array `name` of `store` (anything with `read(key)` and
    `in`)."""

    def __init__(self, store, name: str):
        self.store, self.name = store, name
        key = f"{name}/.zarray"
        if key not in store:
            raise KeyError(f"no zarr array {name!r} (no {key})")
        meta = json.loads(store.read(key))
        if meta.get("zarr_format") != 2:
            raise ZarrError(f"{name}: zarr_format {meta.get('zarr_format')!r}, want 2")
        self.dtype = meta["dtype"]
        if not isinstance(self.dtype, str) or self.dtype not in DTYPES:
            raise ZarrError(f"{name}: dtype {self.dtype!r} is not read "
                            f"(read: {', '.join(DTYPES)})")
        self.np_dtype = np.dtype(DTYPES[self.dtype])
        compressor = meta.get("compressor")
        self.compressor = None if compressor is None else compressor.get("id")
        if self.compressor not in (None, "zstd"):
            raise ZarrError(f"{name}: compressor {self.compressor!r} is not read "
                            "(read: zstd, none)")
        if meta.get("filters"):
            ids = [f.get("id") for f in meta["filters"]]
            raise ZarrError(f"{name}: filters {ids} are not read")
        self.order = meta.get("order", "C")
        if self.order not in ("C", "F"):
            raise ZarrError(f"{name}: order {self.order!r}")
        separator = meta.get("dimension_separator", ".")
        if separator != ".":
            raise ZarrError(f"{name}: dimension_separator {separator!r}, want \".\"")
        self.shape = tuple(int(s) for s in meta["shape"])
        self.chunks = tuple(int(c) for c in meta["chunks"])
        if len(self.chunks) != len(self.shape) or any(c <= 0 for c in self.chunks):
            raise ZarrError(f"{name}: chunks {self.chunks} for shape {self.shape}")
        self.fill_value = _fill(meta.get("fill_value"), self.dtype, self.np_dtype)

    def _chunk(self, index: tuple[int, ...]) -> np.ndarray | None:
        key = f"{self.name}/{'.'.join(map(str, index)) if index else '0'}"
        if key not in self.store:
            return None
        raw = self.store.read(key)
        if self.compressor == "zstd":
            raw = zstd.decompress(raw)
        want = math.prod(self.chunks) * self.np_dtype.itemsize
        if len(raw) != want:
            raise ZarrError(f"{key}: {len(raw)} bytes, a chunk of {self.chunks} "
                            f"{self.dtype} is {want}")
        return np.frombuffer(raw, self.np_dtype).reshape(self.chunks, order=self.order)

    def read(self) -> np.ndarray:
        """The whole array (bfloat16 as its `<u2` bits)."""
        out = np.full(self.shape, self.fill_value, self.np_dtype)
        grid = [range(-(-s // c)) for s, c in zip(self.shape, self.chunks)]
        for index in itertools.product(*grid):
            chunk = self._chunk(index)
            if chunk is None:
                continue
            dst = tuple(slice(i * c, min((i + 1) * c, s))
                        for i, c, s in zip(index, self.chunks, self.shape))
            out[dst] = chunk[tuple(slice(0, d.stop - d.start) for d in dst)]
        return out

    def as_float32(self) -> np.ndarray:
        """The array as float32 (exact for every float dtype read here)."""
        arr = self.read()
        if self.dtype == "bfloat16":
            return (arr.astype(np.uint32) << 16).view(np.float32)
        return arr.astype(np.float32)

