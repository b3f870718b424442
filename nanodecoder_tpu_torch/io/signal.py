"""Raw-signal normalization, chunking and the host->device wire.

The host functions are the port's copy of `nanodecoder_tpu.io.signal`
(numpy only, bit-identical).  `wire_to_f32` is the device side: it
unpacks every wire dtype into float32 with torch ops on the tensor's
own device, bit-exact against the JAX decode of the same wire.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def normalize_signal(
    signal: np.ndarray,
    method: str = "mad",
    mad_scale: float = 1.4826,
    clip_sigma: float = 5.0,
    eps: float = 1e-8,
) -> np.ndarray:
    """Per-read z-score of raw signal -> float32.

    "mad": (x - median) / (mad_scale * MAD) — robust to current spikes,
    the standard basecaller normalization (SURVEY.md §2.1).
    "meanstd": plain (x - mean) / std.  "none": cast only.
    """
    x = np.asarray(signal, dtype=np.float32)
    if method == "none":
        return x
    if method == "mad":
        med = np.median(x)
        mad = np.median(np.abs(x - med))
        scale = mad_scale * mad
        out = (x - med) / (scale + eps)
    elif method == "meanstd":
        out = (x - x.mean()) / (x.std() + eps)
    else:
        raise ValueError(f"unknown normalization {method!r}")
    if clip_sigma:
        np.clip(out, -clip_sigma, clip_sigma, out=out)
    return out


def quantize_h2d_int8(x: np.ndarray, clip_sigma: float) -> np.ndarray:
    """z-scored signal (already clipped to +-clip_sigma) -> int8 for the
    host->device transfer: 127 steps per clip_sigma (~0.04 sigma at the
    default 5.0).  The device side multiplies by clip_sigma/127
    (h2d_int8_scale) to recover the signal.  np.rint rounds half to
    even — identical to jnp.round, so host- and device-side simulation
    of this quantization agree bit-for-bit."""
    return np.clip(np.rint(x * (127.0 / clip_sigma)), -127, 127).astype(np.int8)


def h2d_int8_scale(clip_sigma: float) -> float:
    return clip_sigma / 127.0


def quantize_h2d_int4(x: np.ndarray) -> np.ndarray:
    """z-scored chunks (N, L) -> int4 wire array (N, L/2 + 4) uint8.

    Per-CHUNK symmetric scale (VERDICT r4 weak #1: the int8 signal was
    84% of the engine's relay-bound wire bytes; sub-int8 packing halves
    the link floor again): each chunk's max |z| maps to ±7 nibble
    steps, so a typical ~2.5-sigma chunk quantizes at ~0.36 sigma/step
    (vs the fixed 0.04 of int8).  Two samples pack per byte (low nibble
    = even index, biased by +8); the chunk's f32 scale rides as the 4
    trailing bytes, keeping the wire a single array so every device
    program keeps its (signal, lengths) signature.  Decode with
    wire_to_f32 (device) — np.rint matches jnp.round bit-for-bit."""
    if x.ndim == 1:
        return quantize_h2d_int4(x[None, :])[0]
    n, length = x.shape
    assert length % 2 == 0, "int4 packing needs an even chunk_len"
    scales = np.maximum(np.abs(x).max(axis=1), 1e-6).astype(np.float32)
    q = np.clip(np.rint(x * (7.0 / scales[:, None])), -7, 7).astype(np.int8)
    u = (q + 8).astype(np.uint8)
    packed = (u[:, 0::2] | (u[:, 1::2] << 4)).astype(np.uint8)
    return np.concatenate(
        [packed, scales.view(np.uint8).reshape(n, 4)], axis=1)


def quantize_h2d_int6(x: np.ndarray) -> np.ndarray:
    """z-scored chunks (N, L) -> int6 wire array (N, 3L/4 + 4) uint8.

    The 4-bit wire measured a 3.2-point identity LOSS (round 5,
    bench_results/identity_r05.jsonl): the k-mer level table spans
    ±2.9 sigma with neighbor spacing finer than the ±7-step 0.43-sigma
    grid, and any nonlinear 4-bit companding coarsens the top levels
    that must stay distinguishable.  Six bits with a per-chunk max-|z|
    scale gives ~0.098 sigma steps (~int8-class added noise at 3/4 the
    bytes of int8): four samples pack into three bytes, little-endian
    within each 24-bit group, biased by +32; the f32 scale rides as 4
    trailing bytes (same convention as int4)."""
    if x.ndim == 1:
        return quantize_h2d_int6(x[None, :])[0]
    n, length = x.shape
    assert length % 4 == 0, "int6 packing needs chunk_len % 4 == 0"
    scales = np.maximum(np.abs(x).max(axis=1), 1e-6).astype(np.float32)
    q = np.clip(np.rint(x * (31.0 / scales[:, None])), -31, 31).astype(np.int16)
    u = (q + 32).astype(np.uint32)                     # 6-bit, in [1, 63]
    g = u.reshape(n, length // 4, 4)
    word = g[..., 0] | (g[..., 1] << 6) | (g[..., 2] << 12) | (g[..., 3] << 18)
    packed = np.stack([word & 0xFF, (word >> 8) & 0xFF, (word >> 16) & 0xFF],
                      axis=-1).astype(np.uint8).reshape(n, 3 * length // 4)
    return np.concatenate(
        [packed, scales.view(np.uint8).reshape(n, 4)], axis=1)


def convert_h2d(x: np.ndarray, dtype, clip_sigma: float) -> np.ndarray:
    """Cast a float32 chunk array to the H2D wire dtype.
    `dtype`: np.dtype or name string; "int4" is the packed sub-byte
    wire (quantize_h2d_int4), everything else a plain cast."""
    if str(dtype) == "int4":
        return quantize_h2d_int4(x)
    if str(dtype) == "int6":
        return quantize_h2d_int6(x)
    if np.dtype(dtype) == np.int8:
        return quantize_h2d_int8(x, clip_sigma)
    return x.astype(np.dtype(dtype))


_PACKED_WIRES = ("int4", "int6")


def wire_columns(chunk_len: int, h2d_name: str) -> int:
    """Per-chunk wire-array width for a given H2D dtype name."""
    name = str(h2d_name)
    if name == "int4":
        return chunk_len // 2 + 4
    if name == "int6":
        return 3 * chunk_len // 4 + 4
    return chunk_len


def wire_np_dtype(h2d_name) -> np.dtype:
    """Numpy dtype of the wire array (packed wires ride in uint8)."""
    if str(h2d_name) in _PACKED_WIRES:
        return np.dtype(np.uint8)
    return np.dtype(str(h2d_name))


def wire_to_f32(signal: torch.Tensor, h2d_name: str, clip_sigma: float,
                chunk_len: int) -> torch.Tensor:
    """Device-side wire decode -> float32 (B, chunk_len); the inverse of
    convert_h2d for every supported wire dtype.  Packed wires (int4,
    int6) carry each chunk's f32 scale in their 4 trailing bytes."""
    if h2d_name in _PACKED_WIRES:
        b = signal.shape[0]
        packed = signal[:, :-4]
        scales = signal[:, -4:].contiguous().view(torch.float32)  # (B, 1)
        if h2d_name == "int4":
            lo = (packed & 0xF).to(torch.int32) - 8
            hi = (packed >> 4).to(torch.int32) - 8
            q = torch.stack([lo, hi], dim=-1).reshape(b, chunk_len)
            return q.to(torch.float32) * (scales / 7.0)
        g = packed.to(torch.int32).reshape(b, chunk_len // 4, 3)
        word = g[..., 0] | (g[..., 1] << 8) | (g[..., 2] << 16)
        q = torch.stack([word & 0x3F, (word >> 6) & 0x3F,
                         (word >> 12) & 0x3F, (word >> 18) & 0x3F],
                        dim=-1).reshape(b, chunk_len) - 32
        return q.to(torch.float32) * (scales / 31.0)
    if h2d_name == "int8":
        step = torch.tensor(clip_sigma / 127.0, dtype=torch.float32,
                            device=signal.device)
        return signal.to(torch.float32) * step
    return signal.to(torch.float32)



@dataclasses.dataclass
class ChunkBatch:
    """Fixed-shape chunk array + bookkeeping to reassemble reads.

    chunks:  (n_chunks, chunk_len) float32, zero-padded
    lengths: (n_chunks,) int32 — real samples per chunk
    starts:  (n_chunks,) int64 — sample offset of each chunk in its read
    """

    chunks: np.ndarray
    lengths: np.ndarray
    starts: np.ndarray
    chunk_len: int
    chunk_overlap: int
    total_samples: int

    @property
    def n_chunks(self) -> int:
        return int(self.chunks.shape[0])


def chunk_signal(
    signal: np.ndarray,
    chunk_len: int,
    chunk_overlap: int,
    min_chunk_fill: float = 0.25,
) -> ChunkBatch:
    """Cut a normalized read into overlapping fixed-length windows.

    Windows start every `chunk_len - chunk_overlap` samples.  The final
    window is kept if it adds at least `min_chunk_fill * chunk_len` new
    samples (or if it is the only window); it is zero-padded to
    `chunk_len`.  Short reads yield one padded chunk.
    """
    if chunk_overlap >= chunk_len:
        raise ValueError("chunk_overlap must be < chunk_len")
    x = np.asarray(signal, dtype=np.float32)
    n = x.shape[0]
    stride = chunk_len - chunk_overlap

    starts: list[int] = []
    pos = 0
    while True:
        starts.append(pos)
        if pos + chunk_len >= n:
            break
        pos += stride
    # Drop a trailing window that contributes too few new samples.
    if len(starts) > 1:
        last = starts[-1]
        new_samples = n - (starts[-2] + chunk_len)
        if new_samples < min_chunk_fill * chunk_len and new_samples <= chunk_overlap:
            starts.pop()

    k = len(starts)
    chunks = np.zeros((k, chunk_len), dtype=np.float32)
    lengths = np.zeros((k,), dtype=np.int32)
    for i, s in enumerate(starts):
        seg = x[s : s + chunk_len]
        chunks[i, : seg.shape[0]] = seg
        lengths[i] = seg.shape[0]
    return ChunkBatch(
        chunks=chunks,
        lengths=lengths,
        starts=np.asarray(starts, dtype=np.int64),
        chunk_len=chunk_len,
        chunk_overlap=chunk_overlap,
        total_samples=n,
    )
