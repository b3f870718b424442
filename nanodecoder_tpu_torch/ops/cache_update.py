"""In-place write of one aligned 8-row block into the decode cache
(kernel K2).

The lean decode step stages the current block's rows in a (B, 8, C)
slab and flushes it every step into the combined (B, T, C) self cache
at rows [8*(step//8), +8).  On a CUDA tensor the wrapper launches the
copy kernel in `csrc/cache_update.cu`, which updates the cache IN
PLACE and returns it; on a CPU tensor it runs the plain version, which
writes into a clone.  Callers use the returned tensor either way.
"""

from __future__ import annotations

import torch

from nanodecoder_tpu_torch.ops import _build

BLOCK = 8  # rows per staged block; T must be a multiple of it


def write_cache_block_plain(cache: torch.Tensor, slab: torch.Tensor,
                            step: int) -> torch.Tensor:
    """The kernel's plain version: slice assignment on a clone."""
    t0 = (step // BLOCK) * BLOCK
    out = cache.clone()
    out[:, t0:t0 + BLOCK] = slab
    return out


def write_cache_block(cache: torch.Tensor, slab: torch.Tensor,
                      step: int) -> torch.Tensor:
    """cache: (B, T, C) with T % 8 == 0; slab: (B, 8, C) of the same
    dtype, the rows of the aligned block holding `step` in [0, T).  On
    the card the kernel copies in the widest unit (16, 4 or 1 bytes) that
    the addresses allow, with 64-bit indices: a batch row's block may
    exceed 2 GiB."""
    if cache.dim() != 3 or cache.shape[1] % BLOCK:
        raise ValueError(f"cache must be (B, T, C) with T % {BLOCK} == 0, "
                         f"got {tuple(cache.shape)}")
    b, t, c = cache.shape
    if slab.shape != (b, BLOCK, c):
        raise ValueError(f"slab must be {(b, BLOCK, c)}, got {tuple(slab.shape)}")
    if slab.dtype != cache.dtype:
        raise TypeError(f"slab dtype {slab.dtype} != cache dtype {cache.dtype}")
    if not 0 <= step < t:
        raise ValueError(f"step {step} outside [0, {t})")
    if cache.device.type == "cpu":
        return write_cache_block_plain(cache, slab, step)
    if cache.device.type != "cuda" or slab.device != cache.device:
        raise ValueError("cache and slab must lie on one CUDA device")
    if not (cache.is_contiguous() and slab.is_contiguous()):
        raise ValueError("cache and slab must be contiguous")
    if b and c:
        lib = _build.load()
        stream = torch.cuda.current_stream(cache.device).cuda_stream
        _build.check(lib.nd_write_cache_block(
            cache.data_ptr(), slab.data_ptr(), b, t, c, cache.element_size(),
            step, stream), "cache block write kernel")
        write_cache_block.launches += 1
    return cache


write_cache_block.launches = 0
