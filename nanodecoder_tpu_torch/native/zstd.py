"""Zstandard decoding and CRC32C in `zstd.cpp`, built at first use
with g++ into `libnanodecoder_zstd.so` and bound with ctypes.

The orbax checkpoints that the JAX package writes hold zstd frames (the
OCDBT manifests and B+tree nodes, and each zarr chunk) and end every
OCDBT file with a CRC32C.  There is no Python fallback: where the
library cannot be built or loaded, `load()` and every function here
raise `ZstdUnavailable` with the compiler's stderr, every time.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "zstd.cpp")
LIBRARY_NAME = "libnanodecoder_zstd.so"
COMPILER = "g++"
FLAGS = ["-O3", "-shared", "-fPIC"]

# The format paths `zstd.cpp` counts, in its order (`mode_counts`).
MODES = ("block_raw", "block_rle", "block_compressed", "literals_raw", "literals_rle",
         "literals_huffman_1", "literals_huffman_4", "literals_treeless", "weights_direct",
         "weights_fse", "sequences_predefined", "sequences_rle", "sequences_fse",
         "sequences_repeat", "frame_checksum", "frame_skippable", "frame_window",
         "frame_no_size")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_error: str | None = None


class ZstdUnavailable(RuntimeError):
    """The native zstd library could not be built or loaded."""


class ZstdError(ValueError):
    """A zstd input that does not decode."""


def load() -> ctypes.CDLL:
    """The compiled library, built first if needed.  Raises
    ZstdUnavailable (again on every call) where it cannot be built or
    loaded."""
    global _lib, _error
    from nanodecoder_tpu_torch.native import build_library

    with _lock:
        if _lib is not None:
            return _lib
        if _error is not None:
            raise ZstdUnavailable(_error)
        try:
            lib = ctypes.CDLL(build_library(SOURCE, LIBRARY_NAME, COMPILER, FLAGS))
        except (OSError, subprocess.SubprocessError) as e:
            detail = (getattr(e, "stderr", "") or "").strip()
            _error = (f"the native zstd library ({LIBRARY_NAME}) could not be built or "
                      f"loaded, and orbax checkpoints are not read without it: {e}"
                      + (f"\n{detail}" if detail else ""))
            raise ZstdUnavailable(_error) from e
        size_p = ctypes.POINTER(ctypes.c_size_t)
        lib.nd_zstd_decompress.restype = ctypes.c_int
        lib.nd_zstd_decompress.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.POINTER(ctypes.c_void_p), size_p,
            ctypes.c_char_p, ctypes.c_size_t]
        lib.nd_free.restype = None
        lib.nd_free.argtypes = [ctypes.c_void_p]
        lib.nd_crc32c.restype = ctypes.c_uint32
        lib.nd_crc32c.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
        lib.nd_zstd_mode_counts.restype = ctypes.c_int
        lib.nd_zstd_mode_counts.argtypes = [ctypes.POINTER(ctypes.c_uint64), ctypes.c_int,
                                            ctypes.c_int]
        _lib = lib
        return _lib


def decompress(data: bytes) -> bytes:
    """Every zstd frame in `data`, decoded and joined (skippable frames
    skipped, content checksums verified).  Raises ZstdError where the
    input does not decode."""
    lib = load()
    data = bytes(data)
    out = ctypes.c_void_p()
    n = ctypes.c_size_t()
    err = ctypes.create_string_buffer(512)
    if lib.nd_zstd_decompress(data, len(data), ctypes.byref(out), ctypes.byref(n),
                              err, len(err)):
        raise ZstdError(f"zstd: {err.value.decode(errors='replace')}")
    try:
        return ctypes.string_at(out, n.value)
    finally:
        lib.nd_free(out)


def crc32c(data: bytes) -> int:
    """CRC32C (Castagnoli) of `data`."""
    data = bytes(data)
    return int(load().nd_crc32c(data, len(data)))


def mode_counts(reset: bool = False) -> dict[str, int]:
    """How often each format path of the decoder (MODES) has run in this
    process, since the last reset; `reset` zeroes the counts after reading."""
    out = (ctypes.c_uint64 * len(MODES))()
    n = load().nd_zstd_mode_counts(out, len(MODES), int(reset))
    if n != len(MODES):
        raise ZstdUnavailable(f"{LIBRARY_NAME} counts {n} modes, this module {len(MODES)}")
    return dict(zip(MODES, map(int, out)))
