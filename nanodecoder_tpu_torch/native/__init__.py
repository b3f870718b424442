"""Native (C++) host kernels, built at first use with g++ and bound with
ctypes (the port's counterpart of `nanodecoder_tpu.native`).

`overlap.cpp` holds the stitcher's overlap scorer (`best_overlap_len`,
and `best_overlap_len_batch` for many junctions in one call) and the
banded edit distance that read identity runs (`banded_edit_distance`,
-1 when the end cell falls outside the band).  `io.stitch` and
`identity` call them when the library loads and keep their numpy
versions as the plain fallback.

The library builds into `build_cache.build_dir()` (git-ignored; a temp
dir when that is read-only) under a name tied to this process, and is
renamed into place whole, so processes that build at once (test
workers, the engine's finishing processes) never load a half-written
file.  It is
rebuilt when `overlap.cpp` is newer or the compiler command changed.
Where it cannot be built or loaded, one warning is logged and the numpy
versions run.

`zstd.cpp` is a library of its own, `libnanodecoder_zstd.so`
(`native.zstd`): the Zstandard decoder (with its XXH64 content
checksum) and CRC32C that reading the JAX package's orbax checkpoints
needs (`io.ocdbt`, `io.zarr`).  It
has no fallback: where it cannot be built or loaded, reading such a
checkpoint raises with the compiler's stderr.  Being separate, a fault
in it never sends the overlap scorer to its numpy version.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

from nanodecoder_tpu_torch import build_cache
from nanodecoder_tpu_torch.utils.logging import get_logger

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "overlap.cpp")
LIBRARY_NAME = "libnanodecoder_native.so"
COMPILER = "g++"
FLAGS = ["-O3", "-shared", "-fPIC"]

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_failed = False


def build_library(source: str, name: str, compiler: str, flags: list[str]) -> str:
    """Build `source` into `build_cache.build_dir()/name` unless it is
    current; its path.  Raises OSError or subprocess.SubprocessError (with
    the compiler's stderr) where the build fails."""
    path = os.path.join(build_cache.build_dir(), name)
    command = [compiler, *flags]
    if build_cache.stale(path, [source], command):
        tmp = f"{path}.{os.getpid()}.tmp"
        try:
            subprocess.run([*command, source, "-o", tmp], check=True,
                           capture_output=True, text=True, timeout=300)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise
        build_cache.install(tmp, path, command)
    return path


def _build_library() -> str:
    return build_library(SOURCE, LIBRARY_NAME, COMPILER, FLAGS)


def load() -> ctypes.CDLL | None:
    """The compiled library, built first if needed; None (after one
    logged warning) where it cannot be built or loaded."""
    global _lib, _failed
    with _lock:
        if _lib is not None or _failed:
            return _lib
        try:
            lib = ctypes.CDLL(_build_library())
        except (OSError, subprocess.SubprocessError) as e:
            detail = getattr(e, "stderr", "") or ""
            get_logger("native").warning(
                "native host library unavailable (%s%s); read identity and the "
                "overlap stitch run their numpy versions", e,
                f": {detail.strip()}" if detail else "")
            _failed = True
            return None
        text = ctypes.c_char_p
        lib.best_overlap_len.restype = ctypes.c_int
        lib.best_overlap_len.argtypes = [text, ctypes.c_int, text, ctypes.c_int,
                                         ctypes.c_int]
        lib.banded_edit_distance.restype = ctypes.c_int
        lib.banded_edit_distance.argtypes = [text, ctypes.c_int, text, ctypes.c_int,
                                             ctypes.c_int]
        _lib = lib
        return _lib


def best_overlap_len_native(left: bytes, right: bytes, max_k: int) -> int | None:
    """The native overlap scorer; None when the library is unavailable."""
    lib = load()
    if lib is None:
        return None
    return int(lib.best_overlap_len(left, len(left), right, len(right), max_k))


def banded_edit_distance_native(a: bytes, b: bytes, band: int) -> int | None:
    """The native banded edit distance (-1 when the end cell falls
    outside the band); None when the library is unavailable."""
    lib = load()
    if lib is None:
        return None
    return int(lib.banded_edit_distance(a, len(a), b, len(b), band))


def edit_distance(a: str, b: str, band: int | None = None) -> int:
    """Levenshtein distance: `identity.edit_distance` (native when the
    library loads, else numpy)."""
    from nanodecoder_tpu_torch import identity

    return identity.edit_distance(a, b, band)


def read_identity(called: str, truth: str) -> float:
    """1 - edit_distance / len(truth): `identity.read_identity`."""
    from nanodecoder_tpu_torch import identity

    return identity.read_identity(called, truth)
