"""Where the port's built libraries go, and when they are built again
(the counterpart of the JAX package's persistent compilation cache,
`nanodecoder_tpu.utils.cache`).

Shared by the CUDA kernel library (`ops._build`) and the host library
(`native`).  The standard library only, so the host tier and the
engine's finishing processes, which never touch torch, can use it.

The directory is $NANODECODER_TORCH_BUILD_DIR where that is set, else
`nanodecoder_tpu_torch/_build/` (which git ignores), else, where that
cannot be written, a directory under the system's temp dir.  A library
is rebuilt when a source is newer than it or the compiler command
differs from the one in the stamp file beside it, and moved into place
whole, so processes that build or load at once never see a half-written
file.
"""

from __future__ import annotations

import os
import tempfile

_PKG = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR_ENV = "NANODECODER_TORCH_BUILD_DIR"


def build_dir() -> str:
    """Where built libraries go: $NANODECODER_TORCH_BUILD_DIR, else the
    package's `_build/`, else (read-only) a directory under the temp dir.
    Made if missing."""
    path = os.environ.get(BUILD_DIR_ENV) or os.path.join(_PKG, "_build")
    try:
        os.makedirs(path, exist_ok=True)
    except OSError:
        path = None
    if path is None or not os.access(path, os.W_OK):
        path = os.path.join(tempfile.gettempdir(), "nanodecoder_tpu_torch_build")
        os.makedirs(path, exist_ok=True)
    return path


def stale(library: str, deps: list[str], command: list[str]) -> bool:
    """Whether `library` must be built again: missing, older than one of
    `deps`, or built by another command than `command` (recorded in its
    stamp file, `library + ".stamp"`)."""
    try:
        with open(library + ".stamp") as f:
            same = f.read() == "\0".join(command)
        built = os.path.getmtime(library)
    except OSError:
        return True
    return not same or max(os.path.getmtime(p) for p in deps) > built


def install(tmp: str, library: str, command: list[str]) -> None:
    """Move a library built at `tmp` into place, then its stamp.  Each
    step is one rename, so a process that loads `library` meanwhile finds
    a whole file, old or new; one that reads the old stamp beside the new
    library builds again."""
    os.replace(tmp, library)
    stamp = f"{library}.stamp.{os.getpid()}.tmp"
    with open(stamp, "w") as f:
        f.write("\0".join(command))
    os.replace(stamp, library + ".stamp")
