"""Build and load the port's CUDA kernels.

Every `csrc/*.cu` file is compiled by `nvcc` for `sm_90a` (one compiler
process per source, all started together) and linked into one shared
library with a plain C interface, loaded with ctypes.  The build runs
at first use and again when a source is newer than the library or the
compiler flags differ from those in the stamp file beside it, into
`build_cache.build_dir()` ($NANODECODER_TORCH_BUILD_DIR, else the
git-ignored `nanodecoder_tpu_torch/_build/`, else a temp dir), where the
host library of `native/` builds too.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import threading

from nanodecoder_tpu_torch.build_cache import build_dir, install, stale

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
LIBRARY_NAME = "libnanodecoder_kernels.so"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
CFLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None

_vp, _int, _float = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_i64, _u32, _u64 = ctypes.c_longlong, ctypes.c_uint32, ctypes.c_uint64
_intp = ctypes.POINTER(ctypes.c_int)
# C signature of each launcher: all return a cudaError_t as int.
_SIGNATURES = {
    # q, k, v, lengths, out, batch, seq, heads, head_dim, row stride,
    # is_bf16, scale, stream
    "nd_encoder_attention": [_vp, _vp, _vp, _vp, _vp, _int, _int, _int, _int,
                             _int, _int, _float, _vp],
    # q, k, v, valid_lens, k_scale, v_scale, out, amax, score workspace,
    # batch, group, T, D, cache width Dk, heads, is_bf16, is_int8, scale,
    # stream, the kernel launched (out: 0 row, 1 grouped, 2 scalar)
    "nd_decode_attention": [_vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _int,
                            _int, _int, _int, _int, _int, _int, _int, _float, _vp,
                            _intp],
    # cache, slab, batch, T, C, elem_bytes, step, stream
    "nd_write_cache_block": [_vp, _vp, _int, _int, _int, _int, _int, _vp],
    # alive, log_probs, fin, pen, batch, k, v, eos_id, top_ids, alive_s,
    # alive_sel, fin_s, fin_sel, stream
    "nd_beam_advance": [_vp, _vp, _vp, _float, _int, _int, _int, _int, _vp, _vp,
                        _vp, _vp, _vp, _vp],
    # alive, log_probs, batch, k, v, n_out, scores, ids, stream
    "nd_beam_topk": [_vp, _vp, _int, _int, _int, _int, _vp, _vp, _vp],
    # out, n, key words k0 and k1, counter offset, kind (0 bits, 1 uniform,
    # 2 bernoulli), lo, hi - lo, p, stream
    "nd_threefry": [_vp, _i64, _u32, _u32, _u64, _int, _float, _float, _float, _vp],
    # out, n, the key table row (two uint32 words in device memory), then
    # as nd_threefry
    "nd_threefry_table": [_vp, _i64, _vp, _u64, _int, _float, _float, _float, _vp],
    # stream: an empty kernel, the launch floor of device-only timings
    "nd_empty_kernel": [_vp],
}
# Queries that return a size rather than a cudaError_t.
_SIZE_QUERIES = {
    # group, T, D, heads -> score-workspace floats per query row (0: none)
    "nd_decode_attention_workspace": [_int, _int, _int, _int],
}


def sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library() -> str:
    return os.path.join(build_dir(), LIBRARY_NAME)


def build(verbose: bool = False) -> str:
    """Compile the kernels if the library is missing or stale.  Returns
    the compilers' messages (with `verbose`, ptxas's register and
    shared-memory report per kernel)."""
    with _lock:
        nvcc = _nvcc()
        out_dir, lib_path = build_dir(), library()
        command = [nvcc, *CFLAGS]
        deps = sources() + glob.glob(os.path.join(CSRC, "*.cuh"))
        if not verbose and not stale(lib_path, deps, command):
            return ""
        extra = ["-Xptxas", "-v"] if verbose else []
        objs = {src: os.path.join(out_dir, f"{os.path.basename(src)}.{os.getpid()}.o")
                for src in sources()}
        tmp = f"{lib_path}.{os.getpid()}.tmp"
        try:
            procs = [(src, subprocess.Popen(
                [nvcc, *CFLAGS, *extra, "-c", src, "-o", obj],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
                for src, obj in objs.items()]
            log, failed = [], []
            for src, proc in procs:
                out, _ = proc.communicate()
                log.append(out)
                if proc.returncode != 0:
                    failed.append(f"{os.path.basename(src)}:\n{out}")
            if failed:
                raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
            link = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", *objs.values(), "-o", tmp],
                                  capture_output=True, text=True)
            if link.returncode != 0:
                raise RuntimeError("nvcc link failed:\n" + link.stdout + link.stderr)
        finally:
            for obj in objs.values():
                if os.path.exists(obj):
                    os.unlink(obj)
        install(tmp, lib_path, command)
        return "".join(log)


def load() -> ctypes.CDLL:
    """The kernel library, built first if needed."""
    global _lib
    if _lib is None:
        build()
        lib = ctypes.CDLL(library())
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        for name, argtypes in _SIZE_QUERIES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_longlong
        lib.nd_error_string.argtypes = [ctypes.c_int]
        lib.nd_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(code: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error."""
    if code != 0:
        msg = load().nd_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
