"""Read identity, 1 - edit distance / truth length, floored at 0.

The banded Levenshtein distance of `native/identity.cpp` (a frozen copy
of the program's), built with g++ at its first use into the benchmark's
build directory, `portbench/_build/`, and rebuilt only when the source is
newer.  The band starts at max(16, |n - m| + 8) and doubles until the
distance fits inside it.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(HERE, "native", "identity.cpp")
BUILD = os.path.join(HERE, "_build")
LIBRARY = os.path.join(BUILD, "libportbench_identity.so")


def load() -> ctypes.CDLL:
    if not os.path.exists(LIBRARY) or os.path.getmtime(LIBRARY) < os.path.getmtime(SOURCE):
        os.makedirs(BUILD, exist_ok=True)
        tmp = f"{LIBRARY}.{os.getpid()}.tmp"
        subprocess.run(["g++", "-O3", "-shared", "-fPIC", SOURCE, "-o", tmp], check=True,
                       capture_output=True, text=True, timeout=300)
        os.replace(tmp, LIBRARY)
    lib = ctypes.CDLL(LIBRARY)
    lib.banded_edit_distance.restype = ctypes.c_int
    lib.banded_edit_distance.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p,
                                         ctypes.c_int, ctypes.c_int]
    return lib


class Identity:
    def __init__(self):
        self._lib = load()

    def distance(self, a: str, b: str) -> int:
        n, m = len(a), len(b)
        if n == 0 or m == 0:
            return n or m
        ab, bb = a.encode(), b.encode()
        band = max(16, abs(n - m) + 8)
        while True:
            d = self._lib.banded_edit_distance(ab, n, bb, m, band)
            if 0 <= d <= band or band >= max(n, m):
                return d if d >= 0 else max(n, m)
            band *= 2

    def __call__(self, called: str, truth: str) -> float:
        if not truth:
            return 1.0 if not called else 0.0
        return max(0.0, 1.0 - self.distance(called, truth) / len(truth))
