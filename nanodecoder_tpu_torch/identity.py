"""Read identity: 1 - edit_distance(called, truth) / len(truth).

A banded Levenshtein distance: row i keeps the columns within `band` of
the diagonal i*m/n, and the band doubles until the distance fits inside
it (then the banded optimum is the true optimum).  The band runs in the
native host library (`native/overlap.cpp`) where it loads; the numpy
version here (`edit_distance_plain`, `read_identity_plain`) is its plain
fallback and the reference the tests hold it to.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

from nanodecoder_tpu_torch import native

_INF = 1 << 40


def _banded(a: np.ndarray, b: np.ndarray, band: int) -> int:
    """Banded edit distance of byte arrays a (n) and b (m), or -1 when
    the end cell falls outside the band."""
    n, m = a.shape[0], b.shape[0]
    width = 2 * band + 1
    ks = np.arange(width)
    pad = np.full(width, _INF, np.int64)

    def cols(center):
        j = center - band + ks
        return j, (j >= 0) & (j <= m)

    prev_center = 0
    j, ok = cols(0)
    prev = np.where(ok, j, _INF).astype(np.int64)
    for i in range(1, n + 1):
        center = i * m // n
        shift = center - prev_center
        j, ok = cols(center)
        # prev row re-indexed to this row's columns: up = D[i-1][j],
        # diag = D[i-1][j-1].
        ext = np.concatenate([pad, prev, pad])
        up = ext[width + ks + shift]
        diag = ext[width + ks + shift - 1]
        bj = b[np.clip(j - 1, 0, max(m - 1, 0))] if m else np.zeros(width, np.uint8)
        cost = (bj != a[i - 1]).astype(np.int64)
        sub = np.minimum(up + 1, np.where(j >= 1, diag + cost, _INF))
        sub = np.where(ok, np.minimum(sub, _INF), _INF)
        # Insertions run left to right: D[i][j] = min_k<=j sub[k] + (j - k).
        cur = np.minimum.accumulate(sub - ks) + ks
        prev = np.where(ok & (cur < _INF // 2), cur, _INF)
        prev_center = center
    k = m - prev_center + band
    if k < 0 or k >= width or prev[k] >= _INF:
        return -1
    return int(prev[k])


def _widened(a: str, b: str, band: int | None,
             banded: Callable[[bytes, bytes, int], int]) -> int:
    """The distance by `banded`, the band doubled until it covers the
    optimum."""
    n, m = len(a), len(b)
    if n == 0 or m == 0:
        return n or m
    ab, bb = a.encode(), b.encode()
    band = band or max(16, abs(n - m) + 8)
    while True:
        d = banded(ab, bb, band)
        if 0 <= d <= band or band >= max(n, m):
            return d if d >= 0 else max(n, m)
        band *= 2


def _banded_numpy(a: bytes, b: bytes, band: int) -> int:
    return _banded(np.frombuffer(a, np.uint8), np.frombuffer(b, np.uint8), band)


def edit_distance_plain(a: str, b: str, band: int | None = None) -> int:
    """Levenshtein distance in numpy."""
    return _widened(a, b, band, _banded_numpy)


def edit_distance(a: str, b: str, band: int | None = None) -> int:
    """Levenshtein distance: the native band where the library loads, else
    `edit_distance_plain`."""
    if native.load() is None:
        return edit_distance_plain(a, b, band)
    return _widened(a, b, band, native.banded_edit_distance_native)


def _identity(called: str, truth: str, distance: Callable[[str, str], int]) -> float:
    if not truth:
        return 1.0 if not called else 0.0
    return max(0.0, 1.0 - distance(called, truth) / len(truth))


def read_identity(called: str, truth: str) -> float:
    """1 - edit_distance/len(truth), floored at 0."""
    return _identity(called, truth, edit_distance)


def read_identity_plain(called: str, truth: str) -> float:
    """`read_identity` by `edit_distance_plain`."""
    return _identity(called, truth, edit_distance_plain)
