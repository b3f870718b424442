"""Chunk -> read stitching (the port's copy of `nanodecoder_tpu.io.stitch`).

  "trim":  cut each chunk's basecall at the overlap midpoint,
           proportionally in base space (default).
  "align": pick the best suffix/prefix overlap of adjacent basecalls
           and splice at it (the native scorer where the host library
           loads, else numpy).
  "attn":  keep each base in the chunk that owns the sample position
           its cross-attention peaked at.

Host-side numpy/python and the native host library: stitching is
post-processing, not device work.
"""

from __future__ import annotations

import numpy as np

from nanodecoder_tpu_torch import native


def _cut_indices(n: int, valid_samples: int, lo_sample: float, hi_sample: float) -> tuple[int, int]:
    """Base-index range [lo, hi) of an n-base call covering samples
    [lo_sample, hi_sample) of the chunk, assuming bases are uniformly
    distributed over the chunk's valid samples."""
    if n == 0 or valid_samples <= 0:
        return 0, 0
    lo = int(round(n * max(lo_sample, 0.0) / valid_samples))
    hi = int(round(n * min(hi_sample, valid_samples) / valid_samples))
    lo = max(0, min(lo, n))
    hi = max(lo, min(hi, n))
    return lo, hi


def _trim_spans(seqs: list[str], starts: np.ndarray, lengths: np.ndarray,
                chunk_len: int) -> list[tuple[int, int, int]]:
    """Midpoint-trim stitch as (chunk_idx, lo, hi) base spans: chunk i
    owns samples up to the midpoint of its overlap with chunk i+1;
    chunk i+1 owns the rest."""
    k = len(seqs)
    spans: list[tuple[int, int, int]] = []
    for i in range(k):
        lo_abs = 0 if i == 0 else (starts[i] + starts[i - 1] + chunk_len) / 2.0
        # Midpoint of overlap with next chunk (overlap = starts[i]+len - starts[i+1])
        if i < k - 1:
            hi_abs = (starts[i + 1] + starts[i] + int(lengths[i])) / 2.0
        else:
            hi_abs = starts[i] + int(lengths[i])
        lo, hi = _cut_indices(len(seqs[i]), int(lengths[i]),
                              lo_abs - starts[i], hi_abs - starts[i])
        spans.append((i, lo, hi))
    return spans


def _best_overlap_len(left: str, right: str, max_k: int) -> int:
    """Best overlap length k such that left[-k:] matches right[:k]: the
    native scorer where the host library loads, else
    `_best_overlap_len_plain`."""
    max_k = min(max_k, len(left), len(right))
    if max_k <= 0:
        return 0
    k = native.best_overlap_len_native(left.encode(), right.encode(), max_k)
    return _best_overlap_len_plain(left, right, max_k) if k is None else k


def _best_overlap_len_plain(left: str, right: str, max_k: int) -> int:
    """Best overlap length k such that left[-k:] matches right[:k].

    Scores every k in [0, max_k] by (matches - mismatches) of the
    Hamming comparison between the k-suffix of `left` and the k-prefix
    of `right` and returns the argmax.  For random DNA a wrong k scores
    ~-k/2 in expectation while the true overlap scores ~+k, so the true
    overlap dominates; k=0 (plain concatenation) is always a candidate.
    A per-k numpy compare, the plain version of the native scorer.
    """
    max_k = min(max_k, len(left), len(right))
    if max_k <= 0:
        return 0
    lbuf = np.frombuffer(left[-max_k:].encode(), dtype=np.uint8)
    rbuf = np.frombuffer(right[:max_k].encode(), dtype=np.uint8)
    best_k, best_score = 0, 0.0
    for k in range(1, max_k + 1):
        eq = int(np.count_nonzero(lbuf[max_k - k :] == rbuf[:k]))
        score = 2 * eq - k
        if score > best_score:
            best_k, best_score = k, score
    return best_k


def _align_spans(
    seqs: list[str], starts: np.ndarray, lengths: np.ndarray, chunk_len: int, overlap: int
) -> list[tuple[int, int, int]]:
    """Overlap-alignment stitch as (chunk_idx, lo, hi) base spans."""
    spans = [(0, 0, len(seqs[0]))] if seqs else []
    for i in range(1, len(seqs)):
        left, right = seqs[i - 1], seqs[i]
        if not right:
            continue
        if not spans or (spans[-1][2] <= spans[-1][1] and len(spans) == 1):
            spans = [(i, 0, len(right))]
            continue
        ov_samples = max(0, int(starts[i - 1]) + int(lengths[i - 1]) - int(starts[i]))
        if ov_samples == 0 or not left:
            spans.append((i, 0, len(right)))
            continue
        # Expected overlap in bases from each chunk's base density; scan
        # up to 2x the larger estimate (+ slack for density variation).
        obl = len(left) * ov_samples / max(int(lengths[i - 1]), 1)
        obr = len(right) * ov_samples / max(int(lengths[i]), 1)
        max_k = int(2 * max(obl, obr)) + 8
        k = _best_overlap_len(left, right, max_k)
        if k == 0:
            spans.append((i, 0, len(right)))
            continue
        # Trim half the duplicated region from each side of the junction.
        h = k // 2
        trim_left = k - h
        pi, plo, phi = spans[-1]
        spans[-1] = (pi, plo, max(phi - trim_left, plo))
        spans.append((i, h, len(right)))
    return spans


def _emit(seqs, spans, quals):
    """Materialize (chunk_idx, lo, hi) spans into the stitched sequence
    (and the identically-stitched per-base quality array when `quals`
    per-chunk arrays are given)."""
    seq = "".join(seqs[i][lo:hi] for i, lo, hi in spans)
    if quals is None:
        return seq
    parts = [np.asarray(quals[i][lo:hi], np.float32) for i, lo, hi in spans]
    qual = np.concatenate(parts) if parts else np.zeros(0, np.float32)
    return seq, qual


def stitch_chunks_attn(
    seqs: list[str],
    positions: list[np.ndarray],
    starts: np.ndarray,
    lengths: np.ndarray,
    quals: list[np.ndarray] | None = None,
):
    """Attention-aligned stitch: each decoded base carries the sample
    position its cross-attention peaked at (decode/greedy attn_pos,
    scaled to samples); a base belongs to the chunk whose "owned"
    sample range — overlap midpoints, as in the trim rule — contains
    its aligned position.  Exact where the proportional trim rule only
    approximates, because the model itself supplies the base<->sample
    alignment (reference analog: attention maps surfaced through the
    translation builder, SURVEY.md §2.1).

    With `quals` (per-chunk per-base arrays) returns (seq, qual) where
    qual went through the identical base selection; otherwise just seq.
    """
    k = len(seqs)
    if k == 0:
        return ("", np.zeros(0, np.float32)) if quals is not None else ""
    if k == 1:
        if quals is not None:
            return seqs[0], np.asarray(quals[0][: len(seqs[0])], np.float32)
        return seqs[0]
    pieces: list[str] = []
    qpieces: list[np.ndarray] = []
    for i in range(k):
        lo_abs = -1e18 if i == 0 else (starts[i] + starts[i - 1] + int(lengths[i - 1])) / 2.0
        hi_abs = (
            (starts[i + 1] + starts[i] + int(lengths[i])) / 2.0
            if i < k - 1
            else 1e18
        )
        abs_pos = starts[i] + np.asarray(positions[i][: len(seqs[i])], np.float64)
        keep = (abs_pos >= lo_abs) & (abs_pos < hi_abs)
        pieces.append("".join(c for c, m in zip(seqs[i], keep) if m))
        if quals is not None:
            qpieces.append(np.asarray(quals[i][: len(seqs[i])], np.float32)[keep])
    seq = "".join(pieces)
    if quals is not None:
        qual = np.concatenate(qpieces) if qpieces else np.zeros(0, np.float32)
        return seq, qual
    return seq


def stitch_chunks(
    seqs: list[str],
    starts: np.ndarray,
    lengths: np.ndarray,
    chunk_len: int,
    chunk_overlap: int,
    method: str = "trim",
    quals: list[np.ndarray] | None = None,
):
    """Merge per-chunk basecalls into one read sequence.

    seqs[i] is the basecall of the chunk starting at sample starts[i]
    with lengths[i] valid samples.  A single chunk returns unchanged.
    With `quals` (per-chunk per-base arrays) returns (seq, qual) where
    the quality array went through the identical base selection;
    otherwise just the sequence string.
    """
    if len(seqs) == 0:
        return ("", np.zeros(0, np.float32)) if quals is not None else ""
    if len(seqs) == 1:
        if quals is not None:
            return seqs[0], np.asarray(quals[0], np.float32)
        return seqs[0]
    starts = np.asarray(starts)
    lengths = np.asarray(lengths)
    if method == "trim":
        spans = _trim_spans(list(seqs), starts, lengths, chunk_len)
    elif method == "align":
        spans = _align_spans(list(seqs), starts, lengths, chunk_len, chunk_overlap)
    else:
        raise ValueError(f"unknown stitch method {method!r}")
    return _emit(seqs, spans, quals)
