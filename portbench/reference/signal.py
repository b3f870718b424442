"""The host side of basecalling, as the reference works it out again.

Plain numpy, importing nothing of the program: the per-read MAD
normalization, the overlapping chunks, the int6 host-to-device wire and
its decode (what the device sees), the k-mer vocabulary and its
expansion to bases, the midpoint-trim stitch, and the Phred qualities of
a FASTQ record.
"""

from __future__ import annotations

import itertools

import numpy as np

PAD, BOS, EOS, UNK = 0, 1, 2, 3
SPECIALS = ("<pad>", "<s>", "</s>", "<unk>")


def normalize(signal: np.ndarray, mad_scale: float, clip_sigma: float) -> np.ndarray:
    x = np.asarray(signal, dtype=np.float32)
    med = np.median(x)
    mad = np.median(np.abs(x - med))
    out = (x - med) / (mad_scale * mad + 1e-8)
    return np.clip(out, -clip_sigma, clip_sigma)


def chunk_starts(n: int, chunk_len: int, overlap: int, min_fill: float) -> list[int]:
    """Where the chunks of a signal of n samples start."""
    stride = chunk_len - overlap
    starts = [0]
    while starts[-1] + chunk_len < n:
        starts.append(starts[-1] + stride)
    if len(starts) > 1:
        new = n - (starts[-2] + chunk_len)
        if new < min_fill * chunk_len and new <= overlap:
            starts.pop()
    return starts


def chunk(signal: np.ndarray, chunk_len: int, overlap: int, min_fill: float):
    """(chunks (n, chunk_len) f32 zero-padded, lengths (n,), starts (n,))."""
    starts = chunk_starts(signal.shape[0], chunk_len, overlap, min_fill)
    chunks = np.zeros((len(starts), chunk_len), np.float32)
    lengths = np.zeros(len(starts), np.int32)
    for i, s in enumerate(starts):
        seg = signal[s:s + chunk_len]
        chunks[i, :seg.shape[0]] = seg
        lengths[i] = seg.shape[0]
    return chunks, lengths, np.asarray(starts, np.int64)


def int6_round_trip(chunks: np.ndarray) -> np.ndarray:
    """The signal the device decodes from the int6 wire: each chunk
    scaled by its max |z| to 31 steps, rounded half to even."""
    scales = np.maximum(np.abs(chunks).max(axis=1), 1e-6).astype(np.float32)
    q = np.clip(np.rint(chunks * (31.0 / scales[:, None])), -31, 31)
    return q.astype(np.float32) * (scales / np.float32(31.0))[:, None]


def kmer_tokens(k: int) -> tuple[str, ...]:
    toks = [
        "".join(p) for n in range(1, k + 1) for p in itertools.product("ACGT", repeat=n)]
    return SPECIALS + tuple(toks)


def expand(tokens: np.ndarray, itos: tuple[str, ...], *streams):
    """Tokens up to EOS -> (bases, per-base copies of each per-token
    stream); specials add no base."""
    toks = [int(t) for t in tokens]
    if EOS in toks:
        toks = toks[:toks.index(EOS)]
    seq, out = [], [[] for _ in streams]
    for i, t in enumerate(toks):
        if t in (PAD, BOS, EOS, UNK):
            continue
        seq.append(itos[t])
        for o, s in zip(out, streams):
            o.extend([s[i]] * len(itos[t]))
    return "".join(seq), [np.asarray(o) for o in out]


def _cut(n: int, valid: int, lo: float, hi: float) -> tuple[int, int]:
    if n == 0 or valid <= 0:
        return 0, 0
    a = max(0, min(int(round(n * max(lo, 0.0) / valid)), n))
    b = int(round(n * min(hi, valid) / valid))
    return a, max(a, min(b, n))


def trim_stitch(seqs: list[str], quals: list[np.ndarray], starts, lengths,
                chunk_len: int):
    """Each chunk keeps the bases of the samples up to the midpoint of its
    overlap with the next chunk, in proportion to its valid samples."""
    out_s, out_q = [], []
    k = len(seqs)
    for i in range(k):
        lo_abs = 0 if i == 0 else (starts[i] + starts[i - 1] + chunk_len) / 2.0
        hi_abs = ((starts[i + 1] + starts[i] + int(lengths[i])) / 2.0 if i < k - 1
                  else starts[i] + int(lengths[i]))
        a, b = _cut(len(seqs[i]), int(lengths[i]), lo_abs - starts[i], hi_abs - starts[i])
        out_s.append(seqs[i][a:b])
        out_q.append(np.asarray(quals[i][a:b], np.float32))
    return "".join(out_s), (np.concatenate(out_q) if out_q else np.zeros(0, np.float32))


def phred(log_probs: np.ndarray) -> np.ndarray:
    """Per-token Phred from the chosen token's log-probability, 1 to 50."""
    p = np.exp(np.minimum(log_probs, -1e-7))
    return np.clip(-10.0 * np.log10(np.maximum(1.0 - p, 1e-5)), 1.0, 50.0)
