"""Per-read finishing: token ids -> bases with per-base Phred qualities,
the read's chunks stitched back together, and its FASTA/FASTQ record.

Shared by `Translator.basecall_read` and the streaming engine, which runs
`_finish_read_task` in its process pool.  The module imports numpy and
the port's numpy-only host modules (vocab, stitch, fastx), never torch,
and its task's arguments are plain arrays and numbers, so a pool worker
that unpickles a task imports nothing heavier.
"""

from __future__ import annotations

import io

import numpy as np

from nanodecoder_tpu_torch.io.fastx import write_fastq
from nanodecoder_tpu_torch.io.stitch import stitch_chunks, stitch_chunks_attn
from nanodecoder_tpu_torch.vocab import Vocab, make_vocab


def _phred_from_log_probs(token_lps: np.ndarray) -> np.ndarray:
    """Per-token Phred score from chosen-token log-probs:
    q = -10 * log10(1 - p), clamped to [1, 50]."""
    p = np.exp(np.minimum(token_lps, -1e-7))
    q = -10.0 * np.log10(np.maximum(1.0 - p, 1e-5))
    return np.clip(q, 1.0, 50.0)


def stitch_read(parts, starts: np.ndarray, lengths: np.ndarray, chunk_len: int,
                chunk_overlap: int, stitch_method: str, vocab: Vocab):
    """parts: [(tokens, n_tokens, log_probs, sample_positions), ...] of a
    read's chunks in order.  Expands each chunk's tokens to bases (the
    per-token streams repeated per base, so k-mer tokens stay aligned),
    and stitches the chunks: (sequence, per-base Phred array)."""
    seqs, quals, positions = [], [], []
    for toks, tlen, lps, pos in parts:
        seq_c, pos_c, lp_c = vocab.decode_expand(toks[:tlen], pos[:tlen], lps[:tlen])
        seqs.append(seq_c)
        quals.append(_phred_from_log_probs(lp_c))
        positions.append(pos_c)
    if stitch_method == "attn":
        return stitch_chunks_attn(seqs, positions, starts, lengths, quals=quals)
    return stitch_chunks(seqs, starts, lengths, chunk_len, chunk_overlap,
                         method=stitch_method, quals=quals)


def _finish_read_task(read_id: str, parts, starts: np.ndarray, lengths: np.ndarray,
                      chunk_len: int, chunk_overlap: int, stitch_method: str,
                      kmer_k: int, write_format: str) -> tuple[str, int]:
    """One read's finishing as the engine's pool runs it: the formatted
    FASTQ or FASTA record and its number of bases.  Inputs are a few KB
    of token arrays and the chunks' starts and lengths."""
    seq, qual = stitch_read(parts, starts, lengths, chunk_len, chunk_overlap,
                            stitch_method, make_vocab(kmer_k))
    if write_format == "fastq":
        buf = io.StringIO()
        write_fastq([(read_id, seq, qual)], buf)
        record = buf.getvalue()
    else:
        record = f">{read_id}\n{seq}\n"
    return record, len(seq)
