"""FASTA/FASTQ output (the port's copy of `nanodecoder_tpu.io.fastx`):
the writers, the resume scan of an existing output and the shard merge."""

from __future__ import annotations

import os
from typing import Iterable, TextIO

import numpy as np


def _phred_char(q: float) -> str:
    """Mean per-base quality -> Phred+33 char, clamped to [0, 93]."""
    qi = int(round(q))
    return chr(33 + max(0, min(qi, 93)))


def _phred_string(quals) -> str:
    """Per-base Phred scores -> Phred+33 string (vectorized — this is
    host hot-path work, once per read in the streaming engine)."""
    q = np.asarray(quals, np.float32)
    codes = (33 + np.clip(np.rint(q), 0, 93)).astype(np.uint8)
    return codes.tobytes().decode("ascii")


def write_fasta(records: Iterable[tuple[str, str]], out: TextIO, width: int = 0) -> int:
    """records: (read_id, sequence).  width>0 wraps sequence lines."""
    n = 0
    for read_id, seq in records:
        out.write(f">{read_id}\n")
        if width and width > 0:
            for i in range(0, len(seq), width):
                out.write(seq[i : i + width] + "\n")
        else:
            out.write(seq + "\n")
        n += 1
    return n


def write_fastq(records: Iterable[tuple[str, str, object]], out: TextIO) -> int:
    """records: (read_id, sequence, quality) where quality is either a
    per-base iterable of Phred scores or one mean score for the read."""
    n = 0
    for read_id, seq, qual in records:
        if qual is None:
            qstr = _phred_char(20.0) * len(seq)
        elif isinstance(qual, (int, float)):
            qstr = _phred_char(float(qual)) * len(seq)
        else:
            qstr = _phred_string(qual)
            if len(qstr) < len(seq):  # pad if decode emitted fewer scores
                qstr = qstr + qstr[-1:] * (len(seq) - len(qstr)) if qstr else _phred_char(20.0) * len(seq)
            qstr = qstr[: len(seq)]
        out.write(f"@{read_id}\n{seq}\n+\n{qstr}\n")
        n += 1
    return n


def recover_fastx_output(path: str, fmt: str = "fastq") -> set[str]:
    """Prepare an existing FASTX output for resume-append: return the
    read ids of every COMPLETE record and truncate any partial trailing
    record (crash mid-write) so appending stays well-formed.

    The engine flushes the done log once per batch, so reads already
    written here but with unflushed ids would otherwise be basecalled
    again and appear twice: the output itself is the ground truth that
    the done log approximates."""
    if not os.path.exists(path):
        return set()
    ids: set[str] = set()
    good_end = 0
    rec_lines = 4 if fmt == "fastq" else 2
    lead = "@" if fmt == "fastq" else ">"
    with open(path, "r+") as f:
        while True:
            rec = [f.readline() for _ in range(rec_lines)]
            if not rec[0]:
                break
            if (not rec[0].startswith(lead)
                    or not all(ln.endswith("\n") for ln in rec)
                    or (fmt == "fastq" and not rec[2].startswith("+"))):
                break  # partial / malformed tail - truncate from here
            ids.add(rec[0][1:].rstrip("\n").split()[0])
            good_end = f.tell()
        f.truncate(good_end)
    return ids


def merge_fastx_shards(shard_paths: list[str], out_path: str, delete_shards: bool = False) -> None:
    """Concatenate per-host FASTX shard files, in sorted path order, into
    one output."""
    with open(out_path, "w") as out:
        for p in sorted(shard_paths):
            with open(p) as f:
                for line in f:
                    out.write(line)
    if delete_shards:
        for p in shard_paths:
            os.unlink(p)
