"""Target vocabulary for basecalling (the port's copy of
`nanodecoder_tpu.vocab`; numpy only, identical ids and tables).

Id layout is static and k-invariant for the specials:

    0 <pad>   1 <s>(BOS)   2 </s>(EOS)   3 <unk>   4.. base tokens

For k>1 the base tokens are all strings over ACGT of length 1..k in
(length, lexicographic) order.
"""

from __future__ import annotations

import dataclasses
import functools
import itertools

import numpy as np

PAD_ID = 0
BOS_ID = 1
EOS_ID = 2
UNK_ID = 3
BASES = "ACGT"
_SPECIALS = ("<pad>", "<s>", "</s>", "<unk>")


def vocab_size_for(k: int) -> int:
    """Vocab size for k-mer tokenization: specials + all 1..k-mers."""
    if k < 1:
        raise ValueError(f"kmer k must be >= 1, got {k}")
    return len(_SPECIALS) + sum(4 ** i for i in range(1, k + 1))


@dataclasses.dataclass(frozen=True)
class Vocab:
    """Static token<->id mapping for the basecaller target side."""

    itos: tuple[str, ...] = _SPECIALS + ("A", "C", "G", "T")
    kmer: int = 1

    @property
    def size(self) -> int:
        return len(self.itos)

    @functools.cached_property
    def stoi(self) -> dict[str, int]:
        return {s: i for i, s in enumerate(self.itos)}

    @functools.cached_property
    def _base_lens(self) -> np.ndarray:
        """Bases emitted per token id (0 for specials)."""
        return np.asarray(
            [0 if s in _SPECIALS else len(s) for s in self.itos], np.int64
        )

    @functools.cached_property
    def _byte_table(self) -> np.ndarray:
        """(V, kmer) uint8 ASCII bytes per token, 0-padded — lets
        decode_expand build the base string with one numpy gather
        instead of a per-token Python join (engine host hot path)."""
        table = np.zeros((len(self.itos), max(self.kmer, 1)), np.uint8)
        for i, s in enumerate(self.itos):
            if s in _SPECIALS:
                continue
            table[i, : len(s)] = np.frombuffer(s.encode("ascii"), np.uint8)
        return table

    def encode(self, seq: str, add_bos: bool = False, add_eos: bool = False) -> np.ndarray:
        """Base string -> int32 ids.

        k=1: one id per character.  k>1: greedy non-overlapping groups
        of k characters; the final group may be shorter (still a real
        token).  Any group containing a non-ACGT character -> <unk>.
        """
        table = self.stoi
        seq = seq.upper()
        k = self.kmer
        if k == 1:
            ids = [table.get(c, UNK_ID) for c in seq]
        else:
            ids = [table.get(seq[i : i + k], UNK_ID) for i in range(0, len(seq), k)]
        if add_bos:
            ids = [BOS_ID] + ids
        if add_eos:
            ids = ids + [EOS_ID]
        return np.asarray(ids, dtype=np.int32)

    def decode_tokens(self, ids) -> list[str]:
        """Int ids -> list of base-token strings.  Stops at EOS; skips
        PAD/BOS/UNK (UNK contributes no bases, like the reference's
        TranslationBuilder dropping <unk> for a 4-letter alphabet)."""
        out = []
        for i in np.asarray(ids).reshape(-1):
            i = int(i)
            if i == EOS_ID:
                break
            if i in (PAD_ID, BOS_ID, UNK_ID):
                continue
            out.append(self.itos[i])
        return out

    def decode(self, ids) -> str:
        """Int ids -> base string.  Stops at EOS; skips PAD/BOS/UNK."""
        return "".join(self.decode_tokens(ids))

    def decode_expand(self, ids, *streams):
        """ids + parallel per-token streams -> (seq, *per-base arrays).

        Each stream value is repeated len(token) times so downstream
        per-base consumers (attention-aligned stitching positions,
        Phred qualities) stay aligned with the base string when tokens
        are multi-base k-mers.  Stops at EOS, skips specials (they
        contribute zero bases).
        """
        flat_ids = np.asarray(ids).reshape(-1)
        eos = np.flatnonzero(flat_ids == EOS_ID)
        if eos.size:
            flat_ids = flat_ids[: eos[0]]
        lens = self._base_lens[flat_ids]
        keep = np.flatnonzero(lens > 0)  # drops PAD/BOS/UNK (0 bases)
        kept_ids = flat_ids[keep]
        kept_lens = lens[keep]
        # Base string via the byte table: gather (N, k) bytes, drop the
        # zero padding, decode once (no per-token Python loop).
        raw = self._byte_table[kept_ids].reshape(-1)
        seq = raw[raw != 0].tobytes().decode("ascii")
        # Per-token streams expand per base via np.repeat (host hot
        # path: runs once per chunk in the streaming engine).
        expanded = tuple(
            np.repeat(np.asarray(s).reshape(-1)[: flat_ids.shape[0]][keep], kept_lens)
            for s in streams
        )
        return (seq,) + expanded


@functools.lru_cache(maxsize=None)
def make_vocab(k: int = 1) -> Vocab:
    """The k-mer vocab: specials + all ACGT strings of length 1..k."""
    if k < 1:
        raise ValueError(f"kmer k must be >= 1, got {k}")
    toks: list[str] = []
    for n in range(1, k + 1):
        toks.extend("".join(p) for p in itertools.product(BASES, repeat=n))
    return Vocab(itos=_SPECIALS + tuple(toks), kmer=k)


DNA_VOCAB = make_vocab(1)
