"""The benchmark's traffic generator: simulated nanopore reads and
training examples, from the seed.

A frozen copy of the signal model the flagship was trained on (each
base a Gamma-distributed dwell of samples, 9 on average with shape 3, at
a 3-mer level from a table drawn with seed 1234, plus Gaussian noise of
0.25), written so that one read or one batch is a few numpy calls.  It
imports nothing of the program.

Reads: every seed gives the same multiset of read lengths, in another
order.  The lengths of a block of `block` reads are the quantiles of a
log-normal (median and sigma of the traffic file, clipped to its range);
block j is a permutation of them drawn from (seed, j).  Read i's bases,
dwells and noise come from its own generator, (seed, i).
"""

from __future__ import annotations

import statistics

import numpy as np

LEVEL_SEED = 1234
CONTEXT = 3
MEAN_DWELL, DWELL_SHAPE, NOISE = 9.0, 3.0, 0.25
BASES = np.frombuffer(b"ACGT", np.uint8)
PERM_STREAM = 1 << 40


def level_table() -> np.ndarray:
    rng = np.random.default_rng(LEVEL_SEED)
    return rng.normal(0.0, 1.0, size=4 ** CONTEXT).astype(np.float32)


def bases_and_dwells(rng: np.random.Generator, n_bases: int):
    """The first two draws of a read: its bases and their dwells."""
    bases = rng.integers(0, 4, size=n_bases)
    dwells = np.maximum(rng.gamma(DWELL_SHAPE, MEAN_DWELL / DWELL_SHAPE, size=n_bases),
                        1.0).astype(np.int64)
    return bases, dwells


def simulate(rng: np.random.Generator, n_bases: int, levels: np.ndarray):
    """(bases as uint8 indices, float32 signal, per-base dwells)."""
    bases, dwells = bases_and_dwells(rng, n_bases)
    padded = np.concatenate([np.full(CONTEXT - 1, bases[0]), bases])
    ctx = np.zeros(n_bases, np.int64)
    for j in range(CONTEXT):
        ctx = ctx * 4 + padded[j:j + n_bases]
    sig = np.repeat(levels[ctx], dwells)
    sig = sig + rng.normal(0.0, NOISE, size=sig.shape[0]).astype(np.float32)
    return bases.astype(np.uint8), sig.astype(np.float32), dwells


def block_lengths(reads: dict) -> np.ndarray:
    """The fixed lengths (bases) of one block of reads."""
    n = reads["block"]
    nd = statistics.NormalDist()
    z = np.array([nd.inv_cdf((i + 0.5) / n) for i in range(n)])
    lengths = reads["median_bases"] * np.exp(reads["sigma"] * z)
    return np.clip(np.rint(lengths), reads["min_bases"], reads["max_bases"]).astype(np.int64)


class ReadSource:
    """Read i of a seed's stream: its length, truth and signal."""

    def __init__(self, seed: int, reads: dict):
        self.seed = int(seed)
        self.block = int(reads["block"])
        self.lengths = block_lengths(reads)
        self.levels = level_table()
        self._perms: dict[int, np.ndarray] = {}

    def length(self, i: int) -> int:
        j = i // self.block
        if j not in self._perms:
            self._perms[j] = np.random.default_rng([self.seed, PERM_STREAM + j]).permutation(
                self.block)
        return int(self.lengths[self._perms[j][i % self.block]])

    def n_samples(self, i: int) -> int:
        """The length of read i's signal, without drawing its noise."""
        _bases, dwells = bases_and_dwells(np.random.default_rng([self.seed, i]), self.length(i))
        return int(dwells.sum())

    def read(self, i: int) -> tuple[str, np.ndarray]:
        """(truth sequence, float32 signal) of read i."""
        bases, sig, _ = simulate(np.random.default_rng([self.seed, i]), self.length(i),
                                 self.levels)
        return BASES[bases].tobytes().decode("ascii"), sig

    @staticmethod
    def read_id(i: int) -> str:
        return f"r{i:08d}"


def kmer_ids(bases: np.ndarray, k: int) -> np.ndarray:
    """Base indices -> the ids of their k-mer tokens: groups of k from the
    start, the last group possibly shorter; ids follow the specials and
    the shorter k-mers in (length, lexicographic) order."""
    n = bases.shape[0]
    offsets = np.cumsum([4] + [4 ** j for j in range(1, k + 1)])  # first id of length j+1
    full = n // k
    ids = []
    if full:
        g = bases[:full * k].reshape(full, k).astype(np.int64)
        val = np.zeros(full, np.int64)
        for j in range(k):
            val = val * 4 + g[:, j]
        ids.append(offsets[k - 1] + val)
    rest = n - full * k
    if rest:
        val = 0
        for b in bases[full * k:]:
            val = val * 4 + int(b)
        ids.append(np.array([offsets[rest - 1] + val], np.int64))
    return np.concatenate(ids) if ids else np.zeros(0, np.int64)


def train_batch(seed: int, step: int, batch: int, chunk_len: int, tmax: int, k: int,
                levels: np.ndarray, scfg: dict) -> dict[str, np.ndarray]:
    """Batch `step` of a seed: `batch` windows of chunk_len samples (one in
    ten a shorter window, zero-padded) cut from simulated reads and
    normalized, with the bases whose dwell midpoint lies in the window as
    k-mer targets (at most tmax - 1 tokens, then EOS, PAD after)."""
    rng = np.random.default_rng([seed, step])
    signal = np.zeros((batch, chunk_len), np.float32)
    sig_len = np.zeros(batch, np.int32)
    tgt_in = np.zeros((batch, tmax), np.int32)
    tgt_out = np.zeros((batch, tmax), np.int32)
    for r in range(batch):
        short = rng.random() < 0.1
        window = int(rng.integers(chunk_len // 8, chunk_len)) if short else chunk_len
        n_bases = int(window / MEAN_DWELL * 1.6) + 8
        bases, sig, dwells = simulate(rng, n_bases, levels)
        start = int(rng.integers(0, max(sig.shape[0] - window, 0) + 1))
        sig = sig[start:start + window]
        n = sig.shape[0]
        mids = np.cumsum(dwells) - dwells / 2.0
        label = bases[(mids >= start) & (mids < start + n)]
        med = np.median(sig)
        mad = np.median(np.abs(sig - med))
        z = (sig - med) / (scfg["mad_scale"] * mad + 1e-8)
        signal[r, :n] = np.clip(z, -scfg["clip_sigma"], scfg["clip_sigma"])
        sig_len[r] = n
        ids = kmer_ids(label, k)[:tmax - 1]
        tgt_in[r, 0] = 1
        tgt_in[r, 1:ids.shape[0] + 1] = ids
        tgt_out[r, :ids.shape[0]] = ids
        tgt_out[r, ids.shape[0]] = 2
    return {"signal": signal, "sig_lengths": sig_len, "tgt_in": tgt_in, "tgt_out": tgt_out}
