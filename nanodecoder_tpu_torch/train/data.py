"""Synthetic nanopore signal simulator (the port's copy of the simulator
in `nanodecoder_tpu.train.data`, numpy only and bit-identical for the
same generator state).

Each base emits a Gamma-distributed dwell of samples at a 3-mer
context-dependent current level plus Gaussian noise.
"""

from __future__ import annotations

import dataclasses

import numpy as np

@dataclasses.dataclass
class SimSpec:
    """Nanopore-ish signal model: 3-mer context current levels."""

    mean_dwell: float = 9.0      # samples per base
    dwell_shape: float = 3.0     # gamma shape (dwell jitter)
    noise_sigma: float = 0.25    # gaussian current noise
    context: int = 3             # k-mer size driving the level table
    seed: int = 1234

    def level_table(self) -> np.ndarray:
        """(4**context,) current levels in 'normalized pA', fixed by seed."""
        rng = np.random.default_rng(self.seed)
        return rng.normal(0.0, 1.0, size=4 ** self.context).astype(np.float32)


def simulate_read_with_dwells(
    rng: np.random.Generator,
    n_bases: int,
    spec: SimSpec,
    levels: np.ndarray | None = None,
) -> tuple[str, np.ndarray, np.ndarray]:
    """Random DNA -> (sequence, float32 signal, per-base dwell counts)."""
    if levels is None:
        levels = spec.level_table()
    bases = rng.integers(0, 4, size=n_bases)
    k = spec.context
    # Context index of base i: bases[i-k+1..i] as a base-4 number (edges clamp).
    padded = np.concatenate([np.full(k - 1, bases[0]), bases])
    ctx_idx = np.zeros(n_bases, np.int64)
    for j in range(k):
        ctx_idx = ctx_idx * 4 + padded[j : j + n_bases]
    dwells = np.maximum(
        rng.gamma(spec.dwell_shape, spec.mean_dwell / spec.dwell_shape, size=n_bases),
        1.0,
    ).astype(np.int64)
    sig = np.repeat(levels[ctx_idx], dwells)
    sig = sig + rng.normal(0.0, spec.noise_sigma, size=sig.shape[0]).astype(np.float32)
    seq = "".join("ACGT"[b] for b in bases)
    return seq, sig.astype(np.float32), dwells


def simulate_read(
    rng: np.random.Generator,
    n_bases: int,
    spec: SimSpec,
    levels: np.ndarray | None = None,
) -> tuple[str, np.ndarray]:
    """Random DNA -> (sequence, float32 signal) under the simulator."""
    seq, sig, _ = simulate_read_with_dwells(rng, n_bases, spec, levels)
    return seq, sig
