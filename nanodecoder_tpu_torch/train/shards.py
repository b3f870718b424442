"""Preprocessed training shards (the port's copy of
`nanodecoder_tpu.train.shards`, the same format, so either package reads
the other's shards).

Each shard is an uncompressed `.npz` of fixed-shape example arrays:
  signal      (N, chunk_len) f32      sig_lengths (N,) i32
  tgt_in      (N, T) i32              tgt_out     (N, T) i32
"""

from __future__ import annotations

import glob
import os
from typing import Iterator

import numpy as np

from nanodecoder_tpu_torch.config import Config


def write_shard(path: str, examples: list[dict[str, np.ndarray]]) -> None:
    # Uncompressed: float32 signal barely deflates, and a compressed member
    # is decompressed whole on every read.
    np.savez(path, **{k: np.stack([e[k] for e in examples]) for k in examples[0]})


def list_shards(shard_dir: str) -> list[str]:
    return sorted(glob.glob(os.path.join(shard_dir, "*.npz")))


def shard_batches(shard_dir: str, config: Config, shuffle_seed: int = 0,
                  loop: bool = True) -> Iterator[dict[str, np.ndarray]]:
    """(A, B, ...) batches cycling over the shards in name order, the
    examples of each shard pass in a shuffled order; a shard's tail that
    fills no batch is skipped."""
    paths = list_shards(shard_dir)
    if not paths:
        raise FileNotFoundError(f"no .npz shards in {shard_dir}")
    a, b = config.train.accum_steps, config.train.batch_size
    need = a * b
    rng = np.random.default_rng(shuffle_seed)
    while True:
        for p in paths:
            with np.load(p) as data:  # every member read once per pass
                arrays = {k: np.asarray(data[k]) for k in data.files}
            order = rng.permutation(arrays["signal"].shape[0])
            for start in range(0, order.shape[0] - need + 1, need):
                idx = order[start:start + need]
                yield {k: v[idx].reshape((a, b) + v.shape[1:]) for k, v in arrays.items()}
        if not loop:
            return
