"""Preprocess CLI: build training shards (the port's counterpart of
`nanodecoder_tpu.cli.preprocess`; for the same arguments it writes the
same shard files, byte for byte).

    python -m nanodecoder_tpu_torch.cli.preprocess --out shards/ --synthetic 50000

Two sources, which may be combined:
  --synthetic N      N simulator examples from --seed;
  --labels file.tsv  labeled reads, one `fast5_path<TAB>read_id<TAB>sequence`
                     per line: each read is normalized and chunked as the
                     basecaller chunks it, and each chunk takes the slice of
                     the sequence in proportion to its place in the read.
Writes shard_00000.npz, ... of --shard-size examples each (see
train.shards) and the config.json used.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from nanodecoder_tpu_torch.config import Config
from nanodecoder_tpu_torch.io.fast5 import read_fast5_file
from nanodecoder_tpu_torch.io.signal import chunk_signal, normalize_signal
from nanodecoder_tpu_torch.train.data import SimSpec, make_example, pack_targets
from nanodecoder_tpu_torch.train.shards import write_shard
from nanodecoder_tpu_torch.utils.logging import get_logger
from nanodecoder_tpu_torch.vocab import make_vocab


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="Build training shards")
    ap.add_argument("--out", required=True, help="output shard directory")
    ap.add_argument("--config", default="", help="JSON config (default: flagship)")
    ap.add_argument("--synthetic", type=int, default=0, help="simulator examples")
    ap.add_argument("--labels", default="", help="TSV: fast5_path<TAB>read_id<TAB>sequence")
    ap.add_argument("--shard-size", type=int, default=4096)
    ap.add_argument("--seed", type=int, default=0)
    return ap


def _real_examples(labels_tsv: str, config: Config) -> list[dict]:
    scfg, tmax = config.signal, config.model.max_decode_len
    by_file: dict[str, dict[str, str]] = {}
    with open(labels_tsv) as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if len(parts) == 3:
                path, rid, seq = parts
                by_file.setdefault(path, {})[rid] = seq
    vocab = make_vocab(config.model.kmer_k)
    out = []
    for path, wanted in by_file.items():
        for read in read_fast5_file(path):
            seq = wanted.get(read.read_id)
            if seq is None:
                continue
            norm = normalize_signal(read.signal, scfg.normalization, scfg.mad_scale,
                                    scfg.clip_sigma)
            cb = chunk_signal(norm, scfg.chunk_len, scfg.chunk_overlap,
                              scfg.min_chunk_fill)
            n = norm.shape[0]
            for i in range(cb.n_chunks):
                s, l = int(cb.starts[i]), int(cb.lengths[i])
                lo = int(round(len(seq) * s / n))
                hi = int(round(len(seq) * (s + l) / n))
                tgt_in, tgt_out = pack_targets(vocab.encode(seq[lo:hi])[:tmax - 1], tmax)
                out.append({"signal": cb.chunks[i], "sig_lengths": np.int32(l),
                            "tgt_in": tgt_in, "tgt_out": tgt_out})
    return out


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    log = get_logger("preprocess")
    config = Config()
    if args.config:
        with open(args.config) as f:
            config = Config.from_json(f.read())
    os.makedirs(args.out, exist_ok=True)
    examples: list[dict] = []
    if args.labels:
        examples.extend(_real_examples(args.labels, config))
        log.info("built %d examples from labeled reads", len(examples))
    if args.synthetic:
        rng = np.random.default_rng(args.seed)
        spec = SimSpec()
        levels = spec.level_table()
        examples.extend(make_example(rng, config, spec, levels)
                        for _ in range(args.synthetic))
        log.info("built %d total examples (incl. synthetic)", len(examples))
    if not examples:
        log.error("nothing to preprocess: pass --synthetic and/or --labels")
        return 2
    for si in range(0, len(examples), args.shard_size):
        shard = examples[si:si + args.shard_size]
        path = os.path.join(args.out, f"shard_{si // args.shard_size:05d}.npz")
        write_shard(path, shard)
        log.info("wrote %s (%d examples)", path, len(shard))
    with open(os.path.join(args.out, "config.json"), "w") as f:
        f.write(config.to_json())
    return 0


if __name__ == "__main__":
    sys.exit(main())
