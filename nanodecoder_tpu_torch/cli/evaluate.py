"""Accuracy evaluation: read identity of basecalls against ground truth.

Two modes:
  1. File mode: compare a called FASTA/FASTQ with a truth TSV
     (read_id<TAB>sequence):
       python -m nanodecoder_tpu_torch.cli.evaluate --called out.fastq --truth truth.tsv
  2. Simulator mode: simulate reads, basecall them with a checkpoint and
     report their identity to the simulator's truth:
       python -m nanodecoder_tpu_torch.cli.evaluate \
           --ckpt bench_results/flagship_params.npz --simulate 20 [--beam 5] [--json]

Identity = 1 - edit_distance(called, truth) / len(truth).  Simulator mode
runs on the CUDA card unless --cpu is given.  --pallas / --no-pallas set
model.use_pallas and decode.use_pallas (the kernel route or the plain
PyTorch one); by default the kernel route on the card, the plain one with
--cpu, as the JAX package's CLI takes its kernels on an accelerator only.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import sys

import numpy as np


def _read_fastx(path: str) -> dict[str, str]:
    out: dict[str, str] = {}
    with open(path) as f:
        lines = f.read().splitlines()
    i = 0
    while i < len(lines):
        line = lines[i]
        if line.startswith("@"):  # fastq record
            out[line[1:].split()[0]] = lines[i + 1]
            i += 4
        elif line.startswith(">"):
            rid = line[1:].split()[0]
            seq = []
            i += 1
            while i < len(lines) and not lines[i].startswith((">", "@")):
                seq.append(lines[i])
                i += 1
            out[rid] = "".join(seq)
        else:
            i += 1
    return out


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="Basecall accuracy evaluation")
    ap.add_argument("--called", default="", help="called FASTA/FASTQ")
    ap.add_argument("--truth", default="", help="truth TSV: read_id<TAB>sequence")
    ap.add_argument("--ckpt", default="",
                    help="params .npz (config.json beside it) or a checkpoint "
                         "directory of cli.train, the port's or the JAX package's "
                         "(orbax; read without JAX), for simulator mode")
    ap.add_argument("--simulate", type=int, default=0, help="simulate N reads")
    ap.add_argument("--read-bases", type=int, default=3000)
    ap.add_argument("--beam", type=int, default=0, help="beam size (0 = greedy)")
    ap.add_argument("--stitch", choices=["trim", "align", "attn"], default="attn")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    ap.add_argument("--dtype", default="",
                    help="model compute dtype (default bfloat16, the served mode)")
    ap.add_argument("--batch", type=int, default=0, help="override decode batch_chunks")
    ap.add_argument("--pallas", action=argparse.BooleanOptionalAction, default=None,
                    help="the kernel route (model.use_pallas and decode.use_pallas; "
                         "default: on with the CUDA card, off with --cpu)")
    ap.add_argument("--staged", action="store_true", help="staged decode-cache growth")
    ap.add_argument("--h2d", default="",
                    choices=["", "float32", "float16", "int8", "int6", "int4"],
                    help="signal H2D wire dtype override")
    ap.add_argument("--int8-cross", action="store_true",
                    help="int8 cross-K/V decode caches")
    ap.add_argument("--json", action="store_true", help="emit one JSON line")
    return ap


def _simulated_pairs(args, log) -> list[tuple[str, str, str]]:
    from nanodecoder_tpu_torch.cli.common import load_params_and_config
    from nanodecoder_tpu_torch.decode.translator import Translator
    from nanodecoder_tpu_torch.device import resolve_device
    from nanodecoder_tpu_torch.io.fast5 import RawRead
    from nanodecoder_tpu_torch.train.data import SimSpec, simulate_read

    device = resolve_device("cpu" if args.cpu else "cuda")
    params, config = load_params_and_config(args.ckpt, device)
    use_pallas = device.type == "cuda" if args.pallas is None else args.pallas
    # The served mode (bf16) by default; --dtype float32 is the parity mode.
    model = dataclasses.replace(config.model, compute_dtype=args.dtype or "bfloat16",
                                staged_decode=config.model.staged_decode or args.staged,
                                cross_cache_int8=config.model.cross_cache_int8
                                or args.int8_cross, use_pallas=use_pallas)
    decode = dataclasses.replace(config.decode, use_pallas=use_pallas)
    if args.batch:
        decode = dataclasses.replace(decode, batch_chunks=args.batch)
    if args.beam > 0:
        decode = dataclasses.replace(decode, mode="beam", beam_size=args.beam)
    if args.h2d:
        decode = dataclasses.replace(decode, h2d_dtype=args.h2d)
    tr = Translator(params, dataclasses.replace(config, model=model, decode=decode),
                    device=device)
    log.info("simulating %d reads on %s (%s)", args.simulate, device, decode.mode)
    spec = SimSpec()
    levels = spec.level_table()
    rng = np.random.default_rng(args.seed)
    pairs = []
    for i in range(args.simulate):
        truth, sig = simulate_read(rng, args.read_bases, spec, levels)
        bc = tr.basecall_read(RawRead(f"sim{i}", sig, "sim"), stitch_method=args.stitch)
        pairs.append((f"sim{i}", bc.sequence, truth))
    return pairs


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    logging.basicConfig(level=logging.INFO, stream=sys.stderr,
                        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    log = logging.getLogger("evaluate")
    from nanodecoder_tpu_torch.identity import read_identity

    if args.simulate:
        pairs = _simulated_pairs(args, log)
    else:
        if not (args.called and args.truth):
            log.error("need --called+--truth or --ckpt+--simulate")
            return 2
        called = _read_fastx(args.called)
        truth = {}
        with open(args.truth) as f:
            for line in f:
                parts = line.rstrip("\n").split("\t")
                if len(parts) == 2:
                    truth[parts[0]] = parts[1]
        pairs = [(rid, called.get(rid, ""), t) for rid, t in truth.items()]

    idents, len_ratios = [], []
    for rid, called_seq, truth_seq in pairs:
        ident = read_identity(called_seq, truth_seq)
        idents.append(ident)
        len_ratios.append(len(called_seq) / max(len(truth_seq), 1))
        log.info("%s: identity %.4f (called %d / true %d bases)",
                 rid, ident, len(called_seq), len(truth_seq))
    summary = {
        "n_reads": len(pairs),
        "mean_identity": float(np.mean(idents)) if idents else 0.0,
        "median_identity": float(np.median(idents)) if idents else 0.0,
        "min_identity": float(np.min(idents)) if idents else 0.0,
        "mean_length_ratio": float(np.mean(len_ratios)) if len_ratios else 0.0,
    }
    if len(idents) >= 10:
        # Bootstrap 95% CI on the mean, so every comparison of modes
        # carries its own resolution.
        boot_rng = np.random.default_rng(0)
        arr = np.asarray(idents)
        means = np.mean(arr[boot_rng.integers(0, len(arr), size=(2000, len(arr)))],
                        axis=1)
        summary["mean_ci95"] = [float(np.percentile(means, 2.5)),
                                float(np.percentile(means, 97.5))]
    if args.json:
        print(json.dumps(summary))
    else:
        log.info("summary: %s", summary)
    return 0


if __name__ == "__main__":
    sys.exit(main())
