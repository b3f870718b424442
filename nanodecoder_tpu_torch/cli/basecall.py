"""Basecall CLI: a directory of fast5/pod5 files -> FASTQ (the port's
counterpart of `nanodecoder_tpu.cli.basecall`).

    python -m nanodecoder_tpu_torch.cli.basecall \
        --input reads_dir/ --output out.fastq --ckpt params.npz [--beam 5]

The checkpoint is a params `.npz` export with its `config.json` beside it,
or a checkpoint directory of the port's trainer (its latest step).
It runs on the CUDA card unless given --cpu (and raises without a card);
--pallas / --no-pallas set model.use_pallas and decode.use_pallas (the
kernel route or the plain PyTorch one), by default the kernel route on
the card and the plain one with --cpu.  Greedy, --beam (with a
--coverage-penalty) and --sample decoding; --beam with --sample exits 2.

More than one rank (one process per card, as torchrun starts them):

    torchrun --nproc_per_node 4 -m nanodecoder_tpu_torch.cli.basecall \
        --input reads_dir/ --output out.fastq --ckpt params.npz

Each rank basecalls its strided share of the sorted files on card
LOCAL_RANK into out.fastq.shard0000R (with its own done log, so --resume
works per shard), then after a barrier rank 0 merges the shards into
out.fastq and deletes them: share-nothing, no collective per batch.
The rendezvous is torchrun's (MASTER_ADDR, MASTER_PORT), or --dist-init.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="Nanopore basecaller on a CUDA card")
    ap.add_argument("--input", required=True, help="fast5/pod5 file or directory")
    ap.add_argument("--output", required=True, help="output FASTQ/FASTA path")
    ap.add_argument("--ckpt", required=True, help=".npz params (config.json beside it) or a "
                    "checkpoint directory of cli.train, the port's or the JAX "
                    "package's (orbax; read without JAX)")
    ap.add_argument("--format", choices=["fastq", "fasta"], default="fastq")
    ap.add_argument("--beam", type=int, default=0, help="beam size (0 = greedy)")
    ap.add_argument("--length-penalty", choices=["none", "wu", "avg"], default="avg",
                    help="beam score normalization (avg default: raw-sum "
                         "scoring prefers degenerate early-EOS hypotheses "
                         "under label smoothing)")
    ap.add_argument("--alpha", type=float, default=0.6)
    ap.add_argument("--coverage-penalty", choices=["none", "wu", "summary"],
                    default="none", help="beam coverage penalty (the reference's "
                    "PenaltyBuilder)")
    ap.add_argument("--beta", type=float, default=0.0, help="coverage weight")
    ap.add_argument("--min-len", type=int, default=0,
                    help="mask EOS before this many tokens")
    ap.add_argument("--sample", action="store_true",
                    help="random-sampling decode (the reference's "
                         "-random_sampling_topk/-random_sampling_temp)")
    ap.add_argument("--temperature", type=float, default=1.0,
                    help="sampling softmax temperature")
    ap.add_argument("--sampling-topk", type=int, default=0,
                    help="restrict sampling to the top-k tokens (0 = full vocab)")
    ap.add_argument("--sampling-topp", type=float, default=0.0,
                    help="nucleus sampling mass (0 = off)")
    ap.add_argument("--sampling-seed", type=int, default=0,
                    help="PRNG seed for --sample")
    ap.add_argument("--batch-chunks", type=int, default=0, help="override batch size")
    ap.add_argument("--stitch", choices=["trim", "align", "attn"], default="trim",
                    help="chunk merge rule: proportional trim, overlap "
                         "alignment, or attention-position")
    ap.add_argument("--workers", type=int, default=8,
                    help="ingest and finishing worker processes")
    ap.add_argument("--h2d", default="",
                    choices=["", "float32", "float16", "int8", "int6", "int4"],
                    help="signal H2D wire dtype (default: the config's, auto = "
                         "f16 in bf16 mode, f32 in f32 mode)")
    ap.add_argument("--depth", type=int, default=4,
                    help="device batches in flight (dispatch-ahead depth)")
    ap.add_argument("--resume", action="store_true",
                    help="append to an existing <output>: reads already "
                         "present (scanned from the output itself, plus "
                         "<output>.done) are skipped; a partial trailing "
                         "record from a crash is truncated first, so no "
                         "duplicates are possible")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    ap.add_argument("--parity", action="store_true",
                    help="f32 compute instead of bf16")
    ap.add_argument("--stage-times", action="store_true",
                    help="log per-stage wall time (ingest-wait, dispatch, "
                         "backpressure-wait, d2h-wait, stitch+write)")
    ap.add_argument("--pallas", action=argparse.BooleanOptionalAction, default=None,
                    help="the kernel route (model.use_pallas and decode.use_pallas; "
                         "default: on with the CUDA card, off with --cpu)")
    ap.add_argument("--dist-init", default="",
                    help="rendezvous of a multi-rank run (tcp://host:port or "
                         "file:///shared/path; default: torchrun's MASTER_ADDR and "
                         "MASTER_PORT); rank and world size from RANK and WORLD_SIZE")
    return ap


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    from nanodecoder_tpu_torch.utils.logging import get_logger

    log = get_logger("basecall")
    if args.beam > 0 and args.sample:
        log.error("--beam and --sample are mutually exclusive")
        return 2

    from nanodecoder_tpu_torch.parallel.multihost import (initialize_multihost,
                                                          local_device, shutdown_multihost)

    device = local_device(args.cpu)  # raises without a card unless --cpu
    rank, world = initialize_multihost(args.dist_init or None,
                                       backend="gloo" if args.cpu else None, device=device)
    try:
        return _basecall(args, log, device, rank, world)
    finally:
        shutdown_multihost()


def _basecall(args, log, device, rank: int, world: int) -> int:
    from nanodecoder_tpu_torch.cli.common import load_params_and_config
    from nanodecoder_tpu_torch.decode.engine import StreamingBasecaller
    from nanodecoder_tpu_torch.io.fast5 import list_signal_files
    from nanodecoder_tpu_torch.io.fastx import recover_fastx_output
    from nanodecoder_tpu_torch.parallel.multihost import (barrier, host_shard_path,
                                                          merge_host_shards,
                                                          partition_files_for_host)
    from nanodecoder_tpu_torch.utils.profiling import StageTimer
    from nanodecoder_tpu_torch.utils.report import ReportManager

    params, config = load_params_and_config(args.ckpt, device)
    overrides = {}
    if args.beam > 0:
        overrides.update(mode="beam", beam_size=args.beam,
                         length_penalty=args.length_penalty, alpha=args.alpha,
                         coverage_penalty=args.coverage_penalty, beta=args.beta)
    if args.sample:
        overrides.update(mode="sample", temperature=args.temperature,
                         sampling_topk=args.sampling_topk,
                         sampling_topp=args.sampling_topp,
                         sampling_seed=args.sampling_seed)
    if args.min_len > 0:
        overrides.update(min_len=args.min_len)
    if args.h2d:
        overrides.update(h2d_dtype=args.h2d)
    if args.batch_chunks > 0:
        overrides.update(batch_chunks=args.batch_chunks,
                         batch_chunks_beam=args.batch_chunks,
                         batch_chunks_engine=args.batch_chunks)
    use_pallas = device.type == "cuda" if args.pallas is None else args.pallas
    config = dataclasses.replace(
        config,
        model=dataclasses.replace(config.model, use_pallas=use_pallas,
                                  compute_dtype="float32" if args.parity else "bfloat16"),
        decode=dataclasses.replace(config.decode, use_pallas=use_pallas, **overrides))

    files = list_signal_files(args.input)
    if not files:
        log.error("no fast5/pod5 files under %s", args.input)
        return 2
    files = partition_files_for_host(files, rank, world)
    out_path = args.output if world == 1 else host_shard_path(args.output, rank)
    skip: set[str] = set()
    done_path = out_path + ".done"
    out_mode = "w"
    if args.resume:
        # The output itself is the ground truth: the engine flushes the
        # done log once per batch, so after a crash up to one batch of
        # reads can be in the output but not in the done log.
        # recover_fastx_output scans the complete records (and truncates
        # a partial trailing one); the run appends from there.
        if os.path.exists(done_path):
            with open(done_path) as f:
                skip = set(f.read().split())
        emitted = recover_fastx_output(out_path, args.format)
        skip |= emitted
        out_mode = "a"
        log.info("resume: skipping %d completed reads (%d from output scan)",
                 len(skip), len(emitted))

    caller = StreamingBasecaller(params, config, depth=args.depth,
                                 attn_pos=args.stitch == "attn", device=device)
    timer = StageTimer() if args.stage_times else None
    with open(out_path, out_mode) as out, open(done_path, "a") as done_log:
        meter = caller.run(
            files, out, stitch_method=args.stitch, skip_read_ids=skip,
            num_workers=args.workers, write_format=args.format,
            done_log=done_log, stage_timer=timer,
        )
    barrier("basecall-done")
    if world > 1:
        merge_host_shards(args.output, world, rank)
    if timer is not None:
        for name, st in timer.summary().items():
            log.info("stage %-17s total %7.3fs  mean %6.2fms  x%d",
                     name, st["total_sec"], st["mean_sec"] * 1e3, st["count"])
    ReportManager().report_inference(meter.rates(), {"n_hosts": world, "rank": rank,
                                                     "device": str(device)})
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    finally:
        from nanodecoder_tpu_torch.io.pipeline import stop_ingest_processes

        stop_ingest_processes()
